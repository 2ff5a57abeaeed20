"""BERT / ERNIE model family (counterpart of ``paddle_tpu/models/bert.py``):
dygraph Layers over the shared transformer stack; attention runs through
the fused attention op (the Hopper flash-attention kernels on the card),
the encoder's dropouts through the fused dropout kernels."""
from __future__ import annotations

import numpy as np

from ..dygraph.layers import Layer
from ..dygraph.nn import Linear, Embedding, LayerNorm, Dropout
from ..nn.layer import TransformerEncoder, TransformerEncoderLayer, Tanh
from ..fluid import layers as L


class BertEmbeddings(Layer):
    def __init__(self, vocab_size, hidden_size, max_position=512,
                 type_vocab_size=2, dropout=0.1):
        super().__init__()
        self.word_embeddings = Embedding([vocab_size, hidden_size])
        self.position_embeddings = Embedding([max_position, hidden_size])
        self.token_type_embeddings = Embedding([type_vocab_size, hidden_size])
        self.layer_norm = LayerNorm(hidden_size)
        self.dropout = Dropout(dropout)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        from ..dygraph.base import to_variable
        b, t = input_ids.shape[:2]
        if position_ids is None:
            position_ids = to_variable(np.ascontiguousarray(
                np.broadcast_to(np.arange(t, dtype="int64"), (b, t))))
        if token_type_ids is None:
            token_type_ids = to_variable(np.zeros((b, t), "int64"))
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, hidden_size):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size)
        self.activation = Tanh()

    def forward(self, hidden):
        first = L.slice(hidden, axes=[1], starts=[0], ends=[1])
        first = L.squeeze(first, [1])
        return self.activation(self.dense(first))


class BertModel(Layer):
    """BERT-base defaults: L=12, H=768, A=12."""

    def __init__(self, vocab_size=30522, hidden_size=768, num_layers=12,
                 num_heads=12, intermediate_size=3072, max_position=512,
                 type_vocab_size=2, dropout=0.1, attn_dropout=0.1):
        super().__init__()
        self.embeddings = BertEmbeddings(vocab_size, hidden_size,
                                         max_position, type_vocab_size,
                                         dropout)
        enc_layer = TransformerEncoderLayer(
            hidden_size, num_heads, intermediate_size, dropout,
            activation="gelu", attn_dropout=attn_dropout)
        self.encoder = TransformerEncoder(enc_layer, num_layers)
        self.pooler = BertPooler(hidden_size)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.intermediate_size = intermediate_size
        self.vocab_size = vocab_size

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        # attention_mask: [B, T] 1/0 -> additive [B, 1, 1, T]
        mask = None
        if attention_mask is not None:
            m = L.cast(attention_mask, "float32")
            m = L.reshape(m, [m.shape[0], 1, 1, m.shape[1]])
            mask = L.scale(m, scale=10000.0, bias=-10000.0,
                           bias_after_scale=False)  # (m - 1) * 10000
        seq = self.encoder(emb, mask)
        pooled = self.pooler(seq)
        return seq, pooled


class BertLMHead(Layer):
    def __init__(self, hidden_size, vocab_size, embedding_weights=None):
        super().__init__()
        self.transform = Linear(hidden_size, hidden_size)
        self.layer_norm = LayerNorm(hidden_size)
        self.decoder = Linear(hidden_size, vocab_size)

    def forward(self, hidden):
        h = L.nn.gelu(self.transform(hidden))
        return self.decoder(self.layer_norm(h))


class BertForPretraining(Layer):
    """MLM + NSP heads (BERT pretraining objective)."""

    def __init__(self, bert: BertModel = None, **kw):
        super().__init__()
        self.bert = bert or BertModel(**kw)
        self.cls_mlm = BertLMHead(self.bert.hidden_size, self.bert.vocab_size)
        self.cls_nsp = Linear(self.bert.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        seq, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.cls_mlm(seq), self.cls_nsp(pooled)

    def loss(self, mlm_logits, nsp_logits, mlm_labels, nsp_labels,
             ignore_index=-100):
        mlm_loss = L.softmax_with_cross_entropy(
            mlm_logits, mlm_labels, ignore_index=ignore_index)
        nsp_loss = L.softmax_with_cross_entropy(nsp_logits, nsp_labels)
        return L.nn.mean(mlm_loss) + L.nn.mean(nsp_loss)


class BertForSequenceClassification(Layer):
    def __init__(self, bert: BertModel = None, num_classes=2, dropout=0.1,
                 **kw):
        super().__init__()
        self.bert = bert or BertModel(**kw)
        self.dropout = Dropout(dropout)
        self.classifier = Linear(self.bert.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


class ErnieModel(BertModel):
    """ERNIE-1.0 shares the BERT-base architecture with a different
    pretraining corpus/masking scheme; vocab 18000 (BASELINE config #4)."""

    def __init__(self, vocab_size=18000, **kw):
        super().__init__(vocab_size=vocab_size, **kw)


def bert_base(**kw):
    return BertModel(hidden_size=768, num_layers=12, num_heads=12,
                     intermediate_size=3072, **kw)


def bert_large(**kw):
    return BertModel(hidden_size=1024, num_layers=24, num_heads=16,
                     intermediate_size=4096, **kw)
