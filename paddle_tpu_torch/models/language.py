"""Language models (counterpart of ``paddle_tpu/models/language.py``):
word2vec skip-gram with sampled negatives, and the PTB LSTM language
model of Zaremba, Sutskever and Vinyals (arXiv:1409.2329; Paddle's
``ptb_lm``).  The LM's recurrence is the ``nn.LSTM`` layer, one
``rnn_scan`` op a layer; what the reference computes with jax here
(``most_similar``, ``perplexity``) is torch."""
from __future__ import annotations

import numpy as np
import torch

from ..dygraph.layers import Layer
from ..dygraph.nn import Embedding, Linear, Dropout
from ..nn.layer import LSTM
from ..fluid import layers as L


class SkipGram(Layer):
    """word2vec skip-gram, scored against caller-drawn negatives."""

    def __init__(self, vocab_size, embed_dim=64, neg_num=5):
        super().__init__()
        self.emb_in = Embedding([vocab_size, embed_dim])
        self.emb_out = Embedding([vocab_size, embed_dim])
        self.vocab_size = vocab_size
        self.neg_num = neg_num

    def sample_negatives(self, batch, rng=None):
        """[batch, neg_num] uniform negative ids, drawn on the host from
        ``rng`` (a ``RandomState`` or a ``Generator``)."""
        rng = rng or np.random
        draw = getattr(rng, "integers", None) or rng.randint
        return np.asarray(draw(0, self.vocab_size,
                               (batch, self.neg_num))).astype("int64")

    def forward(self, center, context, negatives):
        """center, context: [B] int64; negatives [B, K] int64.  The mean
        of the positive pair's and the negatives' sigmoid losses."""
        c = self.emb_in(center)                    # [B, D]
        pos = self.emb_out(context)                # [B, D]
        neg = self.emb_out(negatives)              # [B, K, D]
        pos_logit = L.reduce_sum(c * pos, dim=-1)
        neg_logit = L.reduce_sum(L.unsqueeze(c, [1]) * neg, dim=-1)
        pos_loss = L.loss.sigmoid_cross_entropy_with_logits(
            pos_logit, L.ones_like(pos_logit))
        neg_loss = L.reduce_sum(
            L.loss.sigmoid_cross_entropy_with_logits(
                neg_logit, L.zeros_like(neg_logit)), dim=-1)
        return L.mean(pos_loss + neg_loss)

    def most_similar(self, word_id, k=5):
        """The ``k`` ids whose input embeddings have the largest cosine
        with ``word_id``'s, the word itself left out by id."""
        w = self.emb_in.weight._value
        v = w[word_id]
        sims = (w @ v) / (torch.linalg.norm(w, dim=1)
                          * torch.linalg.norm(v) + 1e-9)
        sims[word_id] = -float("inf")
        return torch.argsort(-sims, stable=True)[:k].cpu().numpy()


class PtbLm(Layer):
    """Embedding, stacked one-layer LSTMs with dropout between them (and
    on the embedding and before the output), a linear layer to the
    vocabulary."""

    def __init__(self, vocab_size=10000, hidden_size=200, num_layers=2,
                 dropout=0.0):
        super().__init__()
        self.embedding = Embedding([vocab_size, hidden_size])
        self.lstms = [LSTM(hidden_size, hidden_size, num_layers=1)
                      for _ in range(num_layers)]
        for i, lstm in enumerate(self.lstms):
            setattr(self, f"lstm_{i}", lstm)
        self.dropout = Dropout(dropout)
        self.fc = Linear(hidden_size, vocab_size)
        self.vocab_size = vocab_size

    def forward(self, ids):
        out = self.dropout(self.embedding(ids))    # [B, T, H]
        for i, lstm in enumerate(self.lstms):
            out = lstm(out)[0]
            if i < len(self.lstms) - 1:
                out = self.dropout(out)
        return self.fc(self.dropout(out))          # [B, T, V]

    def loss(self, logits, labels):
        """The mean per-token cross entropy; labels [B, T] int64."""
        flat = L.reshape(logits, [-1, self.vocab_size])
        lbl = L.reshape(labels, [-1, 1])
        return L.mean(L.softmax_with_cross_entropy(flat, lbl))

    def perplexity(self, logits, labels):
        return float(torch.exp(self.loss(logits, labels).value()))
