"""Transformer NMT model (counterpart of ``paddle_tpu/models/transformer.py``:
the encoder-decoder of ``BASELINE.md`` config 4, ``bench.py``'s
``main_nmt``).  Attention runs through the fused attention op (the Hopper
flash-attention kernels on the card), the dropouts through the fused
dropout kernels; the decoder's causal mask is an additive ``[1, 1, T, T]``
bias, built per forward as the reference builds it."""
from __future__ import annotations

import math

import numpy as np

from ..dygraph.base import VarBase, to_variable
from ..dygraph.layers import Layer
from ..dygraph.nn import Embedding, Linear
from ..nn.layer import Transformer
from ..fluid import layers as L


class PositionalEmbedding(Layer):
    """Adds the sinusoid table's first T rows (a constant buffer)."""

    def __init__(self, d_model, max_len=1024):
        super().__init__()
        pos = np.arange(max_len)[:, None]
        i = np.arange(d_model)[None, :]
        angle = pos / np.power(10000, (2 * (i // 2)) / d_model)
        pe = np.zeros((max_len, d_model), "float32")
        pe[:, 0::2] = np.sin(angle[:, 0::2])
        pe[:, 1::2] = np.cos(angle[:, 1::2])
        self.register_buffer("pe", pe)

    def forward(self, x):
        t = x.shape[1]
        return x + VarBase(self.pe._value[None, :t], stop_gradient=True)


class TransformerModel(Layer):
    """Encoder-decoder NMT (Transformer-base/big)."""

    def __init__(self, src_vocab=30000, tgt_vocab=30000, d_model=512,
                 nhead=8, num_encoder_layers=6, num_decoder_layers=6,
                 dim_feedforward=2048, dropout=0.1, max_len=1024):
        super().__init__()
        self.src_emb = Embedding([src_vocab, d_model])
        self.tgt_emb = Embedding([tgt_vocab, d_model])
        self.pos = PositionalEmbedding(d_model, max_len)
        self.transformer = Transformer(d_model, nhead, num_encoder_layers,
                                       num_decoder_layers, dim_feedforward,
                                       dropout)
        self.out_proj = Linear(d_model, tgt_vocab)
        self.d_model = d_model

    def forward(self, src_ids, tgt_ids):
        scale = math.sqrt(self.d_model)
        src = self.pos(L.scale(self.src_emb(src_ids), scale=scale))
        tgt = self.pos(L.scale(self.tgt_emb(tgt_ids), scale=scale))
        # the decoder self-attention's causal mask
        t = tgt_ids.shape[1]
        causal = np.triu(np.full((t, t), -1e9, "float32"), 1)[None, None]
        out = self.transformer(src, tgt, tgt_mask=to_variable(causal))
        return self.out_proj(out)
