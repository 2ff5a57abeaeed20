"""CTR models (counterpart of ``paddle_tpu/models/ctr.py``): Wide&Deep and
DeepFM in dygraph, ``BASELINE.md`` config 5's models.  The sparse slots
are one ``Embedding`` over ``num_slots · vocab_per_slot`` rows (the ids
offset by slot), whose gradient is dense, as the reference's dygraph
``Embedding`` gives it; the towers are ``Linear`` + ``ReLU``."""
from __future__ import annotations

from ..dygraph.layers import Layer, Sequential
from ..dygraph.nn import Embedding, Linear
from ..nn.layer import ReLU
from ..fluid import layers as L


def _tower(in_dim, hidden):
    dims = [in_dim] + list(hidden)
    seq = []
    for i in range(len(hidden)):
        seq += [Linear(dims[i], dims[i + 1]), ReLU()]
    seq.append(Linear(dims[-1], 1))
    return Sequential(*seq)


class WideDeep(Layer):
    def __init__(self, num_slots=26, vocab_per_slot=10000, embed_dim=16,
                 dense_dim=13, hidden=(400, 400, 400)):
        super().__init__()
        self.embed = Embedding([num_slots * vocab_per_slot, embed_dim])
        self.wide = Linear(dense_dim, 1)
        self.deep = _tower(num_slots * embed_dim + dense_dim, hidden)
        self.num_slots = num_slots
        self.embed_dim = embed_dim

    def forward(self, sparse_ids, dense_feats):
        """sparse_ids [B, num_slots] int64 (offset by slot), dense_feats
        [B, dense_dim]; the click probability [B, 1]."""
        emb = self.embed(sparse_ids)               # [B, S, D]
        emb = L.reshape(emb, [emb.shape[0], self.num_slots * self.embed_dim])
        deep_in = L.concat([emb, dense_feats], axis=1)
        return L.nn.sigmoid(self.wide(dense_feats) + self.deep(deep_in))


class DeepFM(Layer):
    def __init__(self, num_slots=26, vocab_per_slot=10000, embed_dim=16,
                 dense_dim=13, hidden=(400, 400)):
        super().__init__()
        self.embed = Embedding([num_slots * vocab_per_slot, embed_dim])
        self.embed_w = Embedding([num_slots * vocab_per_slot, 1])
        self.deep = _tower(num_slots * embed_dim + dense_dim, hidden)
        self.dense_w = Linear(dense_dim, 1)
        self.num_slots = num_slots
        self.embed_dim = embed_dim

    def forward(self, sparse_ids, dense_feats):
        emb = self.embed(sparse_ids)                      # [B, S, D]
        # FM's second order: 0.5 · ((sum e)^2 - sum e^2)
        sum_e = L.nn.reduce_sum(emb, dim=1)               # [B, D]
        sum_sq = L.nn.reduce_sum(emb * emb, dim=1)
        fm2 = L.nn.reduce_sum(sum_e * sum_e - sum_sq, dim=1, keep_dim=True)
        fm2 = L.scale(fm2, scale=0.5)
        fm1 = L.nn.reduce_sum(L.squeeze(self.embed_w(sparse_ids), [2]),
                              dim=1, keep_dim=True)
        flat = L.reshape(emb, [emb.shape[0], self.num_slots * self.embed_dim])
        deep = self.deep(L.concat([flat, dense_feats], axis=1))
        return L.nn.sigmoid(fm1 + fm2 + deep + self.dense_w(dense_feats))
