"""Static-graph demo programs (counterpart of
``paddle_tpu/models/static_graphs.py``: the BERT and wide&deep CTR
programs).

The BERT builder spells attention exactly the way plain fluid layers
emit it (matmul → scale → +mask → softmax → dropout → matmul), the chain
the ``fuse_attention`` pass rewrites onto the flash-attention kernel.
The CTR builder spells each sparse slot as ``lookup_table_v2 →
sequence_pool(sum)``, the chain ``fuse_sparse_embedding`` rewrites onto
the embedding gather-pool and scatter-add kernels.  Each builder creates
the same parameters, in the same order and so under the same names, as
the reference builder.
"""
from __future__ import annotations

from .. import fluid
from ..fluid import layers as L


def _naive_attention(x, hidden, heads, mask=None, dropout=0.0):
    """One multi-head self-attention block in the head-split spelling
    BERT emits: fc → reshape2 → transpose2 per Q/K/V, then the naive
    score chain the fuse_attention pass matches."""
    dh = hidden // heads

    def split(t):
        t = L.reshape(t, [0, 0, heads, dh])
        return L.transpose(t, [0, 2, 1, 3])       # [B, H, T, dh]

    q = split(L.fc(x, hidden, num_flatten_dims=2))
    k = split(L.fc(x, hidden, num_flatten_dims=2))
    v = split(L.fc(x, hidden, num_flatten_dims=2))
    s = L.matmul(q, k, transpose_y=True)
    s = L.scale(s, scale=dh ** -0.5)
    if mask is not None:
        s = s + mask                              # additive [B,1,1,T] bias
    p = L.softmax(s)
    if dropout:
        p = L.dropout(p, dropout,
                      dropout_implementation="upscale_in_train")
    ctx = L.matmul(p, v)
    ctx = L.transpose(ctx, [0, 2, 1, 3])
    return L.reshape(ctx, [0, 0, hidden])


def build_bert_train_program(vocab=64, hidden=32, heads=4, seq=16,
                             layers=2, dropout=0.0, with_mask=True,
                             lr=1e-3, train=True):
    """BERT-shaped classifier over ``layers`` naive attention blocks.
    Feeds: ids [B, seq] int64, labels [B, 1] int64 (with ``train``) and,
    with ``with_mask``, attn_mask [B, seq] float 1/0.

    ``train=True`` (the default) builds what the reference builder, which
    always trains, builds: the mean softmax cross-entropy of the logits
    against the labels, its backward and ``AdamOptimizer(lr).minimize``;
    returns (main, startup, loss).  ``train=False`` stops at the logits,
    the program a server freezes; returns (main, startup, logits)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ids = fluid.data("ids", [-1, seq], dtype="int64")
        if train:
            labels = fluid.data("labels", [-1, 1], dtype="int64")
        mask = None
        if with_mask:
            am = fluid.data("attn_mask", [-1, seq])
            am = L.reshape(am, [0, 1, 1, seq])
            # the reference builder's spelling: the bias comes before the
            # scale, so this is (m - 10000) * 10000, about -1e8 at every
            # key and 1e4 lower where padded
            mask = L.scale(am, scale=10000.0, bias=-10000.0,
                           bias_after_scale=False)
        h = L.embedding(ids, size=[vocab, hidden])
        for _ in range(layers):
            h = _naive_attention(h, hidden, heads, mask=mask,
                                 dropout=dropout)
            h = L.fc(h, hidden, num_flatten_dims=2, act="relu")
        pooled = L.reduce_mean(h, dim=[1])
        logits = L.fc(pooled, 2)
        if not train:
            return main, startup, logits
        loss = L.mean(L.softmax_with_cross_entropy(logits, labels))
        fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    return main, startup, loss


def build_ctr_train_program(slots=4, vocab=128, dim=16, seq=5, lr=0.05,
                            optimizer="adam", train=True):
    """Wide&deep CTR net in the classic PaddleBox spelling: one
    lookup_table_v2 → sequence_pool(sum) chain per slot, concat with the
    dense features, an fc tower and a wide fc head.  Feeds: ids_<i>
    [B, seq] int64 per slot, dense [B, 13] and (with ``train``) label
    [B, 1] float 0/1.

    ``train=True`` (the default) builds what the reference builder, which
    always trains, builds: the mean sigmoid cross-entropy of the logit
    against the label, its backward and ``MomentumOptimizer(lr, 0.9)``
    (``optimizer="momentum"``) or ``AdamOptimizer(lr)``; returns (main,
    startup, loss).  ``train=False``
    stops at the logit, ``fc(h, 1) + wide``; returns (main, startup,
    logit)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        dense = fluid.data("dense", [-1, 13])
        if train:
            label = fluid.data("label", [-1, 1])
        pooled = []
        for i in range(slots):
            ids = fluid.data(f"ids_{i}", [-1, seq], dtype="int64")
            emb = L.embedding(ids, size=[vocab, dim])
            pooled.append(L.sequence_pool(emb, "sum"))
        deep = L.concat(pooled + [dense], axis=1)
        h = L.fc(deep, 32, act="relu")
        wide = L.fc(dense, 1)
        logit = L.fc(h, 1) + wide
        if not train:
            return main, startup, logit
        loss = L.mean(L.sigmoid_cross_entropy_with_logits(logit, label))
        if optimizer == "momentum":
            fluid.optimizer.MomentumOptimizer(lr, 0.9).minimize(loss)
        else:
            fluid.optimizer.AdamOptimizer(lr).minimize(loss)
    return main, startup, loss


def bert_demo_feed(rng, batch=8, seq=16, vocab=64, with_mask=True):
    """Random ids, labels for the training program's loss, and a padding
    mask whose first column is always 1, from a
    ``numpy.random.RandomState``."""
    feed = {"ids": rng.randint(0, vocab, (batch, seq)).astype("int64"),
            "labels": rng.randint(0, 2, (batch, 1)).astype("int64")}
    if with_mask:
        m = (rng.rand(batch, seq) > 0.2).astype("float32")
        m[:, 0] = 1.0                  # never mask everything out
        feed["attn_mask"] = m
    return feed


def ctr_demo_feed(rng, batch=16, slots=4, vocab=128, seq=5):
    """Dense features, 0/1 labels and uniform ids per slot, from a
    ``numpy.random.RandomState``, drawn in the reference's order."""
    feed = {"dense": rng.randn(batch, 13).astype("float32"),
            "label": rng.randint(0, 2, (batch, 1)).astype("float32")}
    for i in range(slots):
        feed[f"ids_{i}"] = rng.randint(
            0, vocab, (batch, seq)).astype("int64")
    return feed
