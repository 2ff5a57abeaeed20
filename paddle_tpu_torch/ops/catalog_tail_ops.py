"""Catalog-tail lowerings (counterpart of
``paddle_tpu/ops/catalog_tail_ops.py``: the op paddle.tensor reaches,
``recurrent``, StaticRNN's step loop, and the sequence tail's
``sequence_reshape`` and ``sequence_topk_avg_pooling``)."""
from __future__ import annotations

import torch

from .registry import register_op


@register_op("equal_all", differentiable=False)
def _equal_all(ins, attrs, ctx):
    """One bool: same shape and every element equal."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.shape != y.shape:
        return {"Out": [torch.tensor(False, device=x.device)]}
    return {"Out": [torch.all(torch.eq(x, y))]}


@register_op("recurrent", differentiable=False)
def _recurrent(ins, attrs, ctx):
    """StaticRNN's step loop (recurrent_op.cc): run the step sub-block
    once per time step, feeding each sequence input's step ``[:, t]``
    and threading the memories; the step outputs are stacked on axis 1.
    The executor binds the program as ``__program__``."""
    from ..fluid.executor import run_block_ops
    sub = attrs["__program__"].blocks[attrs["sub_block"]]
    seq_ins = dict(zip(attrs.get("inputs", []), ins.get("Inputs", [])))
    states = dict(zip(attrs.get("ex_states", []),
                      ins.get("InitStates", [])))
    params = dict(zip(attrs.get("parameters", []),
                      ins.get("Parameters", [])))
    state_names = attrs.get("states", [])
    out_names = attrs.get("outputs", [])
    steps = next(iter(seq_ins.values())).shape[1] if seq_ins \
        else attrs["len"]
    collected = {n: [] for n in out_names}
    for t in range(steps):
        env = dict(params)
        for n, v in seq_ins.items():
            env[n] = v[:, t]
        env.update(states)
        run_block_ops(sub, env, ctx)
        states = {ex: env[cur] for ex, cur in zip(states, state_names)}
        for n in out_names:
            collected[n].append(env[n])
    return {"Out": [torch.stack(collected[n], dim=1) for n in out_names]}


@register_op("sequence_reshape")
def _sequence_reshape(ins, attrs, ctx):
    """Rows regrouped to width ``new_dim`` ([B, T, D] keeps its batch)."""
    x, new_dim = ins["X"][0], attrs["new_dim"]
    return {"Out": [x.reshape(x.shape[0], -1, new_dim) if x.ndim == 3
                    else x.reshape(-1, new_dim)]}


@register_op("sequence_topk_avg_pooling", nondiff_inputs=("ROW", "COLUMN"))
def _sequence_topk_avg_pooling(ins, attrs, ctx):
    """For each k of ``topks``, the mean of the k largest along the last
    axis of X [B, C, L]; the means concatenated on the last axis."""
    x = ins["X"][0]
    outs = [torch.topk(x, min(k, x.shape[-1]), dim=-1).values.mean(-1)
            for k in attrs.get("topks", [1])]
    return {"Out": [torch.cat(outs, dim=-1)]}
