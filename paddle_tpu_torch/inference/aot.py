"""Ahead-of-time inference artifacts (counterpart of
``paddle_tpu/inference/aot.py``).

Reference analog: the ``__model__`` ProgramDesc + params files that
``save_inference_model`` (io.py:1198) writes for AnalysisPredictor.  The
TPU package ships serialized StableHLO (``jax.export``); this package
ships ``torch.export`` programs, written with ``torch.export.save``: the
loaded Program's op stream traced once per served shape.  A consumer
needs torch and the registration of the port's two dispatcher ops
(``paddle_tpu_torch::flash_attention_fwd``, ops/attention.py, and
``paddle_tpu_torch::embedding_pool_fwd``, ops/ctr_ops.py), which
:class:`AotPredictor` imports; it needs no Program, no op registry and no
model code.  The exported graphs hold those ops, so a call launches the
hand-written flash and gather-pool kernels on the card.

Layout of an artifact directory:

* ``aot_meta.json`` — the TPU package's keys (``feed_names``,
  ``fetch_names``, ``input_shapes``, ``input_dtypes``, ``platforms``,
  and for a bucketed export ``buckets``, ``bucket_files``,
  ``batch_valid_arg``) plus ``param_names``, ``weights_file`` and
  ``id_bounds`` (the rows of the table each id feed indexes, which
  ``ServingEngine`` checks a request's ids against);
* ``weights.pt`` — the weights, once, by name (``torch.save``);
* ``model.pt2`` — the example feed's shape;
* ``model.b{edge}.pt2`` — one program per bucket edge, taking a trailing
  0-d int32 ``batch_valid`` (the true row count, so batch reductions
  leave the padded rows out).

Each exported program takes the weights as inputs, in ``param_names``
order, then the feeds (then ``batch_valid``): the TPU package bakes the
weights into every module, which here would write BERT-base's 440 MB (or
the CTR tables' 1.66 GB) once per edge.  :class:`AotPredictor` picks the
smallest bucket >= the request's rows, zero-pads the batch feeds, passes
the true row count and slices the outputs back — the executor's shape
bucketing, replayed at serving time.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["save_aot_model", "load_aot_model", "AotPredictor"]

_ARTIFACT = "model.pt2"
_BUCKET_ARTIFACT = "model.b{edge}.pt2"
_WEIGHTS = "weights.pt"
_META = "aot_meta.json"


def _export_fn(predictor, feed_names, fetch_names):
    """(weight names, weight tensors, fn): ``fn(weights, feeds,
    batch_valid=None, batch_padded=None)`` runs the predictor's pruned
    block on the feeds, each float feed first cast to its var's declared
    float dtype as ``Executor.run`` casts it."""
    from ..fluid.core import global_scope
    from ..fluid.executor import run_block_ops
    from ..fluid.framework import _op_reads, prune_ops, torch_dtype
    from ..ops.registry import LoweringContext

    program = predictor._program
    block = program.global_block()
    scope = global_scope()
    run_ops = prune_ops(block, block.ops, targets=fetch_names,
                        keep_state_writes=False, feeds=set(feed_names))
    names, produced = [], set(feed_names)
    for op in run_ops:
        for n in _op_reads(block, op):
            if n not in produced:
                produced.add(n)
                if scope.find_var(n) is not None:
                    names.append(n)
        produced.update(op.output_arg_names)
    values = [scope.find_var(n) for n in names]
    casts = {}
    for n in feed_names:
        var = block._find_var_recursive(n)
        want = torch_dtype(var.dtype) if var is not None and var.dtype \
            else None
        if want is not None and want.is_floating_point:
            casts[n] = want
    device = predictor._exe.device

    def fn(weights, feeds, batch_valid=None, batch_padded=None):
        env = dict(zip(names, weights))
        for n, f in zip(feed_names, feeds):
            env[n] = f.to(casts[n]) if n in casts and f.is_floating_point() \
                else f
        ctx = LoweringContext(device=device, is_test=True)
        if batch_valid is not None:
            ctx.batch_valid = batch_valid
            ctx.batch_padded = batch_padded
        run_block_ops(block, env, ctx, ops=run_ops)
        return [env[n] for n in fetch_names]
    return names, values, fn


class _Served(torch.nn.Module):
    """``torch.export`` wants a module: forward(*weights, *feeds[,
    batch_valid]) -> the fetches."""

    def __init__(self, fn, n_weights, n_feeds, edge=None):
        super().__init__()
        self._fn, self._nw, self._nf, self._edge = fn, n_weights, n_feeds, \
            edge

    def forward(self, *args):
        w, f = args[:self._nw], args[self._nw:self._nw + self._nf]
        bv = args[-1] if self._edge is not None else None
        return tuple(self._fn(list(w), list(f), bv, self._edge))


def _export(fn, values, feeds, edge=None):
    extra = ()
    if edge is not None:
        extra = (torch.zeros((), dtype=torch.int32, device=feeds[0].device
                             if feeds else values[0].device),)
    mod = _Served(fn, len(values), len(feeds), edge)
    # grad off around the export: the attention and the gather-pool then
    # take their dispatcher ops, which the exported graph holds
    with torch.no_grad():
        ep = torch.export.export(mod, tuple(values) + tuple(feeds) + extra,
                                 strict=False)
    # torch.export.save writes a program's example inputs beside it, and
    # here they hold the weights: once in weights.pt is enough
    ep.example_inputs = None
    return ep


def _example(v, rows=None, device=None) -> torch.Tensor:
    a = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    shape = list(a.shape)
    if rows is not None and shape:
        shape[0] = int(rows)
    return torch.zeros(shape, dtype=torch.from_numpy(a[:0].copy()).dtype,
                       device=device)


def save_aot_model(dirname: str, predictor,
                   example_feed: Dict[str, np.ndarray],
                   bucket_edges: Optional[Sequence[int]] = None):
    """Export ``predictor``'s loaded model with ``torch.export``.

    ``example_feed`` supplies shapes and dtypes for tracing (values
    unused); its shape goes into ``model.pt2``.  With ``bucket_edges``
    (explicit, or the predictor program's ``bucket_edges`` hint) one more
    program per edge is exported, so :class:`AotPredictor` serves any
    batch size up to the largest edge by pad-and-slice.  The export runs
    on the predictor's device.  Returns the metadata written."""
    from ..serving.engine import id_bounds
    missing = [n for n in predictor._feed_names if n not in example_feed]
    if missing:
        raise ValueError(f"example_feed missing inputs: {missing}")
    feed_names = list(predictor._feed_names)
    fetch_names = list(predictor._fetch_names)
    names, values, fn = _export_fn(predictor, feed_names, fetch_names)
    device = predictor._exe.device
    feeds = [_example(example_feed[n], device=device) for n in feed_names]

    os.makedirs(dirname, exist_ok=True)
    torch.export.save(_export(fn, values, feeds),
                      os.path.join(dirname, _ARTIFACT))
    torch.save({n: v.detach() for n, v in zip(names, values)},
               os.path.join(dirname, _WEIGHTS))
    meta = {
        "feed_names": feed_names,
        "fetch_names": fetch_names,
        "input_shapes": {n: list(f.shape) for n, f in zip(feed_names,
                                                           feeds)},
        "input_dtypes": {n: str(f.dtype).removeprefix("torch.")
                         for n, f in zip(feed_names, feeds)},
        "platforms": [device.type],
        "param_names": names,
        "weights_file": _WEIGHTS,
        "id_bounds": id_bounds(predictor._program, feed_names),
    }

    # -- multi-shape tier ---------------------------------------------------
    if bucket_edges is None:
        bucket_edges = predictor._program._hints.get("bucket_edges")
    if bucket_edges:
        from ..fluid import compile_cache
        edges = compile_cache.normalize_edges(bucket_edges)
        # batch-major feeds: the ones sharing the example's leading dim
        dims = {int(f.shape[0]) for f in feeds if f.ndim >= 1}
        if len(dims) != 1:
            raise ValueError(
                "bucketed export needs every feed to share one leading "
                f"batch dim; example_feed has {dims}")
        files = {}
        for edge in edges:
            efeeds = [_example(example_feed[n], rows=edge, device=device)
                      for n in feed_names]
            fname = _BUCKET_ARTIFACT.format(edge=int(edge))
            torch.export.save(_export(fn, values, efeeds, int(edge)),
                              os.path.join(dirname, fname))
            files[str(int(edge))] = fname
        meta["buckets"] = [int(e) for e in edges]
        meta["bucket_files"] = files
        meta["batch_valid_arg"] = True

    with open(os.path.join(dirname, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def _host(t) -> np.ndarray:
    """A fetch on the host; numpy has no bfloat16, so a bfloat16 fetch
    comes back float32, as ``Executor.run`` gives it."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


class AotPredictor:
    """Serve a saved artifact: ``__call__(feed dict) -> fetch dict``.  No
    Program, no op registry: the weights file and the exported programs,
    each loaded once, on ``place`` (default ``CUDAPlace(0)``, which
    raises where torch sees no card).  Multi-shape artifacts pick the
    smallest bucket >= the request rows, pad, pass the true row count
    and slice the outputs back."""

    def __init__(self, dirname: str, place=None):
        from ..fluid import core
        # the two dispatcher ops the exported graphs may hold
        from ..ops import attention, ctr_ops  # noqa: F401
        self._dir = dirname
        with open(os.path.join(dirname, _META)) as f:
            self._meta = json.load(f)
        place = place if place is not None else core.CUDAPlace(0)
        self.device = place.torch_device()
        weights = torch.load(
            os.path.join(dirname, self._meta["weights_file"]),
            map_location=self.device, weights_only=True)
        self._weights = [weights[n] for n in self._meta["param_names"]]
        self._dtypes = {n: getattr(torch, d) for n, d in
                        self._meta["input_dtypes"].items()}
        self._modules: Dict[Optional[int], object] = {}

    def _module(self, edge: Optional[int]):
        """Load lazily, once per bucket (None = the example-shape
        program), moved to this predictor's device if it was exported on
        another."""
        mod = self._modules.get(edge)
        if mod is None:
            fname = (_ARTIFACT if edge is None
                     else self._meta["bucket_files"][str(edge)])
            ep = torch.export.load(os.path.join(self._dir, fname))
            if self._meta.get("platforms") != [self.device.type]:
                from torch.export.passes import move_to_device_pass
                ep = move_to_device_pass(ep, str(self.device))
            mod = self._modules[edge] = ep.module()
        return mod

    def get_input_names(self) -> Sequence[str]:
        return list(self._meta["feed_names"])

    def get_output_names(self) -> Sequence[str]:
        return list(self._meta["fetch_names"])

    @property
    def buckets(self):
        return list(self._meta.get("buckets") or [])

    def _rows(self, feed) -> Optional[int]:
        dims = {int(np.shape(feed[n])[0])
                for n in self._meta["feed_names"]
                if np.ndim(feed.get(n)) >= 1}
        return next(iter(dims)) if len(dims) == 1 else None

    def _arg(self, name, v, edge=None, n=None) -> torch.Tensor:
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if edge is not None and t.ndim >= 1 and t.shape[0] == n \
                and edge != n:
            t = torch.cat([t, t.new_zeros((edge - n,) + tuple(t.shape[1:]))])
        return t.to(device=self.device, dtype=self._dtypes[name])

    def _call(self, edge, args):
        with torch.no_grad():
            return list(self._module(edge)(*self._weights, *args))

    def call_lazy(self, feed: Dict[str, np.ndarray]):
        """Dispatch and return the outputs on the device (true rows
        only) without a host copy — what ServingEngine's AOT backend
        overlaps with batch formation."""
        names = self._meta["feed_names"]
        missing = [n for n in names if n not in feed]
        if missing:
            raise ValueError(f"feed is missing inputs: {missing}")
        buckets = self._meta.get("buckets")
        n = self._rows(feed)
        shapes = self._meta.get("input_shapes") or {}
        s0 = shapes.get(names[0]) if names else None
        baked = int(s0[0]) if s0 else None
        # bucketed artifacts serve every coverable size through the bucket
        # programs (even rows == the example shape), so a warmup warms
        # exactly the programs steady-state serving runs
        if not buckets or n is None:
            if n is not None and baked is not None and n != baked:
                raise ValueError(
                    f"this artifact holds batch size {baked} only (no "
                    f"bucketed programs); request has {n} rows — "
                    f"re-export with save_aot_model(..., "
                    f"bucket_edges=[...]) to serve other sizes")
            return self._call(None, [self._arg(k, feed[k]) for k in names])
        cands = [e for e in buckets if e >= n]
        if not cands:
            if n == baked:
                return self._call(None, [self._arg(k, feed[k])
                                         for k in names])
            raise ValueError(
                f"request rows {n} exceed the largest exported bucket "
                f"{max(buckets)} (and the example shape {baked}); "
                f"re-export with larger bucket_edges")
        edge = min(cands)
        args = [self._arg(k, feed[k], edge, n) for k in names]
        args.append(torch.tensor(n, dtype=torch.int32, device=self.device))
        outs = self._call(edge, args)
        return [o[:n] if o.ndim >= 1 and o.shape[0] == edge else o
                for o in outs]

    def __call__(self, feed: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        outs = self.call_lazy(feed)
        return dict(zip(self._meta["fetch_names"], [_host(o) for o in outs]))

    run = __call__


def load_aot_model(dirname: str, place=None) -> AotPredictor:
    """An :class:`AotPredictor` over ``dirname`` on ``place`` (default
    the card; pass ``fluid.CPUPlace()`` for the host)."""
    return AotPredictor(dirname, place)
