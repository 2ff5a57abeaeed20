"""Executor: an eager interpreter over a block's ops.

Counterpart of ``paddle_tpu/fluid/executor.py``.  The TPU package lowers
a whole block to one jaxpr and compiles it; the port calls each op's
lowering rule in program order on torch tensors that live on the
executor's place, the way the reference's ``RunPartialPreparedContext``
runs ``op->Run(scope, place)``.  What stays the same: feeds in, fetches
out, persistable state kept in a ``Scope``, pruning to the fetch set, the
``is_test`` hint reaching every lowering, and shape bucketing (pad the
leading batch dim of every feed up to a bucket edge, slice the fetches
back to the true row count), and state carried between runs: the scope's
persistables and the vars a program declares in
``program._hints["carry_vars"]`` (the decode plane's KV caches), which are
read from the scope, written back after every run, never batch-sliced
and never pruned.  A per-(program version, feed names, fetch names) run
plan caches the pruned op list.  CUDA graphs come later.

A scope value that is not a tensor (a numpy array seeded with
``scope.set_var``, such as a BoxPS pass cache) moves to the executor's
device on the first run that reads it and is written back as that
tensor, so later runs never copy it again.  ``return_numpy=False``
returns lazy :class:`~.async_pipeline.FetchHandle` s; ``run_async`` keeps
a bounded window of them (``AsyncStepRunner``); ``train_from_dataset``
and ``train_passes`` drive a dataset through it (distributed/trainer.py).
The ``executor.ops_per_step`` gauge holds the op count of the last run's
plan; ``executor.compile_cache_miss`` / ``_hit`` count run-plan builds
and reuses (the port's counterpart of the reference's compiles) and
``executor.steps_completed`` the finished runs.

Observability (fluid/trace.py, fluid/flight_recorder.py): with tracing on
each op emits an ``op`` span and each run an ``executor::step`` span,
carrying the ambient trace context (a serving batch's id).  These are
host times: the executor queues each op's kernels and moves on, so on the
card a span closes when its work was queued, not when it finished.  The
flight recorder keeps one wide record per run, tracing on or off.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Sequence

import hashlib

import numpy as np
import torch

from . import compile_cache
from . import core
from . import flight_recorder as _flight
from . import trace
from .core import Scope, global_scope
from .framework import Block, Program, Variable, default_main_program, \
    prune_ops, torch_dtype, _op_reads
from ..ops.registry import get_op, LoweringContext


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _fetch_name(f):
    return f.name if isinstance(f, Variable) else str(f)


def _batch_major_hint(block, op):
    """Is the op's primary input batch-major?  False for persistable
    inputs and vars with a known static leading dim, True when the IR
    marks dim 0 dynamic (-1), None when unknown."""
    names = op.inputs.get("X") or op.input_arg_names[:1]
    if not names:
        return None
    v = block._find_var_recursive(names[0])
    if v is None:
        return None
    if v.persistable:
        return False
    if names[0] in (block.program._hints.get("carry_vars") or ()):
        # declared carried state (the decode KV pools): its leading dim is
        # the state's own extent, never the step's batch
        return False
    if v.shape is None:
        return None
    return len(v.shape) >= 1 and v.shape[0] == -1


def run_block_ops(block: Block, env: Dict[str, Any], ctx: LoweringContext,
                  ops=None):
    """Run the ops (default: the whole block) by invoking each lowering
    rule on the tensors in ``env``; outputs are written back into it."""
    from .control_flow_impl import CONTROL_FLOW_OPS, run_control_flow_op
    op_list = block.ops if ops is None else ops
    # one boolean read for the whole loop: off, each op pays one `if`
    tr_on = trace.enabled()
    for op in op_list:
        if op.type in ("feed", "fetch"):
            continue
        _t0 = trace.now() if tr_on else 0
        if op.type in CONTROL_FLOW_OPS:
            run_control_flow_op(op, block, env, ctx)
            if tr_on:
                trace.complete(op.type, _t0, cat="op")
            continue
        opdef = get_op(op.type)
        ins = {}
        amp_cast = op.attrs.get("__amp_cast__")
        for slot, names in op.inputs.items():
            missing = [n for n in names if n not in env]
            if missing and op.type == "write_to_array" and slot == "Array":
                continue              # the array's first write starts it
            if missing:
                raise KeyError(
                    f"op '{op.type}' input {slot}={missing}: not fed, not "
                    f"in the scope and not produced by an earlier op")
            vals = [env[n] for n in names]
            if amp_cast and slot in amp_cast:
                # a cast that prune_redundant_casts folded into this op
                # (passes/amp.py): applied here, inline, on every device
                dts = amp_cast[slot]
                vals = [v if j >= len(dts) or dts[j] is None
                        else v.to(torch_dtype(dts[j]))
                        for j, v in enumerate(vals)]
            ins[slot] = vals
        if ctx.batch_valid is not None:
            ctx.cur_op_batch_major = _batch_major_hint(block, op)
        attrs = op.attrs
        if op.type == "recurrent":     # StaticRNN runs its step sub-block
            attrs = dict(attrs, __program__=block.program)
        if "SkipUpdate" in ins:        # GradientMerge's k-step gate
            from ..ops.optimizer_ops import apply_skip_update
            outs = apply_skip_update(ins, opdef.fn(
                {k: v for k, v in ins.items() if k != "SkipUpdate"},
                attrs, ctx))
        else:
            outs = opdef.fn(ins, attrs, ctx)
        if tr_on:
            trace.complete(op.type, _t0, cat="op")
        for slot, names in op.outputs.items():
            for name, val in zip(names, outs.get(slot, [])):
                if val is not None:
                    env[name] = val
    return env


def _read_before_write(block, name) -> bool:
    """Does some op read ``name`` before any op writes it?"""
    for op in block.ops:
        if name in _op_reads(block, op):
            return True
        if name in op.output_arg_names:
            return False
    return False


class _RunPlan:
    """The pruned op list of one (program version, feeds, fetches), the
    vars it reads from the scope and the state it writes back."""

    def __init__(self, program, run_ops, scope_reads, written_names):
        self.program = program          # keeps the id() in the key valid
        self.run_ops = run_ops
        self.scope_reads = scope_reads
        self.written_names = written_names
        self.n_ops = sum(op.type not in ("feed", "fetch") for op in run_ops)
        # the plan's fingerprint in the flight recorder's step records
        self.fp = hashlib.sha1(repr(
            [(op.type, sorted(op.input_arg_names),
              sorted(op.output_arg_names)) for op in run_ops]).encode()
        ).hexdigest()[:12]
        self.fresh = True               # built by the run that takes it


class Executor:
    """fluid.Executor(place).  The place defaults to ``CUDAPlace(0)``;
    without a CUDA device that raises — run on the host by asking for
    ``fluid.CPUPlace()``."""

    _PLAN_CACHE_CAPACITY = 128

    def __init__(self, place: Optional[core.Place] = None):
        self.place = place if place is not None else core.CUDAPlace(0)
        self.device = self.place.torch_device()
        if self.device.type == "cuda":
            # full-precision fp32 products on the card: the TPU package's
            # f32 matmuls are the reference, and TF32 keeps ~3 digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            # the same bits on every run, as XLA gives them: cuDNN's
            # default weight-gradient algorithms sum in a run-dependent
            # order, and the port's contracts on the card (the kernel tier
            # against the plain program, padded against unpadded steps)
            # need identical reruns
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
        self._plans: "OrderedDict[tuple, _RunPlan]" = OrderedDict()
        self._step = 0
        # run_async's windows, one per (program, fetches, scope, window)
        self._async_runners: "OrderedDict[tuple, Any]" = OrderedDict()
        self._last_trainer_stats = None

    # -- public API ---------------------------------------------------------
    def run(self, program=None, feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            scope: Optional[Scope] = None, return_numpy: bool = True,
            use_program_cache: bool = True):
        """Run ``program`` (default: the main program) on ``feed``; return
        the ``fetch_list`` values.  With ``use_program_cache=False`` the
        run plan is built for this call only and the plan cache is left
        as it was."""
        program = program or default_main_program()
        fetch_names = [_fetch_name(f) for f in _as_list(fetch_list)]
        if hasattr(program, "_apply_ir_passes"):     # CompiledProgram
            # BuildStrategy passes run once, seeded and protected by this
            # first run's fetch set
            program._apply_ir_passes(fetch_names)
            program = program._program
        scope = scope or global_scope()
        feed = dict(feed or {})

        bucket = n_valid = None
        want = program._hints.get("shape_bucketing")
        if want is None:
            want = core.get_flag("shape_bucketing")
        if want and feed:
            dims = {int(v.shape[0]) for v in feed.values() if np.ndim(v) >= 1}
            if len(dims) == 1:
                n_valid = next(iter(dims))
                edges = compile_cache.normalize_edges(
                    program._hints.get("bucket_edges")
                    or core.get_flag("shape_bucket_edges"))
                bucket = compile_cache.bucket_for(n_valid, edges)
                if bucket != n_valid:
                    feed = {k: compile_cache.pad_dim0(v, bucket)
                            for k, v in feed.items()}
                else:
                    bucket = None

        plan = self._plan(program, sorted(feed), fetch_names, scope,
                          use_program_cache)
        built, plan.fresh = plan.fresh, False
        m = trace.metrics()
        m.counter("executor.compile_cache_miss" if built
                  else "executor.compile_cache_hit").inc()
        m.gauge("executor.ops_per_step").set(plan.n_ops)
        block = program.global_block()
        env: Dict[str, Any] = {}
        for n in plan.scope_reads:
            v = scope.find_var(n)
            if v is not None and not isinstance(v, torch.Tensor):
                v = self._seed_scope_value(scope, block, n, v)
            if v is not None:
                env[n] = v
        for k, v in feed.items():
            var = block._find_var_recursive(k)
            env[k] = self._to_device(v, var.dtype if var is not None
                                     else None)
        seed = program.random_seed if program.random_seed is not None else 0
        ctx = LoweringContext(device=self.device,
                              base_seed=seed * 1_000_003 + self._step,
                              is_test=bool(program._hints.get("is_test")))
        step = self._step
        self._step += 1
        if bucket is not None:
            ctx.batch_valid, ctx.batch_padded = n_valid, bucket
        _t0 = trace.now()       # always: the flight recorder times steps
        with torch.no_grad():
            run_block_ops(program.global_block(), env, ctx,
                          ops=plan.run_ops)
        if trace.enabled():
            trace.complete("executor::step", _t0, cat="step",
                           args={"step": step, "n_fetch": len(fetch_names)})
        m.counter("executor.steps_completed").inc()
        if _flight.enabled():
            _flight.record_step(
                step=step, dur_us=(trace.now() - _t0) / 1e3, bucket=bucket,
                batch_valid=n_valid if bucket is not None else None,
                compile_miss=built, fp=plan.fp, n_fetch=len(fetch_names))
        for n in plan.written_names:
            if n in env:
                scope.set_var(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not produced")
        fetches = [env[n] for n in fetch_names]
        if bucket is not None:
            fetches = self._slice_true_batch(program, fetch_names, fetches,
                                             bucket, n_valid)
        if return_numpy:
            # numpy has no bfloat16: such a fetch (an AMP program's
            # activations) comes back float32, as VarBase.numpy() gives it
            return [(f.float() if f.dtype == torch.bfloat16 else f)
                    .detach().cpu().numpy() for f in fetches]
        return self._lazy_fetches(fetch_names, fetches)

    def _lazy_fetches(self, fetch_names, fetches):
        """FetchHandles over the fetched tensors, each with one CUDA
        event recorded after this run's work (None on the host)."""
        from .async_pipeline import FetchHandle
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        return [FetchHandle(f, name=n, event=event)
                for n, f in zip(fetch_names, fetches)]

    # -- async window and the dataset path ----------------------------------
    def run_async(self, program=None, feed: Optional[Dict[str, Any]] = None,
                  fetch_list: Optional[Sequence] = None,
                  scope: Optional[Scope] = None,
                  max_inflight: Optional[int] = None,
                  steps_per_dispatch: Optional[int] = None):
        """Async analog of :meth:`run`: submit the step into a bounded
        in-flight window (``FLAGS_max_inflight_steps``) and return a
        StepFuture of FetchHandles at once.  One runner is kept per
        (program, fetch set, scope, window); :meth:`drain_async` waits on
        all of them."""
        from .async_pipeline import AsyncStepRunner
        program = program or default_main_program()
        fetch_names = tuple(_fetch_name(f) for f in _as_list(fetch_list))
        key = (id(program), fetch_names, id(scope), max_inflight,
               steps_per_dispatch)
        runner = self._async_runners.get(key)
        if runner is None:
            runner = self._async_runners[key] = AsyncStepRunner(
                self, program, _as_list(fetch_list), scope=scope,
                max_inflight=max_inflight,
                steps_per_dispatch=steps_per_dispatch)
            while len(self._async_runners) > self._PLAN_CACHE_CAPACITY:
                _, old = self._async_runners.popitem(last=False)
                old.drain()
        else:
            self._async_runners.move_to_end(key)
        return runner.submit(feed or {})

    def drain_async(self):
        """Wait on every in-flight step of every run_async window and
        raise any dispatch error nobody read."""
        for runner in list(self._async_runners.values()):
            runner.drain()

    def close(self):
        """Drain the open run_async windows (their unread dispatch errors
        are dropped: close is cleanup) and forget the run plans."""
        for runner in list(self._async_runners.values()):
            try:
                runner.drain()
            except Exception:       # noqa: BLE001 — cleanup
                pass
        self._async_runners.clear()
        self._plans.clear()

    def train_from_dataset(self, program, dataset, scope=None, thread=0,
                           debug=False, fetch_list=None, fetch_info=None,
                           print_period=100):
        """Train on every batch of ``dataset`` (executor.cc:166
        RunFromDataset); a program with a BoxPS plan runs one pass."""
        from ..distributed.trainer import run_from_dataset
        return run_from_dataset(self, program, dataset, fetch_list,
                                print_period, train=True)

    def infer_from_dataset(self, program, dataset, scope=None, thread=0,
                           debug=False, fetch_list=None, fetch_info=None,
                           print_period=100):
        from ..distributed.trainer import run_from_dataset
        return run_from_dataset(self, program, dataset, fetch_list,
                                print_period, train=False)

    def train_passes(self, program, datasets, fetch_list=None,
                     print_period=100):
        """Multi-pass BoxPS training, pass N+1's host staging and pass N's
        writeback overlapped with training (distributed/trainer.py)."""
        from ..distributed.trainer import train_passes
        return train_passes(self, program, datasets, fetch_list,
                            print_period, train=True)

    # -- internals ----------------------------------------------------------
    def _seed_scope_value(self, scope: Scope, block, name, value):
        """A scope value that is not a tensor, on this executor's device
        in its var's dtype, written back into the scope that held it, so
        the copy happens once."""
        var = block._find_var_recursive(name)
        t = self._to_device(value, var.dtype if var is not None else None)
        s = scope
        while s is not None and name not in s._vars:
            s = s.parent
        (s or scope).set_var(name, t)
        return t
    def _to_device(self, v, dtype: Optional[str] = None):
        """The feed on the executor's device.  A floating-point feed takes
        its var's declared floating dtype (a float64 array fed to a
        float32 ``fluid.data`` computes in float32, as the reference does
        with x64 off); integer ids keep their dtype."""
        t = v if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(v))
        want = getattr(torch, dtype, None) if dtype else None
        if isinstance(want, torch.dtype) and want.is_floating_point \
                and t.is_floating_point():
            return t.to(device=self.device, dtype=want)
        return t.to(self.device)

    def _plan(self, program: Program, feed_names, fetch_names,
              scope: Scope, use_cache: bool = True) -> _RunPlan:
        key = (id(program), program._version, tuple(feed_names),
               tuple(fetch_names), id(scope))
        plan = self._plans.get(key) if use_cache else None
        if plan is not None and plan.program is program:
            self._plans.move_to_end(key)
            return plan
        block = program.global_block()
        persist = {n for n, v in block.vars.items() if v.persistable}
        # non-persistable vars the caller seeded into the scope count as
        # state too: their updates survive pruning and are written back
        scope_state = {n for op in block.ops for n in op.output_arg_names
                       if n not in persist and scope.find_var(n) is not None}
        # declared carried state (program._hints["carry_vars"], the decode
        # KV caches and pools) is written back whether or not the scope
        # held it when this plan was built, so a plan built before the
        # state was seeded never prunes its write
        carry = set(program._hints.get("carry_vars") or ())
        if carry:
            scope_state |= {n for op in block.ops
                            for n in op.output_arg_names if n in carry}
            missing = [n for n in sorted(carry)
                       if n in block.vars and block.vars[n].is_data
                       and n not in feed_names and scope.find_var(n) is None
                       and _read_before_write(block, n)]
            if missing:
                raise ValueError(
                    f"carry_vars {missing} are declared data vars but "
                    f"neither fed nor seeded in the scope: seed the "
                    f"initial carried state with scope.set_var(name, "
                    f"value) before the first run")
        run_ops = prune_ops(block, block.ops, targets=list(fetch_names),
                            extra_state=scope_state, feeds=set(feed_names))
        produced = set(feed_names)
        scope_reads = []
        for op in run_ops:
            # a control-flow op's sub-blocks read what they capture
            for n in _op_reads(block, op):
                if n not in produced:
                    scope_reads.append(n)
                    produced.add(n)
            produced.update(op.output_arg_names)
        written = sorted({n for op in run_ops for n in op.output_arg_names
                          if n in persist or n in scope_state})
        plan = _RunPlan(program, run_ops, scope_reads, written)
        if not use_cache:
            return plan
        self._plans[key] = plan
        while len(self._plans) > self._PLAN_CACHE_CAPACITY:
            self._plans.popitem(last=False)
        return plan

    @staticmethod
    def _slice_true_batch(program, fetch_names, fetches, bucket, n_valid):
        """Slice padded fetches back to the true batch size.  Persistable
        vars and vars with a known static leading dim are never
        batch-major, even when dim 0 equals the bucket size."""
        blk = program.global_block()
        carry = set(program._hints.get("carry_vars") or ())

        def _not_batch(n):
            if n in carry:      # carried state: dim 0 is its own extent
                return True
            v = blk._find_var_recursive(n)
            return v is not None and (
                v.persistable or (v.shape is not None
                                  and len(v.shape) >= 1
                                  and v.shape[0] != -1))

        return [f if (f.ndim < 1 or f.shape[0] != bucket or _not_batch(n))
                else f[:n_valid]
                for n, f in zip(fetch_names, fetches)]
