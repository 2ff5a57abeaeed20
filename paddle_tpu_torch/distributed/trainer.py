"""Trainer / dataset path: the ``Executor.train_from_dataset`` loop.

Counterpart of ``paddle_tpu/distributed/trainer.py`` (reference
framework/trainer.h MultiTrainer + device_worker.h HogwildWorker, driven
by Executor::RunFromDataset, executor.cc:166, with the host/device
overlap of operators/reader/buffered_reader.cc's double buffer).  One
prefetching loop: a producer thread parses batch t+1, translates its raw
ids to cache slots (BoxPS programs) and copies it to the executor's
device while step t runs; steps go through an ``AsyncStepRunner`` window,
so the consumer blocks only when parsing is slower than the step.
``TrainerStats`` shows which: ``input_wait_s`` near 0 when the pipeline
overlaps, near the parse time when it cannot.

``train_passes`` is the double-buffered BoxPS pass loop: pass N+1's
dataset sweep and host-store pull run on the box worker thread while
pass N trains.  The elastic-preemption drain and the checkpoint hooks of
the reference's ``run_from_dataset`` are not ported yet; asking for a
checkpoint raises.
"""
from __future__ import annotations

import time

import numpy as np
import torch


class TrainerStats:
    """Per-run timing: the monitor counters of trainer.h's Worker."""

    def __init__(self):
        self.steps = 0
        self.input_wait_s = 0.0     # consumer blocked on the feed queue
        self.step_s = 0.0           # dispatch time per step (async: submit)
        self.host_wait_s = 0.0      # blocked on in-flight device steps
        self.produce_s = 0.0        # producer parse + stage time (overlapped)
        self.total_s = 0.0

    def as_dict(self):
        return {"steps": self.steps,
                "input_wait_s": round(self.input_wait_s, 4),
                "step_s": round(self.step_s, 4),
                "host_wait_s": round(self.host_wait_s, 4),
                "produce_s": round(self.produce_s, 4),
                "total_s": round(self.total_s, 4)}


def _enumerate_pass_ids(plan, dataset):
    """The pass enumeration sweep (BeginFeedPass analog).  A unique per
    batch before accumulating keeps the working memory at O(unique)."""
    ids_all = []
    for batch in dataset._iter_batches():
        for k in plan["ids"]:
            ids_all.append(np.unique(np.asarray(batch[k])))
    return (np.concatenate(ids_all) if ids_all
            else np.zeros(0, np.int64))


def _slot_transform(plan, box):
    def transform(feed):
        out = dict(feed)
        for k in plan["ids"]:
            if k in out:
                raw = np.asarray(out[k])
                out[k] = box.slots_of(raw.reshape(-1)).reshape(raw.shape)
        return out
    return transform


def _stage_cache(program, scope, plan, cache):
    """A pass's cache into the scope; the accumulators sized by the
    previous pass's cache (its Adam moments) go with it, and the
    executor fills them again at the new cache's shape."""
    scope.set_var(plan["cache"], cache)
    for n in getattr(program, "_hints", {}).get("runtime_shaped_state", {}):
        scope.erase(n)


def _box_pass(program, dataset, train):
    """The BoxPS pass lifecycle around one dataset sweep
    (box_wrapper.h:339-366 BeginPass/EndPass): enumerate the pass's
    unique feasigns, stage the cache parameter, translate raw ids to
    cache slots per batch and, when training, write the trained rows back
    at the end.  Returns (batch_transform, finish): the identity pair
    when the program has no box plan."""
    plan = getattr(program, "_hints", {}).get("box_plan")
    if not plan:
        return (lambda feed: feed), (lambda: None)
    from .ps.box import get_box_wrapper
    from ..fluid.core import global_scope

    box = get_box_wrapper(plan["table"], dim=plan["dim"])
    ids = _enumerate_pass_ids(plan, dataset)
    if not len(ids):
        return (lambda feed: feed), (lambda: None)
    cache = box.begin_pass(ids)
    scope = global_scope()
    _stage_cache(program, scope, plan, cache)

    def finish():
        if train:
            box.end_pass(scope.find_var(plan["cache"]))
        else:
            box.abandon_pass()            # pull-only pass: no writeback

    return _slot_transform(plan, box), finish


def train_passes(executor, program, datasets, fetch_list=None,
                 print_period=100, train=True, prefetch=2):
    """Double-buffered BoxPS pass loop (box_wrapper.h:339 BeginFeedPass
    runs ahead of the training pass): while pass N trains, pass N+1's
    dataset sweep and host-store pull run on the box worker thread, and
    pass N's writeback overlaps pass N+1's training.  ``datasets`` is the
    ordered list of per-pass datasets; the trained cache rows land in the
    host store exactly as the serial begin/end loop places them."""
    plan = getattr(program, "_hints", {}).get("box_plan")
    if not plan:
        raise ValueError("train_passes needs a program with a box_plan "
                         "hint (pull_box_sparse in the graph)")
    from .ps.box import get_box_wrapper
    from ..fluid.core import global_scope

    box = get_box_wrapper(plan["table"], dim=plan["dim"])
    scope = global_scope()
    results = []
    datasets = list(datasets)
    if not datasets:
        return results
    fut = box.begin_pass_async(
        lambda ds=datasets[0]: _enumerate_pass_ids(plan, ds))
    for i, ds in enumerate(datasets):
        cache = box.begin_pass_commit(fut)
        if cache is not None:
            _stage_cache(program, scope, plan, cache)
        if i + 1 < len(datasets):
            # the next pass's sweep and pull start now, beside this pass
            fut = box.begin_pass_async(
                lambda nxt=datasets[i + 1]: _enumerate_pass_ids(plan, nxt))
        if cache is None:
            # an empty pass (no batches): a no-op, as in the serial path
            results.append([])
            continue
        results.append(run_from_dataset(
            executor, program, ds, fetch_list, print_period=print_period,
            train=train, prefetch=prefetch,
            _box=(_slot_transform(plan, box),
                  (lambda: box.end_pass_async(
                      scope.find_var(plan["cache"]))) if train
                  else box.abandon_pass)))
    box.wait_writeback()
    return results


def run_from_dataset(executor, program, dataset, fetch_list=None,
                     print_period=100, train=True, prefetch=2, _box=None,
                     checkpoint_manager=None, checkpoint_every=0):
    """Run every batch of ``dataset`` through ``program``; returns the
    fetches of every ``print_period``-th step (materialised).  The
    reference's checkpoint hooks (``checkpoint_manager``,
    ``checkpoint_every``, and with them its resume cursor) are not
    ported yet and raise."""
    from ..fluid.async_pipeline import AsyncStepRunner
    from ..fluid import trace as _trace
    from ..utils.prefetch import Prefetcher

    if checkpoint_manager is not None or checkpoint_every:
        raise NotImplementedError(
            "run_from_dataset's checkpoint hooks need fluid/checkpoint.py, "
            "which is not ported yet (ROADMAP queue A item 9)")
    fetch_list = fetch_list or []
    fetch_names = [f if isinstance(f, str) else f.name for f in fetch_list]
    stats = TrainerStats()
    # _box: (transform, finish) from train_passes, which manages the
    # pass lifecycle itself (double-buffered begin/end)
    box_transform, box_finish = _box or _box_pass(program, dataset, train)
    device = executor.device

    def stage(feed):
        # on the producer thread: ids -> cache slots, then the copy to
        # the executor's device, so it overlaps the step in flight
        feed = box_transform(feed)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in feed.items()}

    def on_produce(dt):
        stats.produce_s += dt

    pf = Prefetcher(dataset._iter_batches(), stage=stage,
                    capacity=max(1, prefetch), on_produce=on_produce)
    # PS-served programs keep the blocking loop: their pull/push phases
    # wrap each run() call and must see it complete
    prog_hints = getattr(program, "_hints", {}) or {}
    runner = None
    if prog_hints.get("ps_plan") is None \
            and prog_hints.get("ps_server") is None:
        runner = AsyncStepRunner(executor, program, fetch_names)
    _hw = _trace.metrics().histogram("executor.host_wait_seconds")
    hw0 = _hw.stats()["total"]
    t0 = time.perf_counter()
    results = []
    step = 0
    try:
        while True:
            t_wait = time.perf_counter()
            item = pf.get()
            stats.input_wait_s += time.perf_counter() - t_wait
            if item is Prefetcher._STOP:
                break
            t_step = time.perf_counter()
            if runner is not None:
                fut = runner.submit(item)
                outs = None
            else:
                outs = executor.run(program, feed=item,
                                    fetch_list=fetch_names)
            stats.step_s += time.perf_counter() - t_step
            if fetch_names and print_period and step % print_period == 0:
                if outs is None:
                    outs = fut.result()     # materialise print steps only
                vals = {n: np.asarray(o).reshape(-1)[:4]
                        for n, o in zip(fetch_names, outs)}
                print(f"[trainer] step {step}: {vals}")
                results.append(outs)
            step += 1
        if runner is not None:
            # close the window before the box writeback reads trained
            # rows; also surfaces any stored dispatch error
            runner.drain()
            runner = None
    finally:
        if runner is not None:
            # error path: wait out in-flight steps (the writeback below
            # reads the state they write) without letting a secondary
            # dispatch error mask the primary exception
            runner.abort()
        pf.close()
        box_finish()
        stats.steps = step
        stats.host_wait_s = _hw.stats()["total"] - hw0
        stats.total_s = time.perf_counter() - t0
        executor._last_trainer_stats = stats
    return results
