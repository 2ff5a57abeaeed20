"""BoxPS: host-RAM embedding storage with a device cache a pass.

Counterpart of ``paddle_tpu/distributed/ps/box.py`` (box_wrapper.h:
``PullSparse`` :141 serves lookups from a device replica cache,
``PushSparseGrad`` :282 trains it, ``BeginPass``/``EndPass`` :339-366
move the pass's feasign working set between the host store and device
memory).  The table's id space, and what it holds, can exceed the card
arbitrarily; only the pass's unique ids live on the device.

The cache is a normal framework parameter, a ``[C, dim]`` tensor the
program's ``pull_box_sparse`` op gathers from and the ordinary optimizer
op updates in the same step.  The only per-batch host work is the id ->
cache-slot translation (``np.searchsorted`` over the pass's sorted unique
ids).  Pass boundaries do the tiering:

  begin_pass(ids)  pull the pass's unique rows from the host table, pad
                   to a power-of-two C, return the numpy cache value (the
                   executor moves it to the card on its first run).
  slots_of(ids)    translate raw (up to 64-bit) ids to cache slots.
  end_pass(cache)  write the trained rows back into the host table: one
                   device-to-host copy on the caller's thread, the store
                   write on a worker thread.

Driven by ``Executor.train_from_dataset`` through
``program._hints['box_plan']`` (distributed/trainer.py) or by hand.
"""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

from .table import CommonSparseTable, Initializer


def _host_rows(cache_value) -> np.ndarray:
    """The cache as a float32 numpy array.  A torch tensor, on the card or
    the host, is copied to the host once; numpy passes through."""
    if hasattr(cache_value, "detach"):
        import torch
        return cache_value.detach().to("cpu", torch.float32).numpy()
    return np.asarray(cache_value, np.float32)


class BoxPSWrapper:
    """One embedding table's host store and per-pass device cache state.

    Pass N+1's host work overlaps pass N's training (box_wrapper.h:339
    BeginFeedPass runs ahead of the training pass): ``begin_pass_async``
    runs the unique sweep and the host-store pull on a worker thread,
    ids shared with the in-flight pass are patched from the trained
    values at commit, and ``end_pass_async`` writes back in the
    background (the next pull waits on the write future, never the
    trainer thread)."""

    def __init__(self, dim: int, init_kind: str = "uniform",
                 init_scale: float = 0.07, seed: int = 0,
                 table: Optional[CommonSparseTable] = None):
        self.dim = int(dim)
        # the host store holds values only: training happens on the card
        # in the cache, so the table's accessor never runs (lr 0)
        self.host = table or CommonSparseTable(
            self.dim, "sgd", 0.0,
            initializer=Initializer(init_kind, init_scale, seed))
        self._pass_ids: Optional[np.ndarray] = None   # sorted unique
        self._cache_rows = 0                          # padded C
        self._pool = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="boxps")
        self._wb_future: Optional[Future] = None      # in-flight writeback
        self._last_trained = None                     # (ids, vals) of it

    @classmethod
    def sharded(cls, dim: int, n_shards: int = 4, name: str = "box_host",
                **kw) -> "BoxPSWrapper":
        """A host store over the sharded PS tier (the reference's
        ``ShardedSparseTable``): not ported yet."""
        raise NotImplementedError(
            "BoxPSWrapper.sharded needs distributed/ps/sharded.py, which "
            "is not ported yet (ROADMAP queue A item 11)")

    # -- pass lifecycle -----------------------------------------------------
    def begin_pass(self, ids) -> np.ndarray:
        """Stage the pass working set; returns the ``[C, dim]`` cache
        value (padded with zero rows) to seed the cache parameter.  The
        synchronous form of begin_pass_async + begin_pass_commit."""
        cache = self.begin_pass_commit(self.begin_pass_async(ids))
        if cache is None:
            raise ValueError("begin_pass: empty id set")
        return cache

    def begin_pass_async(self, ids) -> Future:
        """Start staging the next pass on a worker thread while the
        current pass trains.  ``ids`` is an array or a zero-argument
        callable producing one (so the dataset sweep runs on the worker
        too).  Ids that belong to the still-training current pass are left
        as placeholders and patched from the trained values at commit."""
        cur_ids = self._pass_ids                     # may train now
        wb = self._wb_future

        def work():
            raw = ids() if callable(ids) else ids
            uniq = np.unique(np.asarray(raw).reshape(-1))
            if len(uniq) == 0:
                return None, None, None     # empty pass: commit -> None
            if wb is not None:
                wb.result()          # the prior pass's writeback lands
            if cur_ids is not None and len(cur_ids):
                pos = np.searchsorted(cur_ids, uniq)
                pos = np.minimum(pos, len(cur_ids) - 1)
                stale = cur_ids[pos] == uniq         # in flight on device
            else:
                stale = np.zeros(len(uniq), bool)
            rows = np.zeros((len(uniq), self.dim), np.float32)
            fresh = ~stale
            if fresh.any():
                rows[fresh] = self.host.pull(uniq[fresh])
            c = 1 << int(np.ceil(np.log2(max(1, len(uniq)))))
            cache = np.zeros((c, self.dim), np.float32)
            cache[: len(uniq)] = rows
            return uniq, cache, stale

        return self._pool.submit(work)

    def begin_pass_commit(self, fut: Future) -> np.ndarray:
        """Make the prefetched pass current.  Call after end_pass[_async]
        of the previous pass: stale rows (ids shared with that pass) are
        patched here from its trained values, so the prefetch never
        observes half-trained state."""
        uniq, cache, stale = fut.result()
        if uniq is None:
            return None          # empty pass: a no-op, state untouched
        if stale.any():
            idx = np.flatnonzero(stale)
            sids = uniq[idx]
            if self._last_trained is not None:
                tids, tvals = self._last_trained
                pos = np.searchsorted(tids, sids)
                pos = np.minimum(pos, len(tids) - 1)
                hit = tids[pos] == sids
                cache[idx[hit]] = tvals[pos[hit]]
                idx, sids = idx[~hit], sids[~hit]
            if len(idx):
                # the previous pass was abandoned (eval): the store is
                # the truth
                self.wait_writeback()
                cache[idx] = self.host.pull(sids)
        self._pass_ids = uniq
        self._cache_rows = len(cache)
        return cache

    def slots_of(self, ids) -> np.ndarray:
        """Raw ids -> cache slots (int64).  Every id must belong to the
        pass set (BeginFeedPass enumerated exactly the pass's
        feasigns)."""
        if self._pass_ids is None:
            raise RuntimeError("slots_of before begin_pass")
        flat = np.asarray(ids)
        pos = np.searchsorted(self._pass_ids, flat)
        pos = np.minimum(pos, len(self._pass_ids) - 1)
        if not np.array_equal(self._pass_ids[pos], flat):
            missing = flat[self._pass_ids[pos] != flat]
            raise KeyError(
                f"ids outside the current pass working set (first few: "
                f"{missing.reshape(-1)[:5].tolist()}) — begin_pass must see "
                f"every id the pass will train on")
        return pos.astype(np.int64)

    def end_pass(self, cache_value):
        """Write the trained cache rows back to the host store."""
        self.end_pass_async(cache_value)
        self._wb_future.result()

    def end_pass_async(self, cache_value):
        """Copy the trained rows to the host now (the one device-to-host
        copy, on the caller's thread) and write them back on a worker
        thread: the store write overlaps the next pass's training;
        begin_pass_async chains on the future, and the trained values
        stay in memory to patch a prefetched pass's shared ids."""
        if self._pass_ids is None:
            raise RuntimeError("end_pass before begin_pass")
        ids = self._pass_ids
        vals = _host_rows(cache_value)[: len(ids)].copy()
        self._last_trained = (ids, vals)
        self._wb_future = self._pool.submit(self.host.set_rows, ids, vals)
        self._pass_ids = None
        self._cache_rows = 0

    def wait_writeback(self):
        if self._wb_future is not None:
            self._wb_future.result()

    def abandon_pass(self):
        """Close a pull-only pass (an inference sweep): no writeback."""
        self._pass_ids = None
        self._cache_rows = 0

    # -- introspection ------------------------------------------------------
    @property
    def pass_ids(self) -> Optional[np.ndarray]:
        """The current pass's sorted unique ids (None between passes)."""
        return self._pass_ids

    @property
    def pass_size(self) -> int:
        return 0 if self._pass_ids is None else len(self._pass_ids)

    @property
    def cache_rows(self) -> int:
        return self._cache_rows

    def host_rows(self) -> int:
        return self.host.size()


_wrappers: Dict[str, BoxPSWrapper] = {}


def get_box_wrapper(name: str = "default_box", dim: Optional[int] = None,
                    **kw) -> BoxPSWrapper:
    """Named singleton registry (BoxWrapper::GetInstance analog)."""
    w = _wrappers.get(name)
    if w is None:
        if dim is None:
            raise KeyError(f"box wrapper '{name}' not created yet — pass "
                           f"dim on first use")
        w = _wrappers[name] = BoxPSWrapper(dim, **kw)
    elif dim is not None and w.dim != int(dim):
        raise ValueError(f"box wrapper '{name}' exists with dim {w.dim}, "
                         f"requested dim {dim}")
    return w


def reset_box_wrappers():
    _wrappers.clear()
