"""PS tables: host-RAM parameter storage with pull and push accessors.

Counterpart of ``paddle_tpu/distributed/ps/table.py``, the value store
the BoxPS tier keeps its rows in: ``Initializer``, ``IdHashInitializer``
and ``CommonSparseTable`` (pull, push with sgd, ``set_rows``, the
row-state plane, save and load).  Numpy only, on the
host, as in the reference.  Storage is one contiguous value matrix grown
by doubling, with a dict as the id -> row-slot hash; pull and push are
vectorized over the batch.  ``CtrSparseTable``, the cold-row store and
the tiered and sharded tables are not ported yet.
"""
from __future__ import annotations

import os
import threading
from typing import Dict

import numpy as np

class Initializer:
    def __init__(self, kind="uniform", scale=0.07, seed=0):
        self.kind = kind
        self.scale = scale
        self.rng = np.random.RandomState(seed)

    def __call__(self, n, dim, ids=None, col0=0):
        # ids/col0 are the id-deterministic hooks (IdHashInitializer);
        # the sequential RNG kinds ignore them
        if self.kind == "zeros":
            return np.zeros((n, dim), np.float32)
        if self.kind == "gaussian":
            return (self.rng.randn(n, dim) * self.scale).astype(np.float32)
        return self.rng.uniform(-self.scale, self.scale,
                                (n, dim)).astype(np.float32)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer, vectorized over a uint64 array."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


class IdHashInitializer(Initializer):
    """Deterministic per-id rows: row(id) is a pure function of
    (id, column, seed), independent of arrival order, shard layout, or
    how many rows were created before it.  This is what makes a 4-shard
    `ShardedSparseTable` bit-identical to a single-table baseline — the
    sequential-RNG kinds above seed rows in creation order, which differs
    per layout.  Values are uniform in [-scale, scale) derived from a
    counter-based SplitMix64 hash (the stateless analog of Philox)."""

    def __init__(self, kind="uniform", scale=0.07, seed=0):
        super().__init__(kind, scale, seed)
        self._seed = np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)

    def __call__(self, n, dim, ids=None, col0=0):
        if self.kind == "zeros" or ids is None:
            # no ids -> nothing deterministic to key on; zeros keeps the
            # no-ids fallback itself order-independent
            return np.zeros((n, dim), np.float32)
        ids = np.asarray(ids, np.int64).reshape(-1).astype(np.uint64)
        assert len(ids) == n
        cols = (np.uint64(col0)
                + np.arange(dim, dtype=np.uint64))[None, :]
        key = _splitmix64(ids * np.uint64(0x9E3779B97F4A7C15)
                          + self._seed)[:, None]
        h = _splitmix64(key + _splitmix64(cols))
        # top 53 bits -> float64 uniform in [0, 1), then scale
        u = (h >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
        return ((2.0 * u - 1.0) * self.scale).astype(np.float32)


class CommonSparseTable:
    """Unbounded id -> row value store (large_scale_kv.h +
    common_sparse_table.cc semantics) with the sgd accessor.  The
    reference's adagrad and adam accessors, incremental-snapshot
    tracking, eviction and GEO merges serve its sharded and tiered
    tables, which are not ported yet."""

    def __init__(self, dim, optimizer="sgd", lr=0.01, initializer=None,
                 capacity=1024):
        if optimizer != "sgd":
            raise ValueError(f"accessor {optimizer!r} is not ported yet "
                             f"(only sgd)")
        self.dim = dim
        self.optimizer = optimizer
        self.lr = lr
        self.init = initializer or Initializer()
        self._slot_of: Dict[int, int] = {}       # id -> row index
        self._n = 0
        self._vals = np.zeros((capacity, dim), np.float32)
        self._lock = threading.Lock()

    # -- storage ------------------------------------------------------------
    def _grow(self, need):
        cap = len(self._vals)
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        grown = np.zeros((cap, self.dim), np.float32)
        grown[: self._n] = self._vals[: self._n]
        self._vals = grown

    def _init_rows(self, n, dim, ids=None, col0=0):
        """Invoke the initializer, threading ids through for the
        id-deterministic kinds; plain callables that only take (n, dim)
        keep working."""
        try:
            return self.init(n, dim, ids=ids, col0=col0)
        except TypeError:
            return self.init(n, dim)

    def _slots(self, uniq_ids) -> np.ndarray:
        """Map ids -> row slots, batch-creating missing rows (in the
        order of ``uniq_ids``, so the initializer draws them in that
        order, as the reference's does)."""
        slots = np.empty(len(uniq_ids), np.int64)
        missing = []
        for k, i in enumerate(uniq_ids):
            s = self._slot_of.get(i, -1)
            if s < 0:
                missing.append(k)
            slots[k] = s
        if missing:
            self._grow(self._n + len(missing))
            fresh = self._init_rows(
                len(missing), self.dim,
                ids=np.array([uniq_ids[k] for k in missing], np.int64))
            for j, k in enumerate(missing):
                s = self._n
                self._n += 1
                self._slot_of[uniq_ids[k]] = s
                slots[k] = s
                self._vals[s] = fresh[j]
        return slots

    # -- accessor API -------------------------------------------------------
    def pull(self, ids: np.ndarray) -> np.ndarray:
        """PullSparse: gather rows, creating missing ids (fleet_wrapper.h:111)."""
        ids = np.asarray(ids).reshape(-1)
        with self._lock:
            uniq, inv = np.unique(ids, return_inverse=True)
            slots = self._slots(uniq.tolist())
            return self._vals[slots][inv]

    def push(self, ids: np.ndarray, grads: np.ndarray):
        """PushSparse: an sgd step (fleet_wrapper.h:200; duplicate ids sum
        like SelectedRows merge)."""
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        with self._lock:
            slots = self._slots(uniq.tolist())
            merged = np.zeros((len(slots), self.dim), np.float32)
            np.add.at(merged, inv, grads)
            self._vals[slots] -= self.lr * merged

    def set_rows(self, ids: np.ndarray, values: np.ndarray):
        """Overwrite rows (BoxPS EndPass writeback: the device cache
        trained the values, the host table is plain storage for them —
        box_wrapper.h:339 EndPass semantics)."""
        ids = np.asarray(ids).reshape(-1)
        values = np.asarray(values, np.float32).reshape(len(ids), self.dim)
        with self._lock:
            slots = self._slots(ids.tolist())
            self._vals[slots] = values

    def size(self):
        return self._n

    # -- row-state plane ----------------------------------------------------
    # Full per-row state as a dict of aligned arrays ({"ids", "vals"}),
    # the payload save/load and interop.box_from_numpy share.  A reference
    # file's optimizer moments ("m", "v", "t") have no place in an sgd
    # table and are not read.

    def row_state(self, ids) -> Dict[str, np.ndarray]:
        """Full state for existing ``ids`` (KeyError on unknown ids)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            slots = np.array([self._slot_of[int(i)] for i in ids.tolist()],
                             np.int64)
            vals = (self._vals[slots].copy() if len(ids)
                    else np.zeros((0, self.dim), np.float32))
        return {"ids": ids.copy(), "vals": vals}

    def set_row_state(self, state: Dict[str, np.ndarray]):
        """Install rows with their full state (inverse of row_state),
        creating rows without drawing from the initializer."""
        ids = np.asarray(state["ids"], np.int64).reshape(-1)
        with self._lock:
            slots = np.empty(len(ids), np.int64)
            fresh = []
            for k, i in enumerate(map(int, ids)):
                s = self._slot_of.get(i, -1)
                if s < 0:
                    fresh.append((k, i))
                slots[k] = s
            if fresh:
                self._grow(self._n + len(fresh))
                for k, i in fresh:
                    self._slot_of[i] = slots[k] = self._n
                    self._n += 1
            self._vals[slots] = np.asarray(state["vals"], np.float32)

    def all_ids(self) -> np.ndarray:
        with self._lock:
            return np.array(sorted(self._slot_of), np.int64)

    def save(self, path):
        """Atomic full dump (tmp + fsync + rename: a crash mid-save can
        never leave a torn file the next load() trusts), round-tripped
        bit-exactly; the reference's ``load`` reads it."""
        _dump_state_npz(path, self.dim, self.row_state(self.all_ids()))

    def load(self, path):
        p = str(path)
        data = np.load(p if p.endswith(".npz") else p + ".npz")
        with self._lock:
            self._slot_of = {}
            self._n = 0
            self._vals = np.zeros((max(1024, len(data["ids"])), self.dim),
                                  np.float32)
        self.set_row_state({"ids": data["ids"], "vals": data["vals"]})


def _dump_state_npz(path, dim, state):
    """Write a row-state dict to ``.npz`` atomically: a temporary file in
    the same directory, fsync'd, then renamed over the target, so a crash
    mid-save never leaves a torn file a later ``load`` trusts."""
    import io
    buf = io.BytesIO()
    np.savez(buf, dim=np.int64(dim), **state)
    p = str(path)
    if not p.endswith(".npz"):
        p += ".npz"
    tmp = f"{p}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
