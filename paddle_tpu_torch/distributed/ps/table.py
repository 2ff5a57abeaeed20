"""PS tables: host-RAM parameter storage with pull and push accessors.

Counterpart of ``paddle_tpu/distributed/ps/table.py``, the value store
the BoxPS tier keeps its rows in: ``Initializer``, ``IdHashInitializer``
and ``CommonSparseTable`` (pull, push through the sgd, adagrad and adam
accessors, ``set_rows``, ``push_delta``, the row-state plane, the dirty
set, eviction, save and load), which the sparse-table ops keep their
rows in too.  Numpy only, on the
host, as in the reference.  Storage is one contiguous value matrix grown
by doubling, with a dict as the id -> row-slot hash; pull and push are
vectorized over the batch.  ``CtrSparseTable``, the cold-row store and
the tiered and sharded tables are not ported yet.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, Optional

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
    """Unbounded id -> row table with per-row optimizer state
    (large_scale_kv.h + common_sparse_table.cc semantics): the sgd,
    adagrad and adam accessors, GEO merges (``push_delta``), the
    changed-rows delta of incremental snapshots (``drain_dirty``), the
    row-state plane, eviction with compaction, and save and load."""

    def __init__(self, dim, optimizer="sgd", lr=0.01, initializer=None,
                 beta1=0.9, beta2=0.999, epsilon=1e-8, capacity=1024):
        self.dim = dim
        self.optimizer = optimizer
        self.lr = lr
        self.init = initializer or Initializer()
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self._slot_of: Dict[int, int] = {}       # id -> row index
        self._n = 0
        self._vals = np.zeros((capacity, dim), np.float32)
        self._m: Optional[np.ndarray] = None     # adam moment1
        self._v: Optional[np.ndarray] = None     # adam moment2 / adagrad acc
        self._t: Optional[np.ndarray] = None     # adam per-row step
        self._lock = threading.Lock()
        # ids mutated / evicted since the last drain_dirty(): the
        # changed-rows delta source for incremental snapshots
        self._dirty: set = set()
        self._deleted: set = set()

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
        for attr in ("_m", "_v"):
            arr = getattr(self, attr)
            if arr is not None:
                g = np.zeros((cap, self.dim), np.float32)
                g[: self._n] = arr[: self._n]
                setattr(self, attr, g)
        if self._t is not None:
            t = np.zeros(cap, np.int64)
            t[: self._n] = self._t[: self._n]
            self._t = t

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
                self._dirty.add(uniq_ids[k])
        return slots

    def _ensure_state(self, want_t=False):
        cap = len(self._vals)
        if self._v is None:
            self._v = np.zeros((cap, self.dim), np.float32)
        if self.optimizer == "adam" and self._m is None:
            self._m = np.zeros((cap, self.dim), np.float32)
        if want_t and self._t is None:
            self._t = np.zeros(cap, np.int64)

    # -- accessor API -------------------------------------------------------
    def pull(self, ids: np.ndarray) -> np.ndarray:
        """PullSparse: gather rows, creating missing ids (fleet_wrapper.h:111)."""
        ids = np.asarray(ids).reshape(-1)
        with self._lock:
            uniq, inv = np.unique(ids, return_inverse=True)
            slots = self._slots(uniq.tolist())
            return self._vals[slots][inv]

    def push(self, ids: np.ndarray, grads: np.ndarray):
        """PushSparse: apply grads with the table's optimizer
        (fleet_wrapper.h:200; duplicate ids sum like SelectedRows merge)."""
        ids = np.asarray(ids).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(len(ids), self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        with self._lock:
            slots = self._slots(uniq.tolist())
            self._dirty.update(uniq.tolist())
            self._apply_grads_locked(slots, inv, grads)

    def _apply_grads_locked(self, slots, inv, grads):
        """Optimizer step for pre-resolved slots; caller holds the lock.
        An accessor other than sgd, adagrad and adam raises here, at the
        first push, as the reference's does."""
        merged = np.zeros((len(slots), self.dim), np.float32)
        np.add.at(merged, inv, grads)
        if self.optimizer == "sgd":
            self._vals[slots] -= self.lr * merged
        elif self.optimizer == "adagrad":
            self._ensure_state()
            acc = self._v[slots] + merged * merged
            self._v[slots] = acc
            self._vals[slots] -= (self.lr * merged
                                  / (np.sqrt(acc) + self.epsilon))
        elif self.optimizer == "adam":
            self._ensure_state(want_t=True)
            t = self._t[slots] + 1
            self._t[slots] = t
            m = self.beta1 * self._m[slots] + (1 - self.beta1) * merged
            v = (self.beta2 * self._v[slots]
                 + (1 - self.beta2) * merged * merged)
            self._m[slots], self._v[slots] = m, v
            mh = m / (1 - self.beta1 ** t[:, None])
            vh = v / (1 - self.beta2 ** t[:, None])
            self._vals[slots] -= self.lr * mh / (np.sqrt(vh)
                                                 + self.epsilon)
        else:
            raise ValueError(f"unknown accessor {self.optimizer}")

    def set_rows(self, ids: np.ndarray, values: np.ndarray):
        """Overwrite rows (BoxPS EndPass writeback: the device cache
        trained the values, the host table is plain storage for them —
        box_wrapper.h:339 EndPass semantics)."""
        ids = np.asarray(ids).reshape(-1)
        values = np.asarray(values, np.float32).reshape(len(ids), self.dim)
        with self._lock:
            slots = self._slots(ids.tolist())
            self._dirty.update(ids.tolist())
            self._vals[slots] = values

    def push_delta(self, ids: np.ndarray, deltas: np.ndarray):
        """GEO-SGD merge: the server adds trainer deltas (SparseGeoTable);
        duplicate ids' deltas sum first."""
        ids = np.asarray(ids).reshape(-1)
        deltas = np.asarray(deltas, np.float32).reshape(len(ids), self.dim)
        uniq, inv = np.unique(ids, return_inverse=True)
        merged = np.zeros((len(uniq), self.dim), np.float32)
        np.add.at(merged, inv, deltas)
        with self._lock:
            slots = self._slots(uniq.tolist())
            self._dirty.update(uniq.tolist())
            self._vals[slots] += merged

    def size(self):
        return self._n

    # -- row-state plane ----------------------------------------------------
    # Full per-row state as a dict of aligned arrays ({"ids", "vals", "m",
    # "v", "t"}): the one payload format of save/load, incremental
    # snapshots and interop.box_from_numpy.  Copying state through this
    # plane is bit-exact by construction.

    def _row_state_locked(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        ids = np.asarray(ids, np.int64).reshape(-1)
        slots = np.array([self._slot_of[int(i)] for i in ids.tolist()],
                         np.int64)
        st = {"ids": ids.copy(),
              "vals": (self._vals[slots].copy() if len(ids)
                       else np.zeros((0, self.dim), np.float32))}
        for key, attr in (("m", "_m"), ("v", "_v")):
            arr = getattr(self, attr)
            st[key] = (arr[slots].copy() if arr is not None
                       else np.zeros((len(ids), self.dim), np.float32))
        st["t"] = (self._t[slots].copy() if self._t is not None
                   else np.zeros(len(ids), np.int64))
        return st

    def row_state(self, ids) -> Dict[str, np.ndarray]:
        """Full state for existing ``ids`` (KeyError on unknown ids)."""
        with self._lock:
            return self._row_state_locked(ids)

    def _install_slots_locked(self, ids: np.ndarray) -> np.ndarray:
        """Slots for ``ids``, creating rows without drawing from the
        initializer: callers overwrite the full row state."""
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
                s = self._n
                self._n += 1
                self._slot_of[i] = s
                slots[k] = s
                self._vals[s] = 0.0
        return slots

    def set_row_state(self, state: Dict[str, np.ndarray]):
        """Install rows with their full state (inverse of row_state); a
        state without "m", "v" or "t" leaves those as they are."""
        ids = np.asarray(state["ids"], np.int64).reshape(-1)
        with self._lock:
            self._set_row_state_locked(ids, state)

    def _set_row_state_locked(self, ids, state):
        slots = self._install_slots_locked(ids)
        self._vals[slots] = np.asarray(state["vals"], np.float32)
        for key, attr in (("m", "_m"), ("v", "_v")):
            arr = state.get(key)
            if arr is None:
                continue
            arr = np.asarray(arr, np.float32)
            # a lazily-absent moment matrix equals all-zeros; only
            # materialize storage when the incoming state is nonzero
            if getattr(self, attr) is None and not arr.any():
                continue
            if getattr(self, attr) is None:
                setattr(self, attr,
                        np.zeros((len(self._vals), self.dim), np.float32))
            getattr(self, attr)[slots] = arr
        t = state.get("t")
        if t is not None:
            t = np.asarray(t, np.int64)
            if self._t is None and t.any():
                self._t = np.zeros(len(self._vals), np.int64)
            if self._t is not None:
                self._t[slots] = t
        self._dirty.update(ids.tolist())
        self._deleted.difference_update(ids.tolist())

    def drain_dirty(self):
        """Atomically take (changed_ids, deleted_ids) accumulated since
        the last drain: the incremental-snapshot delta source."""
        with self._lock:
            dirty = np.array(sorted(self._dirty), np.int64)
            deleted = np.array(sorted(self._deleted), np.int64)
            self._dirty.clear()
            self._deleted.clear()
            return dirty, deleted

    def all_ids(self) -> np.ndarray:
        with self._lock:
            return np.array(sorted(self._slot_of), np.int64)

    def _compact_locked(self, keep: np.ndarray) -> int:
        """Drop rows whose slot mask is False and compact storage; returns
        the number dropped.  Caller holds the lock."""
        n = self._n
        if keep.all():
            return 0
        kept_slots = np.nonzero(keep)[0]
        remap = {int(s): k for k, s in enumerate(kept_slots)}
        self._slot_of = {i: remap[s] for i, s in self._slot_of.items()
                         if s in remap}
        m = len(kept_slots)
        self._vals[:m] = self._vals[kept_slots]
        self._vals[m:n] = 0.0     # freed tail: no stale state may leak
        for attr in ("_m", "_v"):
            arr = getattr(self, attr)
            if arr is not None:
                arr[:m] = arr[kept_slots]
                arr[m:n] = 0.0
        if self._t is not None:
            self._t[:m] = self._t[kept_slots]
            self._t[m:n] = 0
        self._n = m
        return n - m

    def evict_rows(self, ids) -> int:
        """Drop rows by id (tier demotion: the row stays alive in a cold
        tier, so this records nothing into the deleted set)."""
        ids = np.asarray(ids, np.int64).reshape(-1)
        with self._lock:
            drop = {self._slot_of[int(i)] for i in ids.tolist()
                    if int(i) in self._slot_of}
            if not drop:
                return 0
            keep = np.ones(self._n, bool)
            keep[list(drop)] = False
            return self._compact_locked(keep)

    def save(self, path):
        """Atomic full dump with the optimizer state (tmp + fsync +
        rename: a crash mid-save can never leave a torn file the next
        load() trusts), round-tripped bit-exactly; the reference's
        ``load`` reads it."""
        with self._lock:
            state = self._row_state_locked(
                np.array(sorted(self._slot_of), np.int64))
        _dump_state_npz(path, self.dim, state)

    def load(self, path):
        p = str(path)
        data = np.load(p if p.endswith(".npz") else p + ".npz")
        ids = np.asarray(data["ids"], np.int64)
        state = {k: data[k] for k in data.files if k != "dim"}
        with self._lock:
            self._slot_of = {}
            self._n = 0
            self._vals = np.zeros((max(1024, len(ids)), self.dim),
                                  np.float32)
            self._m = self._v = self._t = None
            self._set_row_state_locked(ids, state)
            # a freshly-loaded table is wholly dirty: the next incremental
            # snapshot must capture everything it now holds
            self._dirty = set(self._slot_of)
            self._deleted = set()


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
