"""The host data feed's Python half (counterpart of
``paddle_tpu/native/__init__.py``): the MultiSlot slot schema, the
Python feed (``PyDataFeed``), the content-hash global shuffle, and the
CSR packers.

The reference also compiles a C++ feed (``native/src/data_feed.cc``,
channels and threaded parsing) and binds it with ctypes; it takes the
Python route wherever that library is not built
(``paddle_tpu/fluid/dataset.py``).  The C++ feed is not ported yet, so
``native_available()`` is False and every feed here is the Python one.
The record exchange of the cross-trainer global shuffle (the feeds'
``extract_shards`` / ``ingest``) comes with the PS RPC plane.

Batches come back as:
  sparse slot -> (ids int64 [total], lod int64 [batch+1])   (CSR)
  dense slot  -> float32 [batch, dim]
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def native_available() -> bool:
    """Whether the C++ feed is built.  Not ported yet: always False."""
    return False


class SlotDesc:
    """One slot of the MultiSlot schema (data_feed.proto analog)."""

    def __init__(self, name: str, is_dense: bool = False, dim: int = 1):
        self.name = name
        self.is_dense = is_dense
        self.dim = dim

    def _fmt(self):
        return f"{self.name}:{'dense' if self.is_dense else 'sparse'}:{self.dim}"


_U64 = (1 << 64) - 1


def _route_hash(sparse, dense) -> int:
    """Record -> rank routing hash, the reference's RouteHash (FNV-1a over
    sparse ids, dense float bits for dense-only records, murmur3
    finalizer), so processes of both packages route records alike."""
    import struct
    h = 1469598103934665603
    mixed = False
    for slot in sparse:
        for v in slot:
            h = ((h ^ (int(v) & _U64)) * 1099511628211) & _U64
            mixed = True
    if not mixed:
        for slot in dense:
            for f in slot:
                (bits,) = struct.unpack("<I", struct.pack("<f", f))
                h = ((h ^ bits) * 1099511628211) & _U64
    h ^= h >> 33
    h = (h * 0xFF51AFD7ED558CCD) & _U64
    h ^= h >> 33
    h = (h * 0xC4CEB9FE1A85EC53) & _U64
    h ^= h >> 33
    return h


class PyDataFeed:
    """The MultiSlot feed in Python (single-threaded)."""

    def __init__(self, slots: Sequence[SlotDesc], batch_size: int,
                 num_threads: int = 1):
        self.slots = list(slots)
        self.sparse_slots = [s for s in self.slots if not s.is_dense]
        self.dense_slots = [s for s in self.slots if s.is_dense]
        self.batch_size = batch_size
        self._files: List[str] = []
        self._pool: List[Tuple] = []
        self._iter = None

    def add_file(self, path):
        self._files.append(str(path))

    def set_filelist(self, paths):
        self._files.extend(str(p) for p in paths)

    def _parse(self, line):
        toks = line.split()
        pos = 0
        sparse, dense = [], []
        for s in self.slots:
            n = int(toks[pos]); pos += 1
            vals = toks[pos:pos + n]; pos += n
            if s.is_dense:
                v = [float(x) for x in vals][:s.dim]
                v += [0.0] * (s.dim - len(v))
                dense.append(v)
            else:
                sparse.append([int(x) for x in vals])
        return sparse, dense

    def _records(self):
        for f in self._files:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        yield self._parse(line)

    def load_into_memory(self):
        self._pool = list(self._records())
        return len(self._pool)

    def local_shuffle(self, seed=0):
        np.random.RandomState(seed).shuffle(self._pool)

    def start(self):
        self._iter = self._records()

    def start_from_memory(self):
        self._iter = iter(self._pool)

    @property
    def memory_size(self):
        return len(self._pool)

    def next(self):
        recs = []
        for r in self._iter:
            recs.append(r)
            if len(recs) >= self.batch_size:
                break
        if not recs:
            return None
        out = {}
        for i, s in enumerate(self.sparse_slots):
            ids, lod = [], [0]
            for sp, _ in recs:
                ids.extend(sp[i])
                lod.append(len(ids))
            out[s.name] = (np.asarray(ids, np.int64),
                           np.asarray(lod, np.int64))
        for i, s in enumerate(self.dense_slots):
            out[s.name] = np.asarray([d[i] for _, d in recs], np.float32)
        return out

    def __iter__(self):
        while True:
            b = self.next()
            if b is None:
                return
            yield b


def global_shuffle(feeds, seed=0):
    """GlobalShuffle across a list of feeds (data_set.h:118 analog):
    records are routed to feed ``hash(ids) % n``, then each feed's share
    is shuffled with seed ``seed + i`` — the reference's routing and seeds
    on its Python route."""
    pools = [f._pool for f in feeds]
    dest = [[] for _ in feeds]
    for pool in pools:
        for rec in pool:
            dest[_route_hash(rec[0], rec[1]) % len(feeds)].append(rec)
    for i, (f, d) in enumerate(zip(feeds, dest)):
        rng = np.random.RandomState(seed + i)
        rng.shuffle(d)
        f._pool = d


def make_data_feed(slots, batch_size, num_threads=4):
    """The feed for ``slots``: the Python feed (the C++ one is not
    ported)."""
    return PyDataFeed(slots, batch_size, num_threads)


__all__ = ["SlotDesc", "PyDataFeed", "make_data_feed", "native_available",
           "global_shuffle", "pack_padded", "pack_padded_csr"]


def pack_padded_csr(vals, offs, pad_value=0, max_len=None,
                    n_threads=None):
    """CSR (concatenated values + [n+1] offsets) -> (padded [N, T],
    lengths [N]), vectorized in numpy — no per-row Python objects.  This
    is the layout the native DataFeed's sparse slots and tokenized
    dataset storage already use, which is where batch packing is hot.
    n == 0 returns an empty [0, max_len or 0] batch.  ``n_threads`` is
    the reference's C++ packer's and unused here."""
    vals = np.ascontiguousarray(vals)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    if offs.ndim != 1 or offs.shape[0] < 1:
        raise ValueError("offsets must be a 1-D [n+1] array")
    n = offs.shape[0] - 1
    row_lens = np.diff(offs)
    if n and (row_lens < 0).any():
        raise ValueError("offsets must be non-decreasing")
    if n and int(offs[0]) < 0:
        raise ValueError("offsets must start at a non-negative index")
    if n and int(offs[-1]) > vals.size:
        raise ValueError(
            f"offsets end at {int(offs[-1])} but values has {vals.size} "
            f"entries")
    T = int(max_len if max_len is not None
            else (row_lens.max() if n else 0))
    lens = np.empty(n, np.int64)
    if n == 0:
        return np.empty((0, T), vals.dtype), lens
    # vectorized scatter through a [N, T] mask
    keep = np.minimum(row_lens, T)
    out = np.full((n, T), pad_value, vals.dtype)
    col = np.arange(T)[None, :]
    mask = col < keep[:, None]
    src_idx = offs[:-1, None] + col
    out[mask] = vals[src_idx[mask]]
    lens[:] = keep
    return out, lens


def pack_padded(seqs, pad_value=0, max_len=None, n_threads=None):
    """Pack a list of 1-D variable-length sequences into (padded [N, T],
    lengths [N]).  Convenience wrapper: builds the CSR form and delegates
    to pack_padded_csr (use the CSR entry point directly when data is
    already values+offsets — per-row Python objects dominate here).
    Sequences must share one dtype; mixed dtypes are rejected rather than
    silently coerced."""
    if not seqs:
        raise ValueError("pack_padded needs at least one sequence")
    arrs = [np.asarray(s).reshape(-1) for s in seqs]
    kind = arrs[0].dtype
    if any(a.dtype != kind for a in arrs):
        raise TypeError(
            f"pack_padded got mixed dtypes "
            f"{sorted({str(a.dtype) for a in arrs})}; cast upstream")
    vals = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
    offs = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([a.shape[0] for a in arrs], out=offs[1:])
    return pack_padded_csr(vals, offs, pad_value=pad_value,
                           max_len=max_len, n_threads=n_threads)
