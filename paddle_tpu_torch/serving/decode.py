"""Autoregressive decode serving: KV-cached continuous batching with
mid-flight join/leave, block-paged KV pools, prefix reuse and speculative
decoding.

Counterpart of ``paddle_tpu/serving/decode.py``.  A decode request is a
*sequence* of device steps with per-request state (the KV cache) that
stays on the card between steps; many requests share each step's batch
although they start and finish at different times (Orca-style
iteration-level scheduling).

* **Carried device state** — the decode step's K/V caches are scope vars
  declared in ``program._hints["carry_vars"]``: the executor reads them
  from the scope, writes them back after every run, never batch-slices
  them and never prunes their writes (fluid/executor.py).
* **Prefill vs decode buckets** — a joining request's prompt is padded
  to a *prefill bucket* (one program per prompt-length bucket), while the
  running batch steps at a *decode bucket* sized by
  ``bucket_for(live_slots)``.
* **Join/leave with masked exactness** — requests join the running batch
  at step boundaries and leave on EOS or length; per-position validity
  masks (``arange < cur_len`` folded into the scores, masked
  probabilities exactly 0.0) keep every live row's logits those of
  decoding the request alone.

``DecodeEngine(paged=True, prefix_cache=..., draft_model=...)`` adds
three tiers:

* **Block-paged KV** — K/V rows live in flat device pools ``[R, d]``
  carved into fixed-size pages; a slot owns ``ceil((prompt + new - 1) /
  page_size)`` pages and a carried slot → pool-row table (``pt``) tells
  the paged program where each position lives.  Occupancy, not
  ``max_len``, bounds concurrency; retirement returns pages in O(1);
  overload is a typed :class:`PagePoolExhaustedError` at admission.
  Page 0 is a scratch page that absorbs padding-row writes.  With the
  ``fuse_paged_attention`` pass applied to the paged program, each step's
  attention is one ``paged_attention`` op: on the card the hand-written
  paged-attention kernel (csrc/paged_attention.cu).
* **Prefix caching** — prompt prefixes are hashed at page granularity
  (exact token tuples, chained per page); a request whose prefix matches
  shares those pages from a refcounted warm pool and *replays* only the
  uncovered prompt tail through decode steps.  Eviction is LRU and never
  frees a page with live readers; ``release_prefix`` drops a prompt's
  pages at once (a session that moved to another replica).
* **Speculative decoding** — a cheap draft :class:`DecodeModel` (its own
  dense KV rows, in its own child scope) proposes up to ``spec_k - 1``
  tokens a round, and ONE target launch, the verify program of
  ``spec_k`` chained paged steps, scores them all; the proposals that
  match the target's argmax are accepted together.  Greedy speculative
  output is token-identical to plain paged decode: each verify block is
  the plain paged step at its position, op for op and shape for shape,
  and a proposal is consumed only after it matched.  With the
  ``fuse_paged_attention`` pass each block's attention is one
  ``paged_attention`` op, so a verify round launches the paged kernel
  ``spec_k`` times.  Each block rewrites the whole pool (the one-hot
  write), so a round moves about ``spec_k`` times a plain step's pool
  traffic.

The numerics contract the demo model keeps: per-row computation only, in
batch-size-stable spellings (the elementwise-mul + ``reduce_sum``
attention).  The paged data path keeps it: page writes are one-hot matmul
scatters, page reads are ``gather`` (exact copies), and masked positions
contribute exactly 0.0.  A float32 ``fc`` product need not round a row
alike at every batch size (cuBLAS and the host's BLAS pick kernels by the
row count, and the paged kernel splits a slot's positions by the batch
size), so batched and paged decode are held to ``decode_sequential``
with identical tokens and logits within a stated tolerance.

Every request has a ``trace_id`` (its future's); with tracing on the
engine emits ``decode::admit`` / ``prefill`` / ``step`` / ``spec_round``
/ ``finish`` events (host times), and the flight recorder keeps one wide
record per finished request.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..fluid import compile_cache, trace
from ..fluid import flight_recorder as _flight
from ..fluid.core import Scope
from ..fluid.executor import Executor
from .engine import (BaseFuture, EngineClosedError, FamilyInstruments,
                     PagePoolExhaustedError, QueueFullError, ServingError)

__all__ = [
    "DecodeModel", "DecodeEngine", "DecodeFuture", "DecodeRejectedError",
    "KVPagePool", "PrefixCache", "PagePoolExhaustedError",
    "build_demo_decode_model", "decode_sequential",
]

_STOP = object()
_NEG_BIG = 1e30          # masked-score magnitude: exp(-1e30 - max) == 0.0


class DecodeRejectedError(ServingError):
    """The request cannot be decoded (prompt/budget outside the model's
    ``max_len`` window, or the admission queue is full)."""


class DecodeFuture(BaseFuture):
    """One decode request's pending result.  ``result(timeout)`` returns
    ``{"tokens", "prompt_len", "finish_reason", "logits"?}`` — tokens is
    the generated id sequence (EOS included when hit).  ``trace_id`` is
    the request's causal identity."""

    __slots__ = ("trace_id",)

    _pending_msg = "decode request still pending"

    def __init__(self, trace_id: Optional[str] = None):
        super().__init__()
        self.trace_id = trace_id


# ---------------------------------------------------------------------------
# the page pool + prefix cache (host-side bookkeeping over device pages)
# ---------------------------------------------------------------------------

class KVPagePool:
    """Refcounted allocator over the device KV page pool.

    The device tensors (``k_pool``/``v_pool``, flat ``[n_pages *
    page_size, d]``) never move; this object only tracks which pages are
    free and how many readers hold each one.  Page 0 is reserved as the
    scratch page: padding batch rows write there, and page-table entries
    beyond a slot's allocation point there (always masked).  A page
    returns to the free list only when its LAST holder releases it, so
    prefix-shared pages survive their donor's retirement.
    """

    def __init__(self, n_pages: int, page_size: int):
        n_pages = int(n_pages)
        if n_pages < 2:
            raise ValueError("KVPagePool needs >= 2 pages "
                             "(page 0 is the reserved scratch page)")
        self.n_pages = n_pages
        self.page_size = int(page_size)
        self._free: List[int] = list(range(1, n_pages))   # LIFO reuse
        self._ref: List[int] = [0] * n_pages

    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` pages (refcount 1 each); a typed rejection when the
        pool cannot satisfy the request."""
        n = int(n)
        if n > len(self._free):
            raise PagePoolExhaustedError(
                f"need {n} KV pages, only {len(self._free)} free "
                f"of {self.usable_pages}")
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._ref[pid] = 1
        return out

    def incref(self, pid: int) -> None:
        if self._ref[pid] <= 0:
            raise ValueError(f"page {pid} is free; cannot share it")
        self._ref[pid] += 1

    def release(self, pid: int) -> None:
        r = self._ref[pid]
        if r <= 0:
            raise ValueError(f"double free of page {pid}")
        self._ref[pid] = r - 1
        if r == 1:
            self._free.append(pid)

    def refcount(self, pid: int) -> int:
        return self._ref[pid]


class PrefixCache:
    """Page-granular prompt-prefix cache with LRU eviction.

    Keys are EXACT token tuples ``tuple(prompt[:(j+1)*page_size])`` — one
    chained entry per fully covered prompt page, each mapping to the pool
    page that holds those positions' K/V rows.  ``lookup`` walks the
    chain from page 0 and stops at the first miss, touching every hit.
    ``evict`` scans oldest first and only frees pages whose sole
    remaining reference is the cache itself.  Only prefill-seeded pages
    are registered.
    """

    def __init__(self, pool: KVPagePool):
        self.pool = pool
        self._entries: "OrderedDict[tuple, int]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt) -> List[int]:
        ps = self.pool.page_size
        toks = [int(t) for t in prompt]
        out: List[int] = []
        j = 0
        while (j + 1) * ps <= len(toks):
            key = tuple(toks[:(j + 1) * ps])
            pid = self._entries.get(key)
            if pid is None:
                break
            self._entries.move_to_end(key)
            out.append(pid)
            j += 1
        return out

    def register(self, prompt, pages: Sequence[int]) -> int:
        """Adopt the fully prompt-covered prefix pages of a freshly
        prefilled slot (one extra refcount per adopted page)."""
        ps = self.pool.page_size
        toks = [int(t) for t in prompt]
        j, added = 0, 0
        while (j + 1) * ps <= len(toks) and j < len(pages):
            key = tuple(toks[:(j + 1) * ps])
            if key not in self._entries:
                self.pool.incref(pages[j])
                self._entries[key] = pages[j]
                added += 1
            else:
                self._entries.move_to_end(key)
            j += 1
        return added

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` cache-only pages, oldest entry first.
        Returns how many pages went back to the pool."""
        freed = 0
        for key in list(self._entries.keys()):
            if freed >= n_pages:
                break
            pid = self._entries[key]
            if self.pool.refcount(pid) == 1:
                del self._entries[key]
                self.pool.release(pid)
                freed += 1
        return freed

    def drop(self, prompt) -> int:
        """Release every chain entry covering a prefix of ``prompt``: a
        session that moved to another replica leaves pages here with no
        future reader.  A page a live slot still holds loses only the
        cache's reference (the slot's retirement returns it).  Returns
        how many pages went back to the pool now."""
        ps = self.pool.page_size
        toks = [int(t) for t in prompt]
        freed = 0
        j = 0
        while (j + 1) * ps <= len(toks):
            key = tuple(toks[:(j + 1) * ps])
            pid = self._entries.pop(key, None)
            if pid is None:
                break
            if self.pool.refcount(pid) == 1:
                freed += 1
            self.pool.release(pid)
            j += 1
        return freed


# ---------------------------------------------------------------------------
# the model contract
# ---------------------------------------------------------------------------

# one lock for ALL lazy program builds: program construction runs under
# fluid.program_guard, whose default-program switch is a module global.
# Reentrant, so a model's builder may build through another model (a
# paged_builder that wraps the demo model's paged_program)
_BUILD_LOCK = threading.RLock()


class DecodeModel:
    """The program family a DecodeEngine drives.

    * ``decode_program`` — ONE step for the whole running batch (dense
      KV).  Feeds ``tok [B,1] int64`` (previous token per slot),
      ``posi [B,1] int64`` / ``pos [B,1] float32`` (the position this
      step writes = current length), ``arange [1, max_len] float32``.
      Carries (hint ``carry_vars``) the KV caches ``k_cache``/``v_cache``
      ``[B, max_len, d]`` as scope vars.  Fetches next-token logits
      ``[B, vocab]``.
    * ``prefill_program(s_p)`` — consume a prompt padded to the
      prompt-length bucket ``s_p``: feeds ``prompt [B, s_p] int64``,
      ``lastpos [B,1] int64``, ``plen [B,1] float32``, ``arange_p [1,
      max_len] float32``; fetches first-token logits and the initial KV
      rows ``[B, max_len, d]``.  It attends over the full ``max_len``
      window so its logits are spelled like a decode step's: a
      prefix-cache hit's first emission (from a decode step) matches a
      miss's (from prefill).
    * ``paged_program(pool_rows)`` — ONE step over the flat paged pools
      (built by ``paged_builder``): feeds ``tok``, ``widx [B,1] int64``
      (the pool row this step writes), ``pos``, ``arange``; reads the
      carried ``k_pool``/``v_pool`` ``[pool_rows, d]`` and the seeded page
      table ``pt [B, max_len] int32``.  Returns ``(program,
      logits_name)``.
    * ``verify_program(pool_rows, k)`` — ``k`` chained paged steps in one
      program, for speculative verification (built by
      ``verify_builder``): feeds ``toks [B, k]`` / ``widx [B, k] int64``,
      ``pos [B, 1]`` (the first block's position) and ``arange``; block
      j writes row ``widx[:, j]`` and attends over positions ``<= pos +
      j``.  Returns ``(program, [logits_name per block])``.

    All programs share their weights through one scope; the engine runs
    them in a CHILD scope so several engines (batched and the sequential
    reference) share parameters without sharing KV state.  Custom models
    plug in by constructing this class directly with the same feed/fetch
    names — for example a ``paged_builder`` that returns the demo's paged
    program after the ``fuse_paged_attention`` pass, which puts each
    step's attention on the paged-attention kernel.
    """

    def __init__(self, executor: Executor, scope, decode_program,
                 logits_name: str, vocab: int, d_model: int, max_len: int,
                 prefill_builder: Callable[[int], tuple],
                 k_name: str = "k_cache", v_name: str = "v_cache",
                 paged_builder: Optional[Callable[[int], tuple]] = None,
                 page_size: Optional[int] = None,
                 k_pool_name: str = "k_pool", v_pool_name: str = "v_pool",
                 pt_name: str = "pt",
                 verify_builder: Optional[Callable[[int, int], tuple]] = None):
        self.executor = executor
        self.scope = scope
        self.decode_program = decode_program
        self.logits_name = logits_name
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.max_len = int(max_len)
        self.k_name = k_name
        self.v_name = v_name
        self.page_size = int(page_size) if page_size else None
        self.k_pool_name = k_pool_name
        self.v_pool_name = v_pool_name
        self.pt_name = pt_name
        self._prefill_builder = prefill_builder
        self._paged_builder = paged_builder
        self._verify_builder = verify_builder
        self._prefill: Dict[int, tuple] = {}
        self._paged: Dict[int, tuple] = {}
        self._verify: Dict[tuple, tuple] = {}
        self._lock = _BUILD_LOCK

    def prefill_program(self, s_p: int):
        """(program, logits_name, k_init_name, v_init_name) for prompt
        bucket ``s_p`` — built lazily, one program per bucket."""
        s_p = int(s_p)
        with self._lock:
            entry = self._prefill.get(s_p)
            if entry is None:
                entry = self._prefill[s_p] = self._prefill_builder(s_p)
            return entry

    def paged_program(self, pool_rows: int):
        """(program, logits_name) for the one-step paged decode over a
        ``[pool_rows, d]`` pool — lazy, one program per pool size (the
        one-hot write depth bakes ``pool_rows`` in)."""
        if self._paged_builder is None:
            raise ValueError("this DecodeModel has no paged_builder; "
                             "paged decode is unavailable")
        key = int(pool_rows)
        with self._lock:
            entry = self._paged.get(key)
            if entry is None:
                entry = self._paged[key] = self._paged_builder(key)
            return entry

    def verify_program(self, pool_rows: int, k: int):
        """(program, [logits_name per block]) of ``k`` chained paged
        steps over a ``[pool_rows, d]`` pool — lazy, one program per
        (pool size, k)."""
        if self._verify_builder is None:
            raise ValueError("this DecodeModel has no verify_builder; "
                             "speculative decode is unavailable")
        key = (int(pool_rows), int(k))
        with self._lock:
            entry = self._verify.get(key)
            if entry is None:
                entry = self._verify[key] = self._verify_builder(*key)
            return entry


def build_demo_decode_model(vocab: int = 32, d_model: int = 16,
                            max_len: int = 24, seed: int = 0,
                            executor: Optional[Executor] = None,
                            scope=None, page_size: int = 4) -> DecodeModel:
    """A single-layer attention LM over the static IR — the decode demo
    model.  One embedding, shared Q/K/V projections and an output head;
    the attention uses the batch-size-stable mul+reduce_sum spelling.
    Besides the dense decode/prefill pair it supplies the paged one-step
    and speculative verify builders over the same weights.  ``executor``
    defaults to ``Executor()``, the card."""
    from .. import fluid
    from ..fluid import layers as L
    from ..fluid.param_attr import ParamAttr

    executor = executor or Executor()
    scope = scope if scope is not None else Scope()
    scale = float(d_model) ** -0.5
    page_size = int(page_size)
    if page_size < 1 or max_len % page_size:
        raise ValueError(f"page_size {page_size} must divide "
                         f"max_len={max_len}")

    def proj(x, which, flatten=1):
        return L.fc(x, d_model, num_flatten_dims=flatten,
                    param_attr=ParamAttr(name=f"dec_w{which}"),
                    bias_attr=ParamAttr(name=f"dec_b{which}"))

    def head(h):
        return L.fc(h, vocab, param_attr=ParamAttr(name="dec_wo"),
                    bias_attr=ParamAttr(name="dec_bo"))

    def attend(q, k, v, valid):
        # mul+reduce_sum spelling: per-row accumulation order is
        # independent of the batch size (a batched 3-D matmul is not)
        s = L.reduce_sum(k * L.unsqueeze(q, [1]), dim=[2])      # [B, S]
        s = L.scale(s, scale=scale)
        s = s * valid + L.scale(valid, scale=_NEG_BIG, bias=-_NEG_BIG)
        p = L.softmax(s)        # masked positions underflow to exact 0.0
        return L.reduce_sum(v * L.unsqueeze(p, [2]), dim=[1])   # [B, d]

    def embed_tok(tok):
        return L.squeeze(L.embedding(tok, size=[vocab, d_model],
                                     param_attr=ParamAttr(name="dec_emb")),
                         [1])                                    # [B, d]

    def pool_write(kp, vp, widx, k_new, v_new, pool_rows):
        # one-hot matmul scatter into the flat pool: written rows get
        # exactly k_new (keep == 0 there), untouched rows are exact
        # (keep == 1, the scatter adds +-0.0).  relu clamps keep at 0 when
        # several padding rows pile onto the scratch page; without it
        # keep = 1 - n_writers would grow the scratch row geometrically
        # until it overflowed and poisoned the masked softmax
        ohw = L.one_hot(widx, pool_rows)                        # [B, R]
        wsum = L.unsqueeze(L.reduce_sum(ohw, dim=[0]), [1])     # [R, 1]
        keep = L.relu(L.scale(wsum, scale=-1.0, bias=1.0))
        k_upd = kp * keep + L.matmul(ohw, k_new, transpose_x=True)
        v_upd = vp * keep + L.matmul(ohw, v_new, transpose_x=True)
        return k_upd, v_upd

    # -- the decode-step program (all params live here; its startup is
    # the one that runs) ----------------------------------------------------
    dec, dec_startup = fluid.Program(), fluid.Program()
    dec.random_seed = seed
    dec_startup.random_seed = seed
    with fluid.program_guard(dec, dec_startup):
        tok = fluid.data("tok", [-1, 1], dtype="int64")
        posi = fluid.data("posi", [-1, 1], dtype="int64")
        pos = fluid.data("pos", [-1, 1], dtype="float32")
        ar = fluid.data("arange", [1, max_len], dtype="float32")
        k_cache = fluid.data("k_cache", [-1, max_len, d_model])
        v_cache = fluid.data("v_cache", [-1, max_len, d_model])
        x = embed_tok(tok)
        q, k_new, v_new = proj(x, "q"), proj(x, "k"), proj(x, "v")
        oh3 = L.unsqueeze(L.one_hot(posi, max_len), [2])         # [B,S,1]
        keep = L.scale(oh3, scale=-1.0, bias=1.0)
        k_upd = k_cache * keep + L.unsqueeze(k_new, [1]) * oh3
        v_upd = v_cache * keep + L.unsqueeze(v_new, [1]) * oh3
        # carried writes: the executor hands the updated caches back to
        # the scope (carry_vars below)
        L.assign(k_upd, output=k_cache)
        L.assign(v_upd, output=v_cache)
        valid = L.cast(L.less_than(ar, L.scale(pos, bias=1.0)), "float32")
        logits = head(attend(q, k_upd, v_upd, valid) + x)        # [B, V]
    dec._hints["is_test"] = True
    dec._hints["shape_bucketing"] = False    # the engine pads slots itself
    dec._hints["carry_vars"] = ("k_cache", "v_cache")
    dec._hints["feed_names"] = ["tok", "posi", "pos", "arange"]
    dec._hints["fetch_names"] = [logits.name]
    executor.run(dec_startup, scope=scope)

    # -- prefill programs, one per prompt-length bucket ----------------------
    def build_prefill(s_p: int):
        if not 0 < s_p < max_len:
            raise ValueError(f"prefill bucket {s_p} must sit inside "
                             f"max_len={max_len} (decode needs headroom)")
        pf, pf_startup = fluid.Program(), fluid.Program()
        pf.random_seed = seed
        with fluid.program_guard(pf, pf_startup):
            prompt = fluid.data("prompt", [-1, s_p], dtype="int64")
            lastpos = fluid.data("lastpos", [-1, 1], dtype="int64")
            plen = fluid.data("plen", [-1, 1], dtype="float32")
            arp = fluid.data("arange_p", [1, max_len], dtype="float32")
            x = L.embedding(prompt, size=[vocab, d_model],
                            param_attr=ParamAttr(name="dec_emb"))
            k = proj(x, "k", flatten=2)                    # [B, s_p, d]
            v = proj(x, "v", flatten=2)
            oh = L.unsqueeze(L.one_hot(lastpos, s_p), [2])  # [B, s_p, 1]
            x_last = L.reduce_sum(x * oh, dim=[1])          # [B, d]
            q = proj(x_last, "q")
            zpad = L.fill_constant_batch_size_like(
                k, [-1, max_len - s_p, d_model], "float32", 0.0)
            k_init = L.concat([k, zpad], axis=1)            # [B, S, d]
            v_init = L.concat([v, zpad], axis=1)
            # attend over the FULL max_len window (padding masked to
            # exact 0.0) so the prefill logits are spelled like a decode
            # step's at the same position
            valid = L.cast(L.less_than(arp, plen), "float32")
            logits = head(attend(q, k_init, v_init, valid) + x_last)
        pf._hints["is_test"] = True
        pf._hints["shape_bucketing"] = False
        pf._hints["feed_names"] = ["prompt", "lastpos", "plen", "arange_p"]
        pf._hints["fetch_names"] = [logits.name, k_init.name, v_init.name]
        return pf, logits.name, k_init.name, v_init.name

    # -- the paged one-step program, one per pool size -----------------------
    def build_paged(pool_rows: int):
        pg, pg_startup = fluid.Program(), fluid.Program()
        pg.random_seed = seed
        with fluid.program_guard(pg, pg_startup):
            tok = fluid.data("tok", [-1, 1], dtype="int64")
            widx = fluid.data("widx", [-1, 1], dtype="int64")
            pos = fluid.data("pos", [-1, 1], dtype="float32")
            ar = fluid.data("arange", [1, max_len], dtype="float32")
            pt = fluid.data("pt", [-1, max_len], dtype="int32")
            # concrete pool extent: the pool is never batch-sliced and one
            # program exists per pool size anyway
            k_pool = fluid.data("k_pool", [pool_rows, d_model])
            v_pool = fluid.data("v_pool", [pool_rows, d_model])
            x = embed_tok(tok)
            q, k_new, v_new = proj(x, "q"), proj(x, "k"), proj(x, "v")
            k_upd, v_upd = pool_write(k_pool, v_pool, widx,
                                      k_new, v_new, pool_rows)
            L.assign(k_upd, output=k_pool)
            L.assign(v_upd, output=v_pool)
            # page-table gather: exact row copies out of the pool, so the
            # attend sees the values a dense cache would hold
            pti = L.reshape(pt, [-1])
            kg = L.reshape(L.gather(k_upd, pti), [-1, max_len, d_model])
            vg = L.reshape(L.gather(v_upd, pti), [-1, max_len, d_model])
            valid = L.cast(L.less_than(ar, L.scale(pos, bias=1.0)),
                           "float32")
            logits = head(attend(q, kg, vg, valid) + x)
        pg._hints["is_test"] = True
        pg._hints["shape_bucketing"] = False
        pg._hints["carry_vars"] = ("k_pool", "v_pool")
        pg._hints["feed_names"] = ["tok", "widx", "pos", "arange"]
        pg._hints["fetch_names"] = [logits.name]
        # the fuse_paged_attention pass stamps the page size on the op
        pg._hints["kv_page_size"] = page_size
        return pg, logits.name

    # -- the speculative verify program: k chained paged steps ---------------
    def build_verify(pool_rows: int, k_steps: int):
        vp_, vp_startup = fluid.Program(), fluid.Program()
        vp_.random_seed = seed
        with fluid.program_guard(vp_, vp_startup):
            toks = fluid.data("toks", [-1, k_steps], dtype="int64")
            widx = fluid.data("widx", [-1, k_steps], dtype="int64")
            pos = fluid.data("pos", [-1, 1], dtype="float32")
            ar = fluid.data("arange", [1, max_len], dtype="float32")
            pt = fluid.data("pt", [-1, max_len], dtype="int32")
            k_pool = fluid.data("k_pool", [pool_rows, d_model])
            v_pool = fluid.data("v_pool", [pool_rows, d_model])
            pti = L.reshape(pt, [-1])
            kcur, vcur = k_pool, v_pool
            names = []
            for j in range(k_steps):
                tj = L.slice(toks, axes=[1], starts=[j], ends=[j + 1])
                wj = L.slice(widx, axes=[1], starts=[j], ends=[j + 1])
                x = embed_tok(tj)
                q, kn, vn = proj(x, "q"), proj(x, "k"), proj(x, "v")
                kcur, vcur = pool_write(kcur, vcur, wj, kn, vn, pool_rows)
                kg = L.reshape(L.gather(kcur, pti), [-1, max_len, d_model])
                vg = L.reshape(L.gather(vcur, pti), [-1, max_len, d_model])
                # block j's window is positions <= pos + j: the float adds
                # are exact small integers, so this is the one-step mask
                # at position pos + j bit for bit
                valid = L.cast(
                    L.less_than(ar, L.scale(pos, bias=float(j + 1))),
                    "float32")
                lg = head(attend(q, kg, vg, valid) + x)
                names.append(lg.name)
            L.assign(kcur, output=k_pool)
            L.assign(vcur, output=v_pool)
        vp_._hints["is_test"] = True
        vp_._hints["shape_bucketing"] = False
        vp_._hints["carry_vars"] = ("k_pool", "v_pool")
        vp_._hints["feed_names"] = ["toks", "widx", "pos", "arange"]
        vp_._hints["fetch_names"] = list(names)
        vp_._hints["kv_page_size"] = page_size
        return vp_, names

    return DecodeModel(executor, scope, dec, logits.name, vocab, d_model,
                       max_len, build_prefill, paged_builder=build_paged,
                       verify_builder=build_verify, page_size=page_size)


# ---------------------------------------------------------------------------
# per-engine decode.* instruments (the shared serving-family bundle)
# ---------------------------------------------------------------------------

class _DecodeInstruments(FamilyInstruments):
    COUNTERS = ("requests", "rejected", "joins", "leaves", "tokens",
                "steps", "prefills", "prefix_hits", "prefix_evictions",
                "prefix_drops", "spec_proposed", "spec_accepted")
    HISTOGRAMS = ("ttft_seconds", "step_seconds", "request_seconds",
                  "batch_occupancy")

    def __init__(self, name: Optional[str] = None):
        super().__init__("decode", self.COUNTERS, self.HISTOGRAMS,
                         ("active_slots", "queue_depth", "kv_pages_in_use",
                          "kv_page_pool_free"), name)

    def set_active(self, v):
        self.set_gauge("active_slots", v)

    def set_queue_depth(self, v):
        self.set_gauge("queue_depth", v)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class _Slot:
    __slots__ = ("req", "pos", "last_token", "k_row", "v_row", "tokens",
                 "logits", "t_submit", "t_first", "plen", "pages",
                 "d_k_row", "d_v_row")

    def __init__(self, req):
        self.req = req
        self.pos = 0            # current length = position the next step writes
        self.last_token = 0
        self.k_row = None       # [max_len, d] device rows, valid at sync points
        self.v_row = None
        self.plen = int(req.prompt.size)
        self.pages: List[int] = []   # owned pool pages (paged mode)
        self.d_k_row = None     # the draft model's dense KV rows
        self.d_v_row = None
        self.tokens: List[int] = []
        self.logits: List[np.ndarray] = []
        self.t_submit = req.t_submit
        self.t_first = None


class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "eos_id", "future", "trace_id",
                 "t_submit")

    def __init__(self, prompt, max_new, eos_id, future, trace_id):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.future = future
        self.trace_id = trace_id
        self.t_submit = time.monotonic()


class DecodeEngine:
    """Iteration-level scheduler over a :class:`DecodeModel`.

    ::

        model = decode.build_demo_decode_model(vocab=64, max_len=32)
        with decode.DecodeEngine(model, max_batch=8) as eng:
            fut = eng.submit([3, 7, 1], max_new_tokens=8, eos_id=0)
            out = fut.result(timeout=30)   # {"tokens": [...], ...}

    One loop thread owns the running batch: it admits queued requests
    into free slots at step boundaries (prefill per prompt bucket), runs
    one decode step for every live slot, emits a token per live request,
    and retires finished requests.  The KV state lives in a CHILD scope
    of the model scope as carried device state (``carry_vars``); dense
    mode re-packs the live rows on the device at membership changes.

    ``paged=True`` swaps the dense per-slot caches for the block-paged
    pool: admission reserves ``ceil((prompt + max_new - 1)/page_size)``
    pages (a transient shortage parks the request in a pending FIFO
    retried every iteration; a request that can NEVER fit raises
    :class:`PagePoolExhaustedError` at submit), membership changes re-seed
    only the int32 page table, and retirement returns pages in O(1).
    ``prefix_cache=True`` adds the page-granular prompt prefix cache;
    ``draft_model=`` adds speculative decoding with ``spec_k`` positions
    verified per target launch (token-identical to plain paged decode).

    ``close()`` is a planned drain: queued and live requests finish, then
    the loop exits — no accepted request is lost.
    """

    def __init__(self, model: DecodeModel, max_batch: int = 8,
                 batch_edges=None, prefill_edges=None,
                 queue_depth: int = 64, collect_logits: bool = False,
                 name: Optional[str] = None, auto_start: bool = True,
                 paged: bool = False, page_size: Optional[int] = None,
                 pool_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 draft_model: Optional[DecodeModel] = None,
                 spec_k: int = 4):
        self.model = model
        self.max_batch = int(max_batch)
        self.batch_edges = compile_cache.normalize_edges(
            batch_edges or compile_cache.pow2_edges(self.max_batch))
        default_pf = [e for e in compile_cache.pow2_edges(model.max_len)
                      if e < model.max_len] or [model.max_len - 1]
        self.prefill_edges = compile_cache.normalize_edges(
            prefill_edges or default_pf)
        bad = [e for e in self.prefill_edges if e >= model.max_len]
        if bad:
            raise ValueError(f"prefill edges {bad} leave no decode "
                             f"headroom inside max_len={model.max_len}")
        self.queue_depth = int(queue_depth)
        self.collect_logits = bool(collect_logits)
        self.name = name
        self._ins = _DecodeInstruments(name)
        # KV state lives in a child scope: parameters resolve through the
        # parent (shared with every engine over this model), carried
        # state stays private per engine
        self._scope = Scope(parent=model.scope)
        self._device = model.executor.device
        self._arange = np.arange(model.max_len, dtype=np.float32)[None, :]
        self._q: "queue.Queue" = queue.Queue(maxsize=self.queue_depth)
        self._slots: List[_Slot] = []
        self._pending: "deque[_DecodeRequest]" = deque()
        self._admitting: List[_DecodeRequest] = []
        self._cap = 0
        self._dirty = False
        self._closed = False
        self._started = False
        self._peak_active = 0
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._auto_start = bool(auto_start)
        # prefix drops asked for by other threads, applied by the loop
        # (the pool's one mutator) between steps
        self._drops: "deque" = deque()

        # -- paged / prefix / speculative tiers ------------------------------
        self.paged = bool(paged)
        if (prefix_cache or draft_model is not None) and not self.paged:
            raise ValueError("prefix_cache / draft_model require paged=True")
        self._pool: Optional[KVPagePool] = None
        self._prefix: Optional[PrefixCache] = None
        self._draft = draft_model
        self.page_size = 0
        self.spec_k = 0
        if self.paged:
            ps = int(page_size or model.page_size or 4)
            if ps < 1 or model.max_len % ps:
                raise ValueError(f"page_size {ps} must divide "
                                 f"max_len={model.max_len}")
            self.page_size = ps
            per_seq = model.max_len // ps
            self.pool_pages = int(pool_pages
                                  or self.max_batch * per_seq + 1)
            if self.pool_pages < 2:
                raise ValueError("pool_pages must be >= 2 "
                                 "(page 0 is scratch)")
            self._pool = KVPagePool(self.pool_pages, ps)
            self._pool_rows = self.pool_pages * ps
            if prefix_cache:
                self._prefix = PrefixCache(self._pool)
            # two tensors, not one: admission writes the pools in place
            for nm in (model.k_pool_name, model.v_pool_name):
                self._scope.set_var(nm, torch.zeros(
                    (self._pool_rows, model.d_model), dtype=torch.float32,
                    device=self._device))
        if draft_model is not None:
            if (draft_model.max_len != model.max_len
                    or draft_model.vocab != model.vocab):
                raise ValueError(
                    "draft model must share max_len and vocab with the "
                    f"target (draft {draft_model.max_len}/"
                    f"{draft_model.vocab} vs {model.max_len}/{model.vocab})")
            self.spec_k = max(2, int(spec_k))
            # the draft's dense KV rows live in its own child scope
            self._draft_scope = Scope(parent=draft_model.scope)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DecodeEngine":
        with self._lock:
            if self._started or self._closed:
                return self
            self._started = True
            self._thread = threading.Thread(target=self._loop,
                                            name="decode-loop", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Planned drain: finish everything queued and live, then stop."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            started = self._started
        if started:
            self._q.put(_STOP)
            self._thread.join()
        else:
            while True:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    break
                if req is not _STOP:
                    req.future._reject(EngineClosedError(
                        "decode engine closed before its loop started"))

    def __enter__(self):
        return self.start()

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    # -- admission -----------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               eos_id: Optional[int] = None,
               trace_id: Optional[str] = None) -> DecodeFuture:
        if self._closed:
            raise EngineClosedError("DecodeEngine is closed")
        if not self._started and self._auto_start:
            self.start()
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        max_new = int(max_new_tokens)
        if prompt.size < 1 or max_new < 1:
            raise DecodeRejectedError(
                "decode needs a non-empty prompt and max_new_tokens >= 1")
        if prompt.size > max(self.prefill_edges):
            raise DecodeRejectedError(
                f"prompt of {prompt.size} tokens exceeds the largest "
                f"prefill bucket {max(self.prefill_edges)}")
        if prompt.size + max_new > self.model.max_len:
            raise DecodeRejectedError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) "
                f"exceeds the model's KV window max_len="
                f"{self.model.max_len}")
        # an id outside the embedding table would fail the whole prefill
        # batch (and on the card lose the process's CUDA context), so it
        # is refused here, for this request alone
        if prompt.min() < 0 or prompt.max() >= self.model.vocab:
            raise DecodeRejectedError(
                f"prompt ids must lie in [0, {self.model.vocab}), got "
                f"{int(prompt.min())} .. {int(prompt.max())}")
        if self.paged:
            # a static impossibility is a typed rejection NOW; a transient
            # shortage is not — those requests park in the pending FIFO
            need = -(-(int(prompt.size) + max_new - 1) // self.page_size)
            if need > self._pool.usable_pages:
                self._ins.count("rejected")
                raise PagePoolExhaustedError(
                    f"request needs {need} KV pages but the pool only "
                    f"has {self._pool.usable_pages} "
                    f"(page_size={self.page_size})")
        # an explicit or ambient id wins; a fresh "dec-" id otherwise
        trace_id = (trace_id or trace.current_trace_id()
                    or trace.new_trace_id("dec"))
        fut = DecodeFuture(trace_id=trace_id)
        req = _DecodeRequest(prompt, max_new, eos_id, fut, trace_id)
        with self._lock:
            if self._closed:
                raise EngineClosedError("DecodeEngine is closed")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self._ins.count("rejected")
                exc = QueueFullError(
                    f"decode admission queue full ({self.queue_depth})")
                fut._reject(exc)
                raise exc
        self._ins.count("requests")
        self._ins.set_queue_depth(self._q.qsize() + len(self._pending))
        if trace.enabled():
            trace.instant("decode::admit", cat="serving",
                          args={"trace_id": trace_id,
                                "prompt_len": int(prompt.size),
                                "max_new": max_new})
        return fut

    def generate(self, prompt, max_new_tokens: int = 16,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        """Blocking convenience: submit + result."""
        return self.submit(prompt, max_new_tokens, eos_id).result(timeout)

    def release_prefix(self, prompt, timeout: float = 5.0) -> int:
        """Drop the prefix-cache pages that ``prompt`` seeded: a session
        moved to another replica leaves them with no future reader, so
        they go back now instead of under LRU pressure.  The loop applies
        the drop between steps; returns the pages returned to the pool
        (0 without a prefix cache)."""
        if self._prefix is None:
            return 0
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        done = threading.Event()
        box = {"freed": 0}
        with self._lock:
            if self._closed:
                return 0
            started = self._started
            self._drops.append((prompt, box, done))
        if not started:
            # no loop yet: this thread is the pool's only mutator
            self._process_drops()
            return box["freed"]
        done.wait(timeout)
        return box["freed"]

    def _process_drops(self) -> None:
        while True:
            with self._lock:
                if not self._drops:
                    return
                prompt, box, done = self._drops.popleft()
            freed = self._prefix.drop(prompt)
            if freed:
                self._ins.count("prefix_drops", freed)
                self._update_page_gauges()
            box["freed"] = freed
            done.set()

    # -- the loop ------------------------------------------------------------
    def _loop(self) -> None:
        try:
            self._loop_inner()
        except BaseException as exc:    # noqa: BLE001 — resolved, never
            self._abort(exc)            # a stranded client

    def _abort(self, exc: BaseException) -> None:
        """A loop-level failure (a device fault, a refused launch) reaches
        every waiting client: live slots, pending and queued requests are
        rejected with it, and the engine is marked closed."""
        with self._lock:
            self._closed = True
        for s in self._slots:
            s.req.future._reject(exc)
        self._slots = []
        for r in list(self._pending):
            r.future._reject(exc)
        self._pending.clear()
        # the batch _admit_ready was seating when the failure came
        for r in self._admitting:
            if not r.future.done():
                r.future._reject(exc)
        self._admitting = []
        self._ins.set_active(0)
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                item.future._reject(exc)

    def _loop_inner(self) -> None:
        stop_seen = False
        while True:
            if self._drops:
                self._process_drops()
            joins = self._gather_joins()
            if joins and joins[-1] is _STOP:
                stop_seen = True
                joins = joins[:-1]
            ready = self._take_admittable(joins)
            if ready:
                self._admit_ready(ready)
            if not self._slots:
                # _STOP is enqueued AFTER _closed flips, so once seen no
                # further request can be behind it
                if stop_seen and not self._pending:
                    return
                if not joins and not self._pending:
                    try:
                        item = self._q.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    if item is _STOP:
                        stop_seen = True
                        continue
                    ready = self._take_admittable([item])
                    if ready:
                        self._admit_ready(ready)
                if not self._slots:
                    if self._pending and not ready:
                        time.sleep(0.005)
                    continue
            self._step()

    def _gather_joins(self):
        """Drain queued requests up to the free slot budget; _STOP rides
        through as a trailing marker."""
        out: List[Any] = []
        free = self.max_batch - len(self._slots) - len(self._pending)
        while free > 0:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _STOP:
                out.append(_STOP)
                break
            out.append(item)
            free -= 1
        self._ins.set_queue_depth(self._q.qsize() + len(self._pending))
        return out

    def _take_admittable(self, reqs):
        """Dense mode: pass-through.  Paged mode: append to the pending
        FIFO, then pop head-of-line requests whose page reservation
        succeeds (strict FIFO: a stuck head blocks later requests, so
        admission never starves it)."""
        if not self.paged:
            return list(reqs)
        self._pending.extend(reqs)
        ready = []
        while self._pending \
                and len(self._slots) + len(ready) < self.max_batch:
            plan = self._reserve(self._pending[0])
            if plan is None:
                break
            ready.append((self._pending.popleft(), plan))
        self._ins.set_queue_depth(self._q.qsize() + len(self._pending))
        return ready

    def _reserve(self, req) -> Optional[Dict[str, List[int]]]:
        """Reserve the request's pages: shared prefix pages are increffed
        FIRST (so eviction cannot free them under us), then the fresh
        remainder is allocated, evicting cache-only pages if the free
        list is short.  None (with the increfs undone) when the pool
        cannot cover it yet."""
        ps = self.page_size
        n = int(req.prompt.size)
        total = -(-(n + req.max_new - 1) // ps)
        shared: List[int] = []
        if self._prefix is not None:
            # keep at least the last prompt token out of the shared
            # region: the joiner replays >= 1 tail token through a decode
            # step to produce its first logits
            hits = self._prefix.lookup(req.prompt)[:(n - 1) // ps]
            for pid in hits:
                self._pool.incref(pid)
            shared = hits
        need = total - len(shared)
        if need > self._pool.free_pages and self._prefix is not None:
            freed = self._prefix.evict(need - self._pool.free_pages)
            if freed:
                self._ins.count("prefix_evictions", freed)
        if need > self._pool.free_pages:
            for pid in shared:
                self._pool.release(pid)
            return None
        fresh = self._pool.alloc(need)
        if shared:
            self._ins.count("prefix_hits", len(shared))
        return {"shared": shared, "fresh": fresh}

    def _admit_ready(self, ready) -> None:
        # held until the batch is seated, so _abort reaches it if the
        # prefill raises (paged mode's items are (request, page plan))
        self._admitting = [p[0] for p in ready] if self.paged \
            else list(ready)
        if self.paged:
            self._admit_paged(ready)
        else:
            self._admit(ready)
        self._admitting = []

    # -- join (prefill) ------------------------------------------------------
    def _admit(self, reqs: List[_DecodeRequest]) -> None:
        groups: Dict[int, List[_DecodeRequest]] = {}
        for r in reqs:
            s_p = compile_cache.bucket_for(int(r.prompt.size),
                                           self.prefill_edges)
            groups.setdefault(s_p, []).append(r)
        for s_p in sorted(groups):
            self._prefill(s_p, groups[s_p])

    def _prefill_feed(self, s_p: int, reqs) -> Dict[str, np.ndarray]:
        batch = compile_cache.bucket_for(len(reqs), self.batch_edges)
        prompt = np.zeros((batch, s_p), dtype=np.int64)
        plen = np.ones((batch, 1), dtype=np.float32)
        lastpos = np.zeros((batch, 1), dtype=np.int64)
        for i, r in enumerate(reqs):
            n = int(r.prompt.size)
            prompt[i, :n] = r.prompt
            plen[i, 0] = float(n)
            lastpos[i, 0] = n - 1
        return {"prompt": prompt, "lastpos": lastpos, "plen": plen,
                "arange_p": self._arange}

    def _run_prefill(self, s_p: int, reqs):
        """(host logits [batch, V], device K rows, device V rows)."""
        model = self.model
        prog, logits_n, k_n, v_n = model.prefill_program(s_p)
        feed = self._prefill_feed(s_p, reqs)
        _t0 = trace.now() if trace.enabled() else 0
        t0 = time.perf_counter()
        logits, k_init, v_init = model.executor.run(
            prog, feed=feed, fetch_list=[logits_n, k_n, v_n],
            scope=self._scope, return_numpy=False)
        logits, k_init, v_init = logits.numpy(), k_init.raw, v_init.raw
        self._ins.count("prefills")
        self._ins.observe("step_seconds", time.perf_counter() - t0)
        if _t0:
            trace.complete("decode::prefill", _t0, cat="serving",
                           args={"bucket": s_p, "paged": self.paged,
                                 "n_requests": len(reqs)})
        return logits, k_init, v_init

    def _prefill(self, s_p: int, reqs: List[_DecodeRequest]) -> None:
        logits, k_init, v_init = self._run_prefill(s_p, reqs)
        # sync survivors' rows before the membership mutation, then seat
        # the joiners
        self._sync_rows()
        for i, r in enumerate(reqs):
            slot = _Slot(r)
            slot.pos = int(r.prompt.size)
            slot.k_row = k_init[i]
            slot.v_row = v_init[i]
            self._ins.count("joins")
            if self._emit(slot, logits[i]):
                # finished at its very first token: never occupies a slot
                self._retire(slot, synced=True)
            else:
                self._slots.append(slot)
                self._dirty = True
        self._peak_active = max(self._peak_active, len(self._slots))
        self._ins.set_active(len(self._slots))

    # -- join, paged: seed pages (prefill for misses, warm pages for hits) ---
    def _admit_paged(self, ready) -> None:
        # the draft's dense rows must be synced before membership changes;
        # the pools themselves do not depend on membership
        self._sync_rows()
        misses = [p for p in ready if not p[1]["shared"]]
        hits = [p for p in ready if p[1]["shared"]]
        seated = []        # (slot, first_logits_or_None)
        groups: Dict[int, list] = {}
        for r, plan in misses:
            s_p = compile_cache.bucket_for(int(r.prompt.size),
                                           self.prefill_edges)
            groups.setdefault(s_p, []).append((r, plan))
        for s_p in sorted(groups):
            seated.extend(self._paged_prefill(s_p, groups[s_p]))
        for r, plan in hits:
            # tail-join: the shared pages already hold the prefix K/V; the
            # slot replays the uncovered prompt tail through decode steps
            # and emits its first token once the replay crosses plen - 1
            slot = _Slot(r)
            slot.pages = plan["shared"] + plan["fresh"]
            slot.pos = len(plan["shared"]) * self.page_size
            seated.append((slot, None))
        if self._draft is not None and seated:
            self._draft_prefill([s for s, _ in seated])
        for slot, first_logits in seated:
            self._ins.count("joins")
            if first_logits is not None and self._emit(slot, first_logits):
                self._retire(slot, synced=True)
            else:
                self._slots.append(slot)
                self._dirty = True
        self._peak_active = max(self._peak_active, len(self._slots))
        self._ins.set_active(len(self._slots))
        self._update_page_gauges()

    def _paged_prefill(self, s_p: int, pairs) -> list:
        """Prefill the miss group, scatter its K/V rows into each slot's
        fresh pages (in place, on the device), and register the fully
        covered prompt pages with the prefix cache."""
        model = self.model
        ps = self.page_size
        reqs = [r for r, _ in pairs]
        logits, k_init, v_init = self._run_prefill(s_p, reqs)
        out = []
        rows_list, k_vals, v_vals = [], [], []
        for i, (r, plan) in enumerate(pairs):
            slot = _Slot(r)
            slot.pages = list(plan["fresh"])
            slot.pos = slot.plen
            n_seed = (slot.plen - 1) // ps + 1
            rows = (np.asarray(slot.pages[:n_seed], np.int64)[:, None] * ps
                    + np.arange(ps, dtype=np.int64)[None, :]).reshape(-1)
            rows_list.append(rows)
            k_vals.append(k_init[i, :n_seed * ps])
            v_vals.append(v_init[i, :n_seed * ps])
            if self._prefix is not None:
                self._prefix.register(r.prompt, slot.pages)
            out.append((slot, logits[i]))
        rows = torch.from_numpy(np.concatenate(rows_list)).to(self._device)
        self._scope.find_var(model.k_pool_name).index_copy_(
            0, rows, torch.cat(k_vals))
        self._scope.find_var(model.v_pool_name).index_copy_(
            0, rows, torch.cat(v_vals))
        return out

    def _draft_prefill(self, slots: List[_Slot]) -> None:
        """Seed the draft model's dense KV rows for every new slot.  The
        draft only steers which tokens are proposed; verification alone
        decides the output, so its numerics need no exactness care."""
        draft = self._draft
        groups: Dict[int, List[_Slot]] = {}
        for s in slots:
            s_p = compile_cache.bucket_for(s.plen, self.prefill_edges)
            groups.setdefault(s_p, []).append(s)
        for s_p, group in sorted(groups.items()):
            prog, logits_n, k_n, v_n = draft.prefill_program(s_p)
            feed = self._prefill_feed(s_p, [s.req for s in group])
            _, k_init, v_init = draft.executor.run(
                prog, feed=feed, fetch_list=[logits_n, k_n, v_n],
                scope=self._draft_scope, return_numpy=False)
            for i, s in enumerate(group):
                s.d_k_row = k_init.raw[i]
                s.d_v_row = v_init.raw[i]

    # -- token emission / retirement ----------------------------------------
    def _emit(self, slot: _Slot, logits_row: np.ndarray) -> bool:
        """Record the next token for ``slot``; True when it finishes."""
        if slot.t_first is None:
            slot.t_first = time.monotonic()
            self._ins.observe("ttft_seconds", slot.t_first - slot.t_submit)
        tok = int(np.argmax(logits_row))
        slot.tokens.append(tok)
        slot.last_token = tok
        if self.collect_logits:
            slot.logits.append(np.asarray(logits_row, dtype=np.float32))
        self._ins.count("tokens")
        r = slot.req
        return (r.eos_id is not None and tok == r.eos_id) \
            or len(slot.tokens) >= r.max_new

    def _retire(self, slot: _Slot, synced: bool = False) -> None:
        if not synced:
            self._sync_rows()
        if slot in self._slots:
            self._slots.remove(slot)
            self._dirty = True
        if self.paged and slot.pages:
            # O(1) page return; prefix-shared pages survive through the
            # cache's own refcount
            for pid in slot.pages:
                self._pool.release(pid)
            slot.pages = []
            self._update_page_gauges()
        r = slot.req
        reason = ("eos" if r.eos_id is not None and slot.tokens
                  and slot.tokens[-1] == r.eos_id else "length")
        out = {"tokens": np.asarray(slot.tokens, dtype=np.int64),
               "prompt_len": int(r.prompt.size),
               "finish_reason": reason}
        if self.collect_logits:
            out["logits"] = np.stack(slot.logits)
        dur = time.monotonic() - slot.t_submit
        self._ins.count("leaves")
        self._ins.observe("request_seconds", dur)
        self._ins.set_active(len(self._slots))
        if _flight.enabled():
            _flight.record_request(r.trace_id, rows=1, outcome="ok",
                                   latency_us=dur * 1e6)
        if trace.enabled():
            trace.instant("decode::finish", cat="serving",
                          args={"trace_id": r.trace_id,
                                "n_tokens": len(slot.tokens),
                                "reason": reason})
        r.future._resolve(out)

    def _update_page_gauges(self) -> None:
        if self._pool is not None:
            self._ins.set_gauge("kv_pages_in_use", self._pool.pages_in_use)
            self._ins.set_gauge("kv_page_pool_free", self._pool.free_pages)

    # -- KV buffer management ------------------------------------------------
    def _sync_rows(self) -> None:
        """Take each live slot's KV rows out of the current dense device
        buffers (views, no copy) before any membership mutation.  While
        ``_dirty`` the buffer has not absorbed the latest membership and
        the per-slot rows are already authoritative.  Paged state lives
        in the membership-independent pools: only the draft model's dense
        rows (speculative) need syncing."""
        if self._dirty or not self._slots or self._cap == 0:
            return
        if self.paged:
            if self._draft is None:
                return
            kb = self._draft_scope.find_var(self._draft.k_name)
            vb = self._draft_scope.find_var(self._draft.v_name)
            for i, s in enumerate(self._slots):
                s.d_k_row = kb[i]
                s.d_v_row = vb[i]
            return
        kb = self._scope.find_var(self.model.k_name)
        vb = self._scope.find_var(self.model.v_name)
        for i, s in enumerate(self._slots):
            s.k_row = kb[i]
            s.v_row = vb[i]

    def _rebuild_buffers(self) -> None:
        """Re-pack per-slot state into buffers sized to the decode bucket.
        Dense: stack the live KV rows on the device.  Paged: re-seed only
        the int32 page table (the pools never move); speculative adds the
        draft model's dense row stack."""
        model = self.model
        n = len(self._slots)
        cap = compile_cache.bucket_for(max(n, 1), self.batch_edges)
        if self.paged:
            ps = self.page_size
            pt = np.zeros((cap, model.max_len), np.int32)
            lane = np.arange(ps, dtype=np.int32)
            for i, s in enumerate(self._slots):
                for pi, pg in enumerate(s.pages):
                    pt[i, pi * ps:(pi + 1) * ps] = pg * ps + lane
            self._scope.set_var(model.pt_name,
                                torch.from_numpy(pt).to(self._device))
            if self._draft is not None:
                zero = torch.zeros((model.max_len, self._draft.d_model),
                                   dtype=torch.float32,
                                   device=self._draft.executor.device)
                for nm, att in ((self._draft.k_name, "d_k_row"),
                                (self._draft.v_name, "d_v_row")):
                    rows = [getattr(s, att) for s in self._slots]
                    rows = [zero if r is None else r for r in rows]
                    self._draft_scope.set_var(
                        nm, torch.stack(rows + [zero] * (cap - n)))
        else:
            zero = torch.zeros((model.max_len, model.d_model),
                               dtype=torch.float32, device=self._device)
            rows_k = [s.k_row for s in self._slots] + [zero] * (cap - n)
            rows_v = [s.v_row for s in self._slots] + [zero] * (cap - n)
            self._scope.set_var(model.k_name, torch.stack(rows_k))
            self._scope.set_var(model.v_name, torch.stack(rows_v))
        self._cap = cap
        self._dirty = False

    # -- one decode step -----------------------------------------------------
    def _step(self) -> None:
        if self._draft is not None:
            self._spec_round()
        elif self.paged:
            self._paged_step()
        else:
            self._decode_step()

    def _decode_step(self) -> None:
        if self._dirty:
            self._rebuild_buffers()
        model = self.model
        cap = self._cap
        tok = np.zeros((cap, 1), dtype=np.int64)
        posi = np.zeros((cap, 1), dtype=np.int64)
        pos = np.zeros((cap, 1), dtype=np.float32)
        for i, s in enumerate(self._slots):
            tok[i, 0] = s.last_token
            posi[i, 0] = s.pos
            pos[i, 0] = float(s.pos)
        feed = {"tok": tok, "posi": posi, "pos": pos,
                "arange": self._arange}
        _t0 = trace.now() if trace.enabled() else 0
        t0 = time.perf_counter()
        logits, = model.executor.run(model.decode_program, feed=feed,
                                     fetch_list=[model.logits_name],
                                     scope=self._scope, return_numpy=True)
        self._ins.count("steps")
        self._ins.observe("step_seconds", time.perf_counter() - t0)
        self._ins.observe("batch_occupancy", float(len(self._slots)) / cap)
        if _t0:
            trace.complete("decode::step", _t0, cat="serving",
                           args={"cap": cap, "live": len(self._slots)})
        finished = []
        for i, s in enumerate(self._slots):
            s.pos += 1
            if self._emit(s, logits[i]):
                finished.append(s)
        if finished:
            # sync ONCE while slot order still matches the buffer, then
            # retire: retiring mutates the slot list
            self._sync_rows()
            for s in finished:
                self._retire(s, synced=True)

    def _write_row(self, s: _Slot, p: int) -> int:
        """Flat pool row that logical position ``p`` of ``s`` lives in."""
        ps = self.page_size
        return s.pages[p // ps] * ps + p % ps

    @staticmethod
    def _token_at(s: _Slot, p: int):
        """The token CONSUMED at position ``p`` (prompt, then generated
        tokens); None when it has not been generated yet."""
        if p < s.plen:
            return int(s.req.prompt[p])
        gi = p - s.plen
        return int(s.tokens[gi]) if gi < len(s.tokens) else None

    def _paged_step(self) -> None:
        if self._dirty:
            self._rebuild_buffers()
        model = self.model
        cap = self._cap
        prog, logits_n = model.paged_program(self._pool_rows)
        tok = np.zeros((cap, 1), dtype=np.int64)
        widx = np.zeros((cap, 1), dtype=np.int64)   # padding -> scratch
        pos = np.zeros((cap, 1), dtype=np.float32)
        for i, s in enumerate(self._slots):
            # replaying a prefix hit's prompt tail feeds prompt tokens;
            # past the prompt it is ordinary autoregressive decode
            t = self._token_at(s, s.pos)
            tok[i, 0] = s.last_token if t is None else t
            widx[i, 0] = self._write_row(s, s.pos)
            pos[i, 0] = float(s.pos)
        feed = {"tok": tok, "widx": widx, "pos": pos,
                "arange": self._arange}
        _t0 = trace.now() if trace.enabled() else 0
        t0 = time.perf_counter()
        logits, = model.executor.run(prog, feed=feed,
                                     fetch_list=[logits_n],
                                     scope=self._scope, return_numpy=True)
        self._observe_paged_step(time.perf_counter() - t0)
        if _t0:
            trace.complete("decode::step", _t0, cat="serving",
                           args={"cap": cap, "live": len(self._slots),
                                 "paged": True})
        finished = []
        for i, s in enumerate(self._slots):
            p = s.pos
            s.pos += 1
            # steps below plen - 1 are prompt replay: no emission yet
            if p >= s.plen - 1 and self._emit(s, logits[i]):
                finished.append(s)
        for s in finished:
            self._retire(s, synced=True)

    def _observe_paged_step(self, dur: float) -> None:
        self._ins.count("steps")
        self._ins.observe("step_seconds", dur)
        # under paging the occupancy signal is page-pool fullness, not
        # slots/cap: a replica whose pool is exhausted is full even when
        # its slot count looks low
        self._ins.observe(
            "batch_occupancy",
            self._pool.pages_in_use / max(1, self._pool.usable_pages))
        self._update_page_gauges()

    # -- one speculative round: the draft proposes, one verify scores ------
    def _spec_round(self) -> None:
        """Draft ``spec_k - 1`` proposals with the cheap model, then run
        ONE target verify program (``spec_k`` chained paged steps) and
        accept the longest prefix of proposals that match the target's
        argmax.  Exactness: each verify block is the plain paged step at
        its position, a proposal is consumed only after it matched, and
        acceptance is capped at ``spec_k - 1`` so the draft's own KV below
        the advanced position always holds true tokens.  Rejected verify
        writes land above the new position and stay masked until a later
        round overwrites them."""
        if self._dirty:
            self._rebuild_buffers()
        model, draft = self.model, self._draft
        cap, K = self._cap, self.spec_k
        live = list(self._slots)
        last_pos = [s.plen + s.req.max_new - 2 for s in live]
        k_eff = [max(1, min(K, lp - s.pos + 1))
                 for s, lp in zip(live, last_pos)]
        kcaps = [min(ke, K - 1) for ke in k_eff]
        u = np.zeros((cap, K), dtype=np.int64)
        proposal = [[False] * K for _ in range(cap)]
        for i, s in enumerate(live):
            t = self._token_at(s, s.pos)
            u[i, 0] = s.last_token if t is None else t
        _t0 = trace.now() if trace.enabled() else 0
        t0 = time.perf_counter()
        # the draft: K - 1 cheap dense steps propose the unknown positions
        for j in range(1, K):
            tok = np.zeros((cap, 1), dtype=np.int64)
            posi = np.zeros((cap, 1), dtype=np.int64)
            posf = np.zeros((cap, 1), dtype=np.float32)
            for i, s in enumerate(live):
                # positions past the budget clamp onto max_len - 1, a row
                # the mask never reaches (plen + max_new <= max_len)
                p = min(s.pos + j - 1, model.max_len - 1)
                tok[i, 0] = u[i, j - 1]
                posi[i, 0] = p
                posf[i, 0] = float(p)
            dlogits, = draft.executor.run(
                draft.decode_program,
                feed={"tok": tok, "posi": posi, "pos": posf,
                      "arange": self._arange},
                fetch_list=[draft.logits_name],
                scope=self._draft_scope, return_numpy=True)
            for i, s in enumerate(live):
                if j >= k_eff[i]:
                    continue
                t = self._token_at(s, s.pos + j)
                if t is None:
                    u[i, j] = int(np.argmax(dlogits[i]))
                    if j < kcaps[i]:
                        proposal[i][j] = True
                        self._ins.count("spec_proposed")
                else:
                    u[i, j] = t     # prompt replay: the token is forced
        # verify: ONE target program over all K positions
        vprog, logit_names = model.verify_program(self._pool_rows, K)
        widx = np.zeros((cap, K), dtype=np.int64)   # padding -> scratch
        pos = np.zeros((cap, 1), dtype=np.float32)
        for i, s in enumerate(live):
            pos[i, 0] = float(s.pos)
            for j in range(k_eff[i]):
                widx[i, j] = self._write_row(s, s.pos + j)
        louts = model.executor.run(
            vprog, feed={"toks": u, "widx": widx, "pos": pos,
                         "arange": self._arange},
            fetch_list=logit_names, scope=self._scope, return_numpy=True)
        self._observe_paged_step(time.perf_counter() - t0)
        if _t0:
            trace.complete("decode::spec_round", _t0, cat="serving",
                           args={"cap": cap, "live": len(live), "k": K})
        finished = []
        for i, s in enumerate(live):
            a = 0
            fin = False
            for j in range(kcaps[i]):
                if proposal[i][j]:
                    # louts[j - 1] is the target's next-token distribution
                    # after consuming u[j - 1]: the proposal survives only
                    # if it IS the greedy target token
                    if int(u[i, j]) != int(np.argmax(louts[j - 1][i])):
                        break
                    self._ins.count("spec_accepted")
                a += 1
                if s.pos + j >= s.plen - 1:
                    if self._emit(s, louts[j][i]):
                        fin = True
                        break
            s.pos += a
            if fin:
                finished.append(s)
        if finished:
            self._sync_rows()
            for s in finished:
                self._retire(s, synced=True)

    # -- warmup / introspection ---------------------------------------------
    def warmup(self, full: bool = False) -> Dict[str, Any]:
        """Run the decode step once per batch bucket and the prefill
        programs once per prompt bucket (``full=True`` crosses every
        prefill bucket with every batch bucket), so their programs are
        built and their kernels loaded before serving.  Paged engines
        warm the paged program instead of the dense step (and, with a
        draft model, the verify program and the draft's dense step);
        warmup writes land on the scratch page only, and the carried state
        is restored after."""
        if self._started:
            raise RuntimeError("warmup() must run before the loop starts")
        t0 = time.perf_counter()
        model = self.model
        dev = self._device
        if self.paged:
            names = (model.k_pool_name, model.v_pool_name, model.pt_name)
            saved = [self._scope.find_var(n) for n in names]
            prog, logits_n = model.paged_program(self._pool_rows)
            for cap in self.batch_edges:
                self._scope.set_var(model.pt_name, torch.zeros(
                    (cap, model.max_len), dtype=torch.int32, device=dev))
                feed = {"tok": np.zeros((cap, 1), np.int64),
                        "widx": np.zeros((cap, 1), np.int64),
                        "pos": np.ones((cap, 1), np.float32),
                        "arange": self._arange}
                model.executor.run(prog, feed=feed, fetch_list=[logits_n],
                                   scope=self._scope, return_numpy=True)
                if self._draft is not None:
                    self._warm_speculative(cap)
        else:
            names = (model.k_name, model.v_name)
            saved = [self._scope.find_var(n) for n in names]
            for cap in self.batch_edges:
                for nm in names:
                    self._scope.set_var(nm, torch.zeros(
                        (cap, model.max_len, model.d_model),
                        dtype=torch.float32, device=dev))
                feed = {"tok": np.zeros((cap, 1), np.int64),
                        "posi": np.zeros((cap, 1), np.int64),
                        "pos": np.ones((cap, 1), np.float32),
                        "arange": self._arange}
                model.executor.run(model.decode_program, feed=feed,
                                   fetch_list=[model.logits_name],
                                   scope=self._scope, return_numpy=True)
        batch_list = list(self.batch_edges) if full else \
            [self.batch_edges[0]]
        for s_p in self.prefill_edges:
            prog, logits_n, k_n, v_n = model.prefill_program(s_p)
            for b in batch_list:
                feed = {"prompt": np.zeros((b, s_p), np.int64),
                        "lastpos": np.zeros((b, 1), np.int64),
                        "plen": np.ones((b, 1), np.float32),
                        "arange_p": self._arange}
                model.executor.run(prog, feed=feed,
                                   fetch_list=[logits_n, k_n, v_n],
                                   scope=self._scope, return_numpy=True)
        for nm, val in zip(names, saved):
            if val is not None:
                self._scope.set_var(nm, val)
        return {"decode_buckets": list(self.batch_edges),
                "prefill_buckets": list(self.prefill_edges),
                "seconds": round(time.perf_counter() - t0, 4)}

    def _warm_speculative(self, cap: int) -> None:
        """One verify program and one draft step at batch bucket ``cap``
        (the page table already zeroed: every write lands on scratch)."""
        model, draft, k = self.model, self._draft, self.spec_k
        vprog, lnames = model.verify_program(self._pool_rows, k)
        model.executor.run(
            vprog, feed={"toks": np.zeros((cap, k), np.int64),
                         "widx": np.zeros((cap, k), np.int64),
                         "pos": np.ones((cap, 1), np.float32),
                         "arange": self._arange},
            fetch_list=lnames, scope=self._scope, return_numpy=True)
        for nm in (draft.k_name, draft.v_name):
            self._draft_scope.set_var(nm, torch.zeros(
                (cap, model.max_len, draft.d_model), dtype=torch.float32,
                device=draft.executor.device))
        draft.executor.run(
            draft.decode_program,
            feed={"tok": np.zeros((cap, 1), np.int64),
                  "posi": np.zeros((cap, 1), np.int64),
                  "pos": np.ones((cap, 1), np.float32),
                  "arange": self._arange},
            fetch_list=[draft.logits_name], scope=self._draft_scope,
            return_numpy=True)

    def stats(self) -> Dict[str, Any]:
        out = {
            "name": self.name,
            "requests": self._ins.counter_value("requests"),
            "rejected": self._ins.counter_value("rejected"),
            "tokens": self._ins.counter_value("tokens"),
            "steps": self._ins.counter_value("steps"),
            "prefills": self._ins.counter_value("prefills"),
            "joins": self._ins.counter_value("joins"),
            "leaves": self._ins.counter_value("leaves"),
            "active_slots": len(self._slots),
            "peak_active": self._peak_active,
            "queue_depth": self._q.qsize() + len(self._pending),
            "decode_buckets": list(self.batch_edges),
            "prefill_buckets": list(self.prefill_edges),
        }
        for h in ("ttft_seconds", "step_seconds", "request_seconds",
                  "batch_occupancy"):
            st = self._ins.hist_stats(h)
            out[h] = {k: st[k] for k in
                      ("count", "avg", "p50", "p95", "p99") if k in st}
        if self.paged:
            paged = {
                "page_size": self.page_size,
                "pool_pages": self._pool.usable_pages,
                "kv_pages_in_use": self._pool.pages_in_use,
                "kv_page_pool_free": self._pool.free_pages,
                "prefix_cache": self._prefix is not None,
                "prefix_hits": self._ins.counter_value("prefix_hits"),
                "prefix_evictions":
                    self._ins.counter_value("prefix_evictions"),
                "prefix_drops": self._ins.counter_value("prefix_drops"),
            }
            if self._draft is not None:
                prop = self._ins.counter_value("spec_proposed")
                acc = self._ins.counter_value("spec_accepted")
                paged["spec_k"] = self.spec_k
                paged["spec_proposed"] = prop
                paged["spec_accepted"] = acc
                paged["spec_accept_rate"] = (round(acc / prop, 4)
                                             if prop else None)
            out["paged"] = paged
        return out


def decode_sequential(model: DecodeModel, prompts, max_new_tokens=16,
                      eos_id: Optional[int] = None,
                      collect_logits: bool = True,
                      timeout: float = 300.0,
                      **engine_kwargs) -> List[Dict[str, Any]]:
    """The reference path batched decode is held against: decode each
    request ALONE (one at a time through one engine, so every step batch
    holds a single live row).  ``max_new_tokens`` may be a list (one
    budget per prompt)."""
    budgets = (list(max_new_tokens)
               if isinstance(max_new_tokens, (list, tuple))
               else [max_new_tokens] * len(prompts))
    out = []
    eng = DecodeEngine(model, collect_logits=collect_logits,
                       **engine_kwargs)
    try:
        for p, budget in zip(prompts, budgets):
            out.append(eng.submit(p, max_new_tokens=budget,
                                  eos_id=eos_id).result(timeout=timeout))
    finally:
        eng.close()
    return out
