"""Hand-written CUDA kernels: build, ctypes binding and launch wrappers.

Each ``csrc/*.cu`` source has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``paddle_tpu_torch/build/`` (a
file named by the hash of the source and flags, so an edited source is
rebuilt) and loaded with ``ctypes``.  Nothing is built or imported when
this module is imported: the CPU tests import every module.

A wrapper takes CUDA tensors only.  It checks device, dtype, shape and
strides, allocates the output with ``torch.empty``, launches on PyTorch's
current stream, raises if the launch was refused, and then adds one to
its ``launches`` count — the count ``chip_smoke.py`` reads to show that
the served and trained paths went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points of each source: name -> (argtypes, restype)
_P, _I, _I64P = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64)
_F, _I64, _U = ctypes.c_float, ctypes.c_int64, ctypes.c_uint32
_ERR = {"pt_cuda_error_string": ([_I], ctypes.c_char_p)}
_SIGNATURES = {
    "flash_attention": {
        "pt_flash_attention_fwd": (
            [_P, _P, _P, _P, _P, _P, _P, _I64P, _I, _I, _I, _I, _I, _F, _I,
             _I, _P], _I),
        **_ERR,
    },
    "flash_attention_bwd": {
        "pt_flash_attention_bwd": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64P, _I, _I,
             _I, _I, _I, _F, _I, _I, _P], _I),
        **_ERR,
    },
    "fused_adam": {
        "pt_fused_adam": ([_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                           _P, _I, _F, _F, _F, _F, _F, _P], _I),
        **_ERR,
    },
    "embedding_pool": {
        "pt_embedding_pool_fwd": ([_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                   _I, _P], _I),
        **_ERR,
    },
    "embedding_pool_grad": {
        "pt_embedding_pool_grad_workspace_bytes": (
            [_I, _I, ctypes.POINTER(ctypes.c_size_t)], _I),
        "pt_embedding_pool_grad": ([_P, _P, _P, _P, _P, ctypes.c_size_t, _I,
                                    _I, _I, _I, _I, _P], _I),
        **_ERR,
    },
    "fused_momentum": {
        "pt_fused_momentum": ([_P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                               _I, _F, _F, _I, _P], _I),
        **_ERR,
    },
    "paged_attention": {
        "pt_paged_attention": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I64,
                                _I, _I, _F, _F, _I, _P], _I),
        **_ERR,
    },
    "fused_dropout": {
        "pt_dropout": ([_P, _P, _I64, _U, _U, _U, _F, _I, _P], _I),
        "pt_dropout_mask": ([_P, _I64, _U, _U, _U, _P], _I),
        "pt_dropout_add": ([_P, _P, _P, _I64, _U, _U, _U, _F, _I, _P], _I),
        "pt_act_dropout": ([_P, _P, _I64, _U, _U, _U, _F, _I, _I, _P], _I),
        "pt_act_dropout_bwd": ([_P, _P, _P, _I64, _U, _U, _U, _F, _I, _I,
                                _P], _I),
        **_ERR,
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels are built from source on the machine with "
            "the card")
    return path


def _lib_path(stem: str) -> Path:
    """The library of ``{stem}.cu``, named by the hash of the source, of
    every ``csrc/*.cuh`` header (any source may include any of them) and
    of the flags, so an edited header is rebuilt too."""
    h = hashlib.sha256((CSRC_DIR / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def sources() -> list:
    """Stems of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build(stems: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile each source not yet built, one ``nvcc`` per source, all
    started together.  Returns ``{stem: {"path", "seconds", "log",
    "cached"}}``; ``log`` holds ptxas's register and shared-memory
    report.  Raises with the compiler's output if a build fails."""
    stems = list(stems) if stems is not None else sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, dict] = {}
    procs = {}
    for stem in stems:
        path = _lib_path(stem)
        if path.exists():
            out[stem] = {"path": str(path), "seconds": 0.0, "log": "",
                         "cached": True}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path, tmp, time.perf_counter())
    failed = []
    for stem, (proc, path, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, path)    # atomic: a reader never sees half a file
        out[stem] = {"path": str(path), "seconds": secs, "log": log,
                     "cached": False}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def _lib(stem: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(build([stem])[stem]["path"])
            for fn_name, (argtypes, restype) in _SIGNATURES[stem].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[stem] = lib
        return lib


def _check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.pt_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_bhtd(what, named, ref):
    """Every tensor of ``named`` on ref's CUDA device, of ref's dtype, 4-d
    ``[B,H,T,D]`` with D contiguous."""
    for name, t in named:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{ref.device}, got {t.device}")
        if t.dtype != ref.dtype:
            raise ValueError(f"{what}: {name} is {t.dtype}, q is "
                             f"{ref.dtype}")
        if t.ndim != 4 or t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be 4-d [B,H,T,D] with D "
                             f"contiguous, got shape {tuple(t.shape)} "
                             f"strides {t.stride()}")


def _flash_shapes(what, q, k, v, causal):
    """(B, H, Tq, Tk, D) after the checks both kernels share."""
    _check_bhtd(what, (("q", q), ("k", k), ("v", v)), q)
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    B, H, Tq, D = q.shape
    Tk = k.shape[2]
    if tuple(k.shape) != (B, H, Tk, D) or tuple(v.shape) != (B, H, Tk, D):
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} disagree")
    if D > 128 or D % 8 != 0:
        raise ValueError(f"{what}: head dim {D} not supported "
                         f"(D <= 128, D % 8 == 0)")
    if causal and Tq != Tk:
        raise ValueError(f"{what}: causal needs Tq == Tk")
    return B, H, Tq, Tk, D


def _aligned16(t) -> bool:
    """Whether the kernels' 16-byte ``cp.async`` copies can read ``t``: a
    16-byte aligned base and B, H and T strides of whole 16-byte chunks
    (a stride of a dim of size 1 is never stepped)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        (st * size) % 16 == 0 for n, st in zip(t.shape[:3], t.stride()[:3])
        if n > 1)


def _aligned_inputs(fn, tensors):
    """``tensors`` with each one the kernels cannot read by 16-byte copies
    replaced by a contiguous copy, counted in ``fn.copies``."""
    out = []
    for t in tensors:
        if not _aligned16(t):
            t = t.clone(memory_format=torch.contiguous_format)
            fn.copies += 1
        out.append(t)
    return out


def _bias_arg(what, bias, q, full):
    """The bias as a float32 view broadcast to ``full`` (stride 0 on the
    broadcast dims, never expanded in memory) and its four strides."""
    if bias is None:
        return None, (0, 0, 0, 0)
    if torch.broadcast_shapes(tuple(bias.shape), full) != full:
        raise ValueError(f"{what}: bias {tuple(bias.shape)} does not "
                         f"broadcast to {full}")
    bias = bias.to(device=q.device, dtype=torch.float32)
    bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
    bias = bias.expand(full)
    return bias, bias.stride()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def flash_attention_fwd(q, k, v, bias, scale: float, causal: bool,
                        return_stats: bool = False):
    """``softmax(scale·QKᵀ + bias)·V`` on the Hopper kernel.

    q ``[B,H,Tq,D]``, k/v ``[B,H,Tk,D]``, CUDA, float32 or bfloat16, last
    dim contiguous (other strides free).  ``bias`` (or None) broadcasts to
    ``[B,H,Tq,Tk]``; it is read as float32 through its strides, never
    expanded in memory.  ``causal`` needs Tq == Tk.  With
    ``return_stats`` the kernel also writes each row's softmax
    statistics for the backward, the max ``m`` of the scores and the sum
    ``l`` of ``exp(score - m)``, float32 ``[B,H,Tq]`` each, and the call
    returns ``(o, m, l)``."""
    what = "flash_attention_fwd"
    B, H, Tq, Tk, D = _flash_shapes(what, q, k, v, causal)
    q, k, v = _aligned_inputs(flash_attention_fwd, (q, k, v))
    o = torch.empty((B, H, Tq, D), dtype=q.dtype, device=q.device)
    stats = [torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
             for _ in range(2)] if return_stats else [None, None]
    if B * H * Tq * Tk == 0:
        return (o, *stats) if return_stats else o
    bias, bias_strides = _bias_arg(what, bias, q, (B, H, Tq, Tk))
    strides = (ctypes.c_int64 * 16)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *bias_strides)
    lib = _lib("flash_attention")
    with torch.cuda.device(q.device):
        err = lib.pt_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            *(t.data_ptr() if t is not None else None for t in stats),
            bias.data_ptr() if bias is not None else None, strides,
            B, H, Tq, Tk, D, float(scale), int(bool(causal)),
            _FLASH_DTYPES[q.dtype], _stream(q.device))
    _check_launch(lib, err, what)
    flash_attention_fwd.launches += 1
    return (o, *stats) if return_stats else o


flash_attention_fwd.launches = 0
flash_attention_fwd.copies = 0


def flash_attention_bwd(q, k, v, bias, scale: float, causal: bool, o, m, l,
                        do):
    """dQ, dK, dV of ``softmax(scale·QKᵀ + bias)·V`` on the Hopper
    backward kernels, from the forward's output ``o`` and its softmax
    statistics ``m`` and ``l`` (float32 ``[B,H,Tq]``, see
    ``flash_attention_fwd``).  q, k, v, bias and causal as in
    ``flash_attention_fwd``; ``o`` and ``do`` are ``[B,H,Tq,D]`` of q's
    dtype with D contiguous.  Returns contiguous ``(dq, dk, dv)``.  One
    call is three launches on the current stream (Δ = rowsum(dO∘O),
    dK/dV, dQ) and counts one."""
    what = "flash_attention_bwd"
    B, H, Tq, Tk, D = _flash_shapes(what, q, k, v, causal)
    _check_bhtd(what, (("o", o), ("do", do)), q)
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, H, Tq, D):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} is not "
                             f"{(B, H, Tq, D)}")
    for name, t in (("m", m), ("l", l)):
        if (t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, H, Tq) or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous float32 "
                             f"{(B, H, Tq)} tensor on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    q, k, v, o, do = _aligned_inputs(flash_attention_bwd, (q, k, v, o, do))
    dq, dk, dv = (torch.empty(t.shape, dtype=q.dtype, device=q.device)
                  for t in (q, k, v))
    if B * H * Tq * Tk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Tq), dtype=torch.float32, device=q.device)
    bias, bias_strides = _bias_arg(what, bias, q, (B, H, Tq, Tk))
    strides = (ctypes.c_int64 * 28)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        *do.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
        *dv.stride()[:3], *bias_strides)
    lib = _lib("flash_attention_bwd")
    with torch.cuda.device(q.device):
        err = lib.pt_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), m.data_ptr(), l.data_ptr(), delta.data_ptr(),
            dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            bias.data_ptr() if bias is not None else None, strides,
            B, H, Tq, Tk, D, float(scale), int(bool(causal)),
            _FLASH_DTYPES[q.dtype], _stream(q.device))
    _check_launch(lib, err, what)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.copies = 0


# ---------------------------------------------------------------------------
# the multi-tensor optimizer kernels: fused Adam (csrc/fused_adam.cu) and
# fused Momentum (csrc/fused_momentum.cu)
# ---------------------------------------------------------------------------

# segments per launch: the kernels' MAX_SEGS, which keeps each one's table
# of segment pointers, passed by value, under 4 KB of kernel arguments
BUCKET_SEGMENTS_PER_LAUNCH = 48


@functools.lru_cache(maxsize=64)
def bucket_layout(sizes: tuple):
    """The multi-tensor kernels' output layout for segments of ``sizes``
    values: ``(offsets, total, chunks)``.  Segment i starts at
    ``offsets[i]`` of the flat outputs, each start rounded up to 4 values
    so that every segment's float4 stores are 16-byte aligned (the padding
    is never read); ``total`` is the outputs' length; ``chunks`` are the
    ``(start, stop)`` segment ranges of the launches,
    ``BUCKET_SEGMENTS_PER_LAUNCH`` at most each."""
    offsets, off = [], 0
    for size in sizes:
        offsets.append(off)
        off += -(-size // 4) * 4
    per = BUCKET_SEGMENTS_PER_LAUNCH
    chunks = tuple((a, min(a + per, len(sizes)))
                   for a in range(0, len(sizes), per))
    return tuple(offsets), off, chunks


@functools.lru_cache(maxsize=64)
def _bucket_args(sizes: tuple):
    """The C entries' per-layout arguments, built once per bucket: sizes,
    offsets and chunk bounds as ctypes arrays, the chunk count and the
    outputs' length."""
    offsets, total, chunks = bucket_layout(sizes)
    bounds = [a for a, _ in chunks] + [len(sizes)]
    return ((ctypes.c_int64 * len(sizes))(*sizes),
            (ctypes.c_int64 * len(sizes))(*offsets),
            (ctypes.c_int * len(bounds))(*bounds), len(chunks), total)


# dtype codes of the kernels' gradients and rounded parameters
_GRAD_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_LOW_DTYPES = {torch.bfloat16: 1, torch.float16: 2}


def _bucket_ptrs(what, lr, kinds):
    """The device address of every tensor of ``kinds``, ``(kind, tensors,
    sizes, dtypes)`` quadruples, in order, for a multi-tensor kernel's
    table.  Every tensor must hold its size's values (checked first, so
    that a mismatch is named as such) and be of one of ``dtypes`` on the
    device of ``lr``, the bucket's one-value float32 CUDA LearningRate.
    A non-contiguous tensor is replaced by a contiguous copy; the copies
    are returned beside the addresses, to be kept alive until the launch
    is enqueued."""
    for kind, ts, sizes, _ in kinds:
        for i, (t, size) in enumerate(zip(ts, sizes)):
            if t.numel() != size:
                raise ValueError(f"{what}: {kind} {i} holds {t.numel()} "
                                 f"values, {size} expected")
    dev = lr.device
    if dev.type != "cuda" or lr.dtype != torch.float32 or lr.numel() != 1:
        raise ValueError(f"{what}: lr must be a one-value float32 CUDA "
                         f"tensor, got {lr.dtype} {tuple(lr.shape)} on {dev}")
    ptrs, copies = [], []
    for kind, ts, _, dtypes in kinds:
        for i, t in enumerate(ts):
            if t.device != dev or t.dtype not in dtypes:
                names = " or ".join(str(d).removeprefix("torch.")
                                    for d in dtypes)
                raise ValueError(f"{what}: {kind} {i} must be a {names} "
                                 f"CUDA tensor on {dev}, got {t.dtype} on "
                                 f"{t.device}")
            if not t.is_contiguous():
                t = t.contiguous()
                copies.append(t)
            ptrs.append(t.data_ptr())
    return ptrs, copies


_F32 = (torch.float32,)


def _low_code(what, low_dtype):
    if low_dtype not in _LOW_DTYPES:
        raise ValueError(f"{what}: the parameters must be bfloat16 or "
                         f"float16, got {low_dtype}")
    return _LOW_DTYPES[low_dtype]


def _adam_launch(what, ps, gs, ms, vs, lr, b1ps, b2ps, beta1, beta2, eps,
                 low_dtype):
    """One call of ``pt_fused_adam``: the float32 path (``low_dtype``
    None) or the master path."""
    k = len(ps)
    if k == 0 or not all(len(x) == k for x in (gs, ms, vs, b1ps, b2ps)):
        raise ValueError(f"{what}: {k} params need as many grads, moments "
                         f"and beta powers, and at least one")
    lo = 0 if low_dtype is None else _low_code(what, low_dtype)
    sizes = tuple(p.numel() for p in ps)
    ptrs, copies = _bucket_ptrs(
        what, lr, [("param" if lo == 0 else "master", ps, sizes, _F32),
                   ("grad", gs, sizes,
                    _F32 if lo == 0 else tuple(_GRAD_DTYPES)),
                   ("moment1", ms, sizes, _F32),
                   ("moment2", vs, sizes, _F32)]
        + [(kind, ts, (1,) * k, _F32) for kind, ts in (
            ("beta1_pow", b1ps), ("beta2_pow", b2ps))])
    dev = lr.device
    table = (ctypes.c_void_p * (6 * k))(*ptrs)
    gdt = (ctypes.c_uint8 * k)(*(_GRAD_DTYPES[g.dtype] for g in gs))
    n_arr, out_arr, bounds, nchunks, total = _bucket_args(sizes)
    po, mo, vo = (torch.empty((max(total, 4),), dtype=torch.float32,
                              device=dev) for _ in range(3))
    plo = None if lo == 0 else torch.empty((max(total, 4),),
                                           dtype=low_dtype, device=dev)
    pows = torch.empty((2, k), dtype=torch.float32, device=dev)
    lib = _lib("fused_adam")
    with torch.cuda.device(dev):
        err = lib.pt_fused_adam(
            table, n_arr, out_arr, gdt, bounds, nchunks, k, lr.data_ptr(),
            po.data_ptr(), mo.data_ptr(), vo.data_ptr(), pows.data_ptr(),
            _ptr(plo), lo, float(beta1), float(1 - beta1), float(beta2),
            float(1 - beta2), float(eps), _stream(dev))
    _check_launch(lib, err, what)
    return po, mo, vo, plo, pows


def fused_adam(ps, gs, ms, vs, lr, b1ps, b2ps, beta1: float, beta2: float,
               eps: float):
    """One Adam step over a bucket of parameters on the Hopper kernel,
    read where they lie: ``ps``, ``gs``, ``ms``, ``vs`` lists of CUDA
    float32 tensors (the i-th of each of one size; a non-contiguous one is
    copied first), ``lr`` the one-value
    LearningRate, ``b1ps``/``b2ps`` each parameter's one-value
    Beta1Pow/Beta2Pow, all on one device.  The kernel computes each
    parameter's ``lr·sqrt(1 - b2p)/(1 - b1p)`` itself.  Returns ``(po,
    mo, vo, pows)``: flat float32 outputs laid out by ``bucket_layout`` of
    the sizes, and ``pows`` ``[2, len(ps)]`` holding ``b1p·beta1`` and
    ``b2p·beta2``.  Each operation is rounded once, as the per-param
    ``adam`` lowering's separate torch ops round them.  One call launches
    one kernel per ``BUCKET_SEGMENTS_PER_LAUNCH`` parameters and counts
    one."""
    po, mo, vo, _, pows = _adam_launch(
        "fused_adam", ps, gs, ms, vs, lr, b1ps, b2ps, beta1, beta2, eps,
        None)
    fused_adam.launches += 1
    return po, mo, vo, pows


fused_adam.launches = 0


def fused_adam_master(masters, gs, ms, vs, lr, b1ps, b2ps, beta1: float,
                      beta2: float, eps: float, low_dtype):
    """``fused_adam``'s master path, on the same kernel: ``masters`` the
    float32 master weights, ``gs`` the gradients in their own dtype
    (float32, bfloat16 or float16; the kernel widens them), the rest as in
    ``fused_adam``.  Returns ``(po, mo, vo, plo, pows)``: the new masters,
    moments, the new masters rounded to ``low_dtype`` (bfloat16 or
    float16, to nearest even) in ``plo``, and the powers.  Bit for bit the
    per-param ``adam`` op with ``MasterParam``.  Counts one a call."""
    out = _adam_launch("fused_adam_master", masters, gs, ms, vs, lr, b1ps,
                       b2ps, beta1, beta2, eps, low_dtype)
    fused_adam_master.launches += 1
    return out


fused_adam_master.launches = 0


# ---------------------------------------------------------------------------
# fused sparse embedding (csrc/embedding_pool.cu, csrc/embedding_pool_grad.cu)
# ---------------------------------------------------------------------------

def _check_cuda(what, named, ref, dtype):
    """Every tensor of ``named`` on ref's CUDA device, of ``dtype``,
    contiguous."""
    for name, t in named:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{ref.device}, got {t.device}")
        if t.dtype != dtype:
            hint = (" (the kernels take float32; bfloat16 comes with the "
                    "AMP slice)" if dtype == torch.float32 else "")
            raise ValueError(f"{what}: {name} is {t.dtype}, the kernel "
                             f"takes {dtype}{hint}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous, got "
                             f"strides {t.stride()} for shape "
                             f"{tuple(t.shape)}")


def _ptr(t):
    """A tensor's device address, or NULL for None."""
    return None if t is None else t.data_ptr()


def _check_ids_wgt(what, ids, wgt, ref):
    """ids int64 ``[B, S]`` and wgt float32 ``[B, S]`` or None (every
    weight 1), contiguous, on ref's device; returns (B, S)."""
    if ids.ndim != 2:
        raise ValueError(f"{what}: ids must be 2-d [B, S], got shape "
                         f"{tuple(ids.shape)}")
    _check_cuda(what, (("ids", ids),), ref, torch.int64)
    if wgt is not None:
        _check_cuda(what, (("wgt", wgt),), ref, torch.float32)
    if wgt is not None and wgt.shape != ids.shape:
        raise ValueError(f"{what}: wgt {tuple(wgt.shape)} is not ids' "
                         f"shape {tuple(ids.shape)}")
    b, s = ids.shape
    if b * s >= 2 ** 31:
        raise ValueError(f"{what}: {b * s} ids; the kernel indexes "
                         f"positions with 32-bit ints")
    return b, s


def embedding_pool_fwd(w, ids, wgt):
    """``out[i] = Σ_j w[ids[i,j]] · wgt[i,j]`` on the Hopper kernel, the
    products and sums rounded one by one in j order.  w ``[V, D]``
    float32, ids ``[B, S]`` int64 (as fed), wgt ``[B, S]`` float32 or
    None for all ones, all CUDA and contiguous.  An id outside ``[0, V)`` traps on the device.
    Returns ``[B, D]`` float32."""
    what = "embedding_pool_fwd"
    if w.ndim != 2:
        raise ValueError(f"{what}: w must be 2-d [V, D], got shape "
                         f"{tuple(w.shape)}")
    _check_cuda(what, (("w", w),), w, torch.float32)
    b, s = _check_ids_wgt(what, ids, wgt, w)
    v, d = w.shape
    out = torch.empty((b, d), dtype=w.dtype, device=w.device)
    if out.numel() == 0:
        return out.zero_()
    lib = _lib("embedding_pool")
    with torch.cuda.device(w.device):
        err = lib.pt_embedding_pool_fwd(
            w.data_ptr(), ids.data_ptr(), _ptr(wgt), out.data_ptr(),
            b, s, v, d, _sm_count(w.device), _stream(w.device))
    _check_launch(lib, err, what)
    embedding_pool_fwd.launches += 1
    return out


embedding_pool_fwd.launches = 0


# the scatter-add's workspace bytes by (n, end_bit), and its workspace by
# (device, stream), grown when a call needs more: kernels on one stream
# run in order, so each call may reuse what the one before it used
_grad_ws_bytes: Dict[tuple, int] = {}
_grad_ws: Dict[tuple, torch.Tensor] = {}


def _grad_workspace(lib, what, n, end_bit, device, stream):
    need = _grad_ws_bytes.get((n, end_bit))
    if need is None:
        nbytes = ctypes.c_size_t(0)
        _check_launch(lib, lib.pt_embedding_pool_grad_workspace_bytes(
            n, end_bit, ctypes.byref(nbytes)), what)
        need = _grad_ws_bytes[(n, end_bit)] = max(nbytes.value, 1)
    ws = _grad_ws.get((device, stream))
    if ws is None or ws.numel() < need:
        ws = _grad_ws[(device, stream)] = torch.empty(
            (need,), dtype=torch.uint8, device=device)
    return ws


def embedding_pool_grad(g, ids, wgt, vocab: int):
    """``dW[r] = Σ over (i, j) with ids[i,j] = r, in (i, j) order, of
    g[i] · wgt[i,j]`` on the Hopper kernels: a dense ``[vocab, D]``
    float32 dW, untouched rows 0.  g ``[B, D]`` float32, ids ``[B, S]``
    int64, wgt ``[B, S]`` float32 or None for all ones, all CUDA and
    contiguous.  Deterministic: one call zero-fills dW while sorting
    tiles of positions stably by id, merges the tiles into one order
    (past 32,768 positions a device-wide CUB sort does both), and sums
    each id's products in that order over the sorted positions only; it
    counts one launch.  Its scratch is a workspace cached per device and
    stream."""
    what = "embedding_pool_grad"
    if g.ndim != 2:
        raise ValueError(f"{what}: g must be 2-d [B, D], got shape "
                         f"{tuple(g.shape)}")
    _check_cuda(what, (("g", g),), g, torch.float32)
    b, s = _check_ids_wgt(what, ids, wgt, g)
    d = g.shape[1]
    vocab = int(vocab)
    if g.shape[0] != b:
        raise ValueError(f"{what}: g has {g.shape[0]} rows, ids {b}")
    if not 0 < vocab < 2 ** 31 or d > 65535 * 32:
        raise ValueError(f"{what}: vocab {vocab}, D {d}: the kernel takes "
                         f"0 < vocab < 2**31 and D <= 65535 * 32")
    dw = torch.empty((vocab, d), dtype=g.dtype, device=g.device)
    if d == 0:
        return dw
    n = b * s
    end_bit = max(1, (vocab - 1).bit_length())
    lib = _lib("embedding_pool_grad")
    with torch.cuda.device(g.device):
        stream = _stream(g.device)
        ws = _grad_workspace(lib, what, n, end_bit, g.device, stream)
        err = lib.pt_embedding_pool_grad(
            g.data_ptr(), ids.data_ptr(), _ptr(wgt), dw.data_ptr(),
            ws.data_ptr(), ws.numel(), n, s, vocab, d, end_bit, stream)
    _check_launch(lib, err, what)
    embedding_pool_grad.launches += 1
    return dw


embedding_pool_grad.launches = 0


# ---------------------------------------------------------------------------
# fused Momentum (csrc/fused_momentum.cu)
# ---------------------------------------------------------------------------

def _momentum_launch(what, ps, gs, vs, lr, mu, l2, nesterov, low_dtype):
    """One call of ``pt_fused_momentum``: the float32 path
    (``low_dtype`` None) or the master path."""
    k = len(ps)
    if k == 0 or len(gs) != k or len(vs) != k:
        raise ValueError(f"{what}: {k} params need as many grads and "
                         f"velocities, and at least one")
    lo = 0 if low_dtype is None else _low_code(what, low_dtype)
    sizes = tuple(p.numel() for p in ps)
    ptrs, copies = _bucket_ptrs(what, lr, [
        ("param" if lo == 0 else "master", ps, sizes, _F32),
        ("grad", gs, sizes, _F32 if lo == 0 else tuple(_GRAD_DTYPES)),
        ("velocity", vs, sizes, _F32)])
    dev = lr.device
    table = (ctypes.c_void_p * (3 * k))(*ptrs)
    gdt = (ctypes.c_uint8 * k)(*(_GRAD_DTYPES[g.dtype] for g in gs))
    n_arr, out_arr, bounds, nchunks, total = _bucket_args(sizes)
    po, vo = (torch.empty((max(total, 4),), dtype=torch.float32, device=dev)
              for _ in range(2))
    plo = None if lo == 0 else torch.empty((max(total, 4),),
                                           dtype=low_dtype, device=dev)
    lib = _lib("fused_momentum")
    with torch.cuda.device(dev):
        err = lib.pt_fused_momentum(
            table, n_arr, out_arr, gdt, bounds, nchunks, k, lr.data_ptr(),
            po.data_ptr(), vo.data_ptr(), _ptr(plo), lo, float(mu),
            float(l2), int(bool(nesterov)), _stream(dev))
    _check_launch(lib, err, what)
    return po, vo, plo


def fused_momentum(ps, gs, vs, lr, mu: float, l2: float, nesterov: bool):
    """One Momentum step over a bucket of parameters on the Hopper kernel,
    read where they lie: ``ps``, ``gs``, ``vs`` lists of CUDA float32
    tensors (the i-th of each of one size; a non-contiguous one is copied
    first), ``lr`` the one-value LearningRate, read by the kernel where it
    lies, all on one device.  ``v' = mu·v + g`` (``g + l2·p`` first when
    ``l2``), then ``p' = p - lr·v'`` or, with ``nesterov``, ``p - lr·(g +
    mu·v')``.  Returns ``(po, vo)``: flat float32 outputs laid out by
    ``bucket_layout`` of the sizes.  Each product and sum is rounded
    once, as the per-param ``momentum`` lowering's separate torch ops
    round them.  One call launches one kernel per
    ``BUCKET_SEGMENTS_PER_LAUNCH`` parameters and counts one."""
    po, vo, _ = _momentum_launch("fused_momentum", ps, gs, vs, lr, mu, l2,
                                 nesterov, None)
    fused_momentum.launches += 1
    return po, vo


fused_momentum.launches = 0


def fused_momentum_master(masters, gs, vs, lr, mu: float, l2: float,
                          nesterov: bool, low_dtype):
    """``fused_momentum``'s master path, on the same kernel: ``masters``
    the float32 master weights, ``gs`` the gradients in their own dtype
    (float32, bfloat16 or float16; the kernel widens them).  Returns
    ``(po, vo, plo)``: the new masters, velocities and the new masters
    rounded to ``low_dtype`` (to nearest even).  Bit for bit the
    per-param ``momentum`` op with ``MasterParam``.  Counts one a call."""
    out = _momentum_launch("fused_momentum_master", masters, gs, vs, lr, mu,
                           l2, nesterov, low_dtype)
    fused_momentum_master.launches += 1
    return out


fused_momentum_master.launches = 0


# ---------------------------------------------------------------------------
# dropout, its mask, dropout-add, act-dropout and its backward
# (csrc/fused_dropout.cu)
# ---------------------------------------------------------------------------
_DROPOUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {"gelu": 0, "relu": 1}


def _check_dropout(what, named, ref):
    """Every tensor of ``named`` on ref's CUDA device, of ref's dtype
    (float32 or bfloat16) and shape, contiguous."""
    if ref.dtype not in _DROPOUT_DTYPES:
        raise ValueError(f"{what}: dtype {ref.dtype} not supported "
                         f"(float32, bfloat16)")
    for name, t in named:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"{ref.device}, got {t.device}")
        if t.dtype != ref.dtype or t.shape != ref.shape \
                or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous {ref.dtype} "
                             f"of shape {tuple(ref.shape)}, got {t.dtype} "
                             f"{tuple(t.shape)} strides {t.stride()}")


def _key_args(seed: int, threshold: int):
    """The seed's two 32-bit key words and the threshold, range-checked
    for the kernel's uint32 arguments."""
    if not 0 <= seed < 2 ** 64 or not 0 <= threshold < 2 ** 32:
        raise ValueError(f"seed {seed} must be a 64-bit and threshold "
                         f"{threshold} a 32-bit unsigned value")
    return seed & 0xFFFFFFFF, seed >> 32, threshold


def fused_dropout(x, seed: int, threshold: int, scale: float):
    """``where(bits >= threshold, x·scale, 0)`` on the Hopper kernel, the
    bits Philox4x32-10 of (seed, flat index) as ``ops/nn_ops.py``
    describes; x CUDA float32 or bfloat16, contiguous; the product in
    float32, rounded once.  The backward of dropout is this on the
    cotangent."""
    what = "fused_dropout"
    _check_dropout(what, (("x", x),), x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib("fused_dropout")
    with torch.cuda.device(x.device):
        err = lib.pt_dropout(x.data_ptr(), out.data_ptr(), x.numel(),
                             *_key_args(seed, threshold), float(scale),
                             _DROPOUT_DTYPES[x.dtype], _stream(x.device))
    _check_launch(lib, err, what)
    fused_dropout.launches += 1
    return out


fused_dropout.launches = 0


def dropout_mask(x, seed: int, threshold: int):
    """The uint8 keep mask (``bits >= threshold``) of x's shape from the
    same bits as ``fused_dropout``; x (CUDA) gives the shape and device
    and is not read.  The kernel stores 16 bytes at a time into the mask
    this allocates (``torch.empty`` is 16-byte aligned; the C entry
    refuses another)."""
    what = "dropout_mask"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: x must be a CUDA tensor, got {x.device}")
    mask = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return mask
    k0, k1, thr = _key_args(seed, threshold)
    lib = _lib("fused_dropout")
    with torch.cuda.device(x.device):
        err = lib.pt_dropout_mask(mask.data_ptr(), x.numel(), k0, k1, thr,
                                  _stream(x.device))
    _check_launch(lib, err, what)
    dropout_mask.launches += 1
    return mask


dropout_mask.launches = 0


def fused_dropout_add(x, r, seed: int, threshold: int, scale: float):
    """``where(bits >= threshold, x·scale, 0) + r`` on the Hopper kernel,
    in float32, rounded once; x and r CUDA, of one dtype (float32 or
    bfloat16) and shape, contiguous."""
    what = "fused_dropout_add"
    _check_dropout(what, (("x", x), ("r", r)), x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib("fused_dropout")
    with torch.cuda.device(x.device):
        err = lib.pt_dropout_add(x.data_ptr(), r.data_ptr(), out.data_ptr(),
                                 x.numel(), *_key_args(seed, threshold),
                                 float(scale), _DROPOUT_DTYPES[x.dtype],
                                 _stream(x.device))
    _check_launch(lib, err, what)
    fused_dropout_add.launches += 1
    return out


fused_dropout_add.launches = 0


def _act_code(what, act):
    if act not in _ACTS:
        raise ValueError(f"{what}: act {act!r} not supported (gelu, relu)")
    return _ACTS[act]


def fused_act_dropout(x, seed: int, threshold: int, scale: float, act: str):
    """``where(bits >= threshold, act(x)·scale, 0)`` on the Hopper kernel,
    act ``gelu`` (exact erf) or ``relu``, in float32, rounded once; x CUDA
    float32 or bfloat16, contiguous."""
    what = "fused_act_dropout"
    _check_dropout(what, (("x", x),), x)
    code = _act_code(what, act)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib("fused_dropout")
    with torch.cuda.device(x.device):
        err = lib.pt_act_dropout(x.data_ptr(), out.data_ptr(), x.numel(),
                                 *_key_args(seed, threshold), float(scale),
                                 code, _DROPOUT_DTYPES[x.dtype],
                                 _stream(x.device))
    _check_launch(lib, err, what)
    fused_act_dropout.launches += 1
    return out


fused_act_dropout.launches = 0


def fused_act_dropout_bwd(x, g, seed: int, threshold: int, scale: float,
                          act: str):
    """``where(bits >= threshold, g·scale, 0) · act'(x)`` on the Hopper
    kernel, the mask regenerated from the seed; x and g CUDA, of one
    dtype and shape, contiguous."""
    what = "fused_act_dropout_bwd"
    _check_dropout(what, (("x", x), ("g", g)), x)
    code = _act_code(what, act)
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    lib = _lib("fused_dropout")
    with torch.cuda.device(x.device):
        err = lib.pt_act_dropout_bwd(x.data_ptr(), g.data_ptr(),
                                     dx.data_ptr(), x.numel(),
                                     *_key_args(seed, threshold),
                                     float(scale), code,
                                     _DROPOUT_DTYPES[x.dtype],
                                     _stream(x.device))
    _check_launch(lib, err, what)
    fused_act_dropout_bwd.launches += 1
    return dx


fused_act_dropout_bwd.launches = 0


# ---------------------------------------------------------------------------
# paged decode attention (csrc/paged_attention.cu)
# ---------------------------------------------------------------------------
PAGED_CHUNK = 16          # positions: a split holds at least one chunk
PAGED_MAX_SPLITS = 512    # the kernel's merge holds this many (m, l) pairs


def paged_splits(b: int, s: int, n_sm: int) -> int:
    """The paged kernel's splits per slot (its grid is ``B × n_split``):
    as many as keep the grid within two CTAs per SM (the most that stay
    resident together at d <= ~3,500), one wave, while every split of an
    all-valid row still holds a whole 16-position chunk.  The kernel
    shares each slot's kept positions out evenly over them: split t takes
    the ranks ``[t·kept // n_split, (t + 1)·kept // n_split)``."""
    return max(1, min(s // PAGED_CHUNK, 2 * n_sm // b, PAGED_MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# the split kernel's workspace by (device, stream): the zeroed tickets
# (one int per slot, reset by each call's merging CTA) and the partials
# (B·n_split·(round_up(d, 4) + 2) floats), each grown when a call needs
# more; kernels on one stream run in order, so each call may reuse them
_paged_ws: Dict[tuple, tuple] = {}


def _paged_workspace(device, stream, b, floats):
    tickets, part = _paged_ws.get((device, stream), (None, None))
    if tickets is None or tickets.numel() < b:
        tickets = torch.zeros((b,), dtype=torch.int32, device=device)
    if part is None or part.numel() < floats:
        part = torch.empty((floats,), dtype=torch.float32, device=device)
    _paged_ws[(device, stream)] = (tickets, part)
    return tickets, part


def paged_attention(q, k_pool, v_pool, idx, valid, scale: float, neg: float):
    """``softmax_j(s_bj) · VPool[idx[b,j]]`` summed over j, with
    ``s_bj = (q_b · KPool[idx[b,j]])·scale·valid + (valid·neg - neg)``
    (exactly ``-neg`` at a masked position), on the Hopper kernel.  q
    ``[B, d]``, the pools ``[R, d]``, all float32; idx int32 with B·S
    entries (``[B·S]`` or ``[B, S]``); valid float32 ``[B, S]``; all
    CUDA and contiguous.  An index outside ``[0, R)`` traps on the
    device.  Returns ``[B, d]`` float32.  One launch: ``B × n_split``
    CTAs (``paged_splits``) share out each slot's kept positions and the
    last CTA of each slot merges their partials in a fixed order, so two
    calls give the same bits; the partials live in a workspace cached
    per device and stream."""
    what = "paged_attention"
    if q.ndim != 2 or k_pool.ndim != 2 or v_pool.ndim != 2 \
            or valid.ndim != 2:
        raise ValueError(f"{what}: q [B, d], pools [R, d] and valid [B, S] "
                         f"must be 2-d, got {tuple(q.shape)}, "
                         f"{tuple(k_pool.shape)}, {tuple(v_pool.shape)}, "
                         f"{tuple(valid.shape)}")
    _check_cuda(what, (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                       ("valid", valid)), q, torch.float32)
    _check_cuda(what, (("idx", idx),), q, torch.int32)
    b, d = q.shape
    r = k_pool.shape[0]
    s = valid.shape[1]
    if k_pool.shape != v_pool.shape or k_pool.shape[1] != d:
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)} and "
                         f"{tuple(v_pool.shape)} must both be [R, {d}]")
    if valid.shape[0] != b or idx.numel() != b * s:
        raise ValueError(f"{what}: valid {tuple(valid.shape)} and idx "
                         f"{tuple(idx.shape)} must cover [{b}, S]")
    if s == 0 or r == 0:
        raise ValueError(f"{what}: attention over S = {s} positions of a "
                         f"pool of R = {r} rows is empty")
    if max(b, s, d) >= 2 ** 31 or b * s >= 2 ** 31:
        raise ValueError(f"{what}: B = {b}, S = {s}, d = {d}: the kernel "
                         f"counts them with 32-bit ints")
    out = torch.empty((b, d), dtype=torch.float32, device=q.device)
    if b == 0 or d == 0:
        return out
    lib = _lib("paged_attention")
    with torch.cuda.device(q.device):
        n_split = paged_splits(b, s, _sm_count(q.device))
        stream = _stream(q.device)
        tickets = part = None
        if n_split > 1:
            tickets, part = _paged_workspace(
                q.device, stream, b, b * n_split * (-(-d // 4) * 4 + 2))
        err = lib.pt_paged_attention(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            idx.data_ptr(), valid.data_ptr(), out.data_ptr(), _ptr(part),
            _ptr(tickets), b, s, r, d, n_split, float(scale), float(neg),
            q.device.index, stream)
    _check_launch(lib, err, what)
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
