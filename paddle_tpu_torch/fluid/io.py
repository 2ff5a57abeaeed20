"""Saving and loading persistable vars (counterpart of
``paddle_tpu/fluid/io.py``, ``save_vars`` to ``load_params``).

The archive is the reference's: one ``params.npz`` (or ``filename``)
holding each var under its name, written atomically (serialised in
memory, written to a temporary file in the same directory, flushed,
fsynced and moved over the old archive with ``os.replace``), so either
package loads the other's.  Values come back to the host with ``.cpu()``
before ``np.savez``, and a load puts them on the executor's place.
``save_inference_model`` (the ProgramDesc protobuf) is not ported yet.
"""
from __future__ import annotations

import io as _io
import os
import threading

import numpy as np
import torch

from .core import global_scope
from .framework import Parameter, Program, default_main_program


def atomic_write_bytes(path: str, data: bytes, do_fsync: bool = True) -> None:
    """Write ``data`` to a same-directory temporary file, flush and fsync
    it, then ``os.replace`` it over ``path``: a reader never sees a
    half-written file, and a crash leaves the old content or none."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f".tmp-{os.path.basename(path)}.{os.getpid()}"
                          f".{threading.get_ident()}")
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if do_fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    if do_fsync:
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)


def _vars_to_save(program: Program, predicate=None):
    return [v for v in program.global_block().vars.values()
            if v.persistable and (predicate is None or predicate(v))]


def _host_array(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Write the named (or all persistable, or ``predicate``-selected)
    vars of the global scope into one npz archive; returns its path."""
    main_program = main_program or default_main_program()
    scope = global_scope()
    if vars is None:
        vars = _vars_to_save(main_program, predicate)
    os.makedirs(dirname, exist_ok=True)
    arrays = {}
    for v in vars:
        name = v if isinstance(v, str) else v.name
        val = scope.find_var(name)
        if val is not None:
            arrays[name] = _host_array(val)
    path = os.path.join(dirname, filename or "params.npz")
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(path, buf.getvalue())
    return path


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, strict=False):
    """Set the archive's vars (or the requested ones) in the global scope
    on the executor's place.  With ``strict=True`` a requested var that
    the archive lacks, or holds with another shape or dtype than the
    program declares, raises, naming every such var."""
    scope = global_scope()
    path = os.path.join(dirname, filename or "params.npz")
    main_program = main_program or default_main_program()
    if vars is None and predicate is not None:
        vars = _vars_to_save(main_program, predicate)
    wanted = None
    if vars is not None:
        wanted = {v if isinstance(v, str) else v.name for v in vars}
    with np.load(path, allow_pickle=False) as data:
        files = set(data.files)
        if strict:
            requested = wanted if wanted is not None else {
                v.name for v in _vars_to_save(main_program)}
            missing = sorted(requested - files)
            mismatched = []
            block = main_program.global_block()
            for name in sorted(requested & files):
                v = block.vars.get(name)
                if v is None:
                    continue
                arr = data[name]
                shp = list(v.shape or [])
                if shp and all(int(x) >= 0 for x in shp) \
                        and list(arr.shape) != shp:
                    mismatched.append(f"{name}: archive shape "
                                      f"{list(arr.shape)} != var shape {shp}")
                try:
                    if v.dtype is not None \
                            and np.dtype(str(v.dtype)) != arr.dtype:
                        mismatched.append(f"{name}: archive dtype "
                                          f"{arr.dtype} != var dtype "
                                          f"{v.dtype}")
                except TypeError:
                    pass        # a dtype numpy lacks (bf16): the archive's
            if missing or mismatched:
                raise ValueError(
                    f"load_vars(strict): archive {path} does not satisfy "
                    f"the request.  Missing vars: "
                    f"{', '.join(missing) or 'none'}.  Mismatches: "
                    f"{'; '.join(mismatched) or 'none'}")
        device = executor.device
        for name in sorted(files):
            if wanted is not None and name not in wanted:
                continue
            scope.set_var(name, torch.from_numpy(data[name]).to(device))


def save_persistables(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: v.persistable, filename=filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, filename=filename)


def save_params(executor, dirname, main_program=None, filename=None):
    return save_vars(executor, dirname, main_program,
                     predicate=lambda v: isinstance(v, Parameter),
                     filename=filename)


def load_params(executor, dirname, main_program=None, filename=None):
    return load_vars(executor, dirname, main_program, filename=filename)
