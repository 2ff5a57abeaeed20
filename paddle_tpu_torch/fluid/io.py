"""Checkpoint save/load and inference model export (counterpart of
``paddle_tpu/fluid/io.py``).

Reference: python/paddle/fluid/io.py — save_vars:238, save_persistables:620,
load_persistables:994, save/load_inference_model:1198,1411.

The archive is the reference's: one ``params.npz`` (or ``filename``)
holding each var under its name, written atomically (serialised in
memory, written to a temporary file in the same directory, flushed,
fsynced and moved over the old archive with ``os.replace``), so either
package loads the other's.  Values come back to the host with ``.cpu()``
before ``np.savez``, and a load puts them on the executor's place.

Model format: ``__model__`` is the ProgramDesc message (the reference's
own wire format, proto/framework.proto, written by the port's codec),
with feed/fetch ops spliced in exactly as the reference does
(io.py:1151,1179) and an OpVersionMap pinning op semantics
(fluid/op_version_registry.py).  Params are one ``params.npz`` per save
on the native path, and the loader also reads the reference's binary
formats (per-var LoDTensor files and save_combine concatenations), so
artifacts produced by the reference load directly.  A pickled
``__model__`` is refused with a re-export message — pickle is not a
deployment contract.
"""
from __future__ import annotations

import io as _io
import json
import os
import threading
from typing import List, Optional

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


def _splice_feed_fetch(program: Program, feed_names, fetch_names) -> None:
    """Add reference-style feed/fetch holder vars + ops (io.py:1151,1179):
    feed ops write each input var from the FEED_MINIBATCH holder, fetch
    ops read each target into the FETCH_LIST holder, `col` = position."""
    from .framework import Operator
    block = program.global_block()
    for name in ("feed", "fetch"):
        holder = block.create_var(name=name, dtype=None)
        holder.proto_var_type = name
        holder.persistable = True
    feed_ops = [Operator(block, "feed", {"X": ["feed"]}, {"Out": [name]},
                         {"col": i})
                for i, name in enumerate(feed_names)]
    fetch_ops = [Operator(block, "fetch", {"X": [name]},
                          {"Out": ["fetch"]}, {"col": i})
                 for i, name in enumerate(fetch_names)]
    block.ops[:0] = feed_ops
    block.ops.extend(fetch_ops)
    program._bump_version()


def _holder(v) -> bool:
    return v.proto_var_type in ("feed", "fetch")


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, export_for_deployment=True,
                         program_only=False) -> List[str]:
    """Export ``__model__`` (the ProgramDesc message) + params — io.py:1198
    analog.  With params_filename the params are ALSO written in the
    reference save_combine binary format next to the native npz, so the
    artifact is consumable by reference tooling.  Values come from the
    global scope."""
    from . import proto_serde
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    # clone(for_test) strips the backward tail; _prune then cuts to the
    # target-reachable subgraph (an exported model carries no loss or
    # metric ops)
    infer_prog = main_program.clone(for_test=True)._prune(
        [v.name for v in target_vars])
    manifest = {
        "feed_names": list(feeded_var_names),
        "fetch_names": [v.name for v in target_vars],
    }
    _splice_feed_fetch(infer_prog, manifest["feed_names"],
                       manifest["fetch_names"])
    # a human-readable sidecar (feed/fetch are authoritative in the
    # message's feed/fetch ops; this is for quick shell inspection)
    with open(os.path.join(dirname, "__model__.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(proto_serde.program_to_proto_bytes(infer_prog))
    if not program_only:
        save_persistables(executor, dirname, main_program)
        if params_filename:
            scope = global_scope()
            arrays = {}
            for v in _vars_to_save(infer_prog):
                if _holder(v):
                    continue
                val = scope.find_var(v.name)
                if val is None:
                    # the combined format is positional (sorted names); a
                    # gap would shift every later tensor onto the wrong var
                    raise ValueError(
                        f"persistable var '{v.name}' has no value in the "
                        f"scope — run the startup program before exporting")
                arrays[v.name] = val
            proto_serde.save_combined_params(
                os.path.join(dirname, params_filename), arrays)
    return manifest["fetch_names"]


def _load_reference_params(dirname, program,
                           params_filename: Optional[str] = None,
                           device=None):
    """Read params saved in the reference's binary formats, one combined
    save_combine file or one LoDTensor file per persistable var, into the
    global scope on ``device``."""
    from . import proto_serde
    scope = global_scope()
    names = [v.name for v in program.global_block().vars.values()
             if v.persistable and not _holder(v)]
    if params_filename:
        arrays = proto_serde.load_combined_params(
            os.path.join(dirname, params_filename), names)
        for name, t in arrays.items():
            scope.set_var(name, t.to(device))
        return
    for name in names:
        path = os.path.join(dirname, name)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no param file for persistable var '{name}' in {dirname}")
        with open(path, "rb") as f:
            t, _lod, _ = proto_serde.deserialize_lod_tensor(f.read())
        scope.set_var(name, t.to(device))


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None):
    """Load a ``__model__`` ProgramDesc (this package's, the TPU
    package's or the reference's) + params (native npz, reference
    combined file, or reference per-var files) into the global scope on
    the executor's place — io.py:1411 analog.  Returns (program,
    feed_names, fetch_vars)."""
    from . import proto_serde
    path = os.path.join(dirname, model_filename or "__model__")
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] in (b"\x80\x02", b"\x80\x03", b"\x80\x04", b"\x80\x05"):
        raise RuntimeError(
            f"{path} is a legacy pickled-IR artifact; re-export it with "
            f"save_inference_model — the model format is now the "
            f"ProgramDesc protobuf")
    program = proto_serde.program_from_proto_bytes(data)
    feed_names, fetch_names = proto_serde.strip_feed_fetch_ops(program)
    manifest_path = os.path.join(dirname, "__model__.json")
    if not fetch_names and os.path.exists(manifest_path):
        # program had no feed/fetch ops (program_only legacy export)
        with open(manifest_path) as f:
            manifest = json.load(f)
        feed_names = manifest["feed_names"]
        fetch_names = manifest["fetch_names"]
    if params_filename:
        # an explicit params file always wins over a sibling params.npz
        _load_reference_params(dirname, program, params_filename,
                               executor.device)
    elif os.path.exists(os.path.join(dirname, "params.npz")):
        load_persistables(executor, dirname, program)
    else:
        _load_reference_params(dirname, program, None, executor.device)
    fetch_vars = [program.global_block().var(n) for n in fetch_names]
    return program, feed_names, fetch_vars


def get_program_persistable_vars(program):
    return [v for v in program.global_block().vars.values() if v.persistable]
