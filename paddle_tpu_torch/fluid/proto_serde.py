"""Program <-> ProgramDesc wire format, and the reference's binary tensor
streams (counterpart of ``paddle_tpu/fluid/proto_serde.py``).

* ``program_to_proto_bytes`` / ``program_from_proto_bytes`` — the IR
  (fluid/framework.py Program/Block/Operator/Variable) to and from the
  ProgramDesc wire format of ``proto/framework.proto``, with the
  OpVersionMap of fluid/op_version_registry.py.  The messages are the
  port's own codec (``proto/framework_pb2.py``), byte for byte what the
  TPU package's protobuf classes write, so a ``__model__`` saved by
  either package (or by the reference, python/paddle/fluid/io.py:1198)
  loads in the other.
* ``serialize_lod_tensor`` / ``deserialize_lod_tensor`` — the
  reference's binary tensor stream (lod_tensor.cc:243 SerializeToStream
  + tensor_util.cc:666 TensorToStream): uint32 version, LoD level table,
  TensorDesc message, raw data; the format of the reference's per-var
  param files and of save_combine.  A stream reads back as a CPU torch
  tensor: bfloat16 is read as its raw 2-byte words viewed as
  ``torch.bfloat16``, so no bfloat16 numpy type is needed.

Attr typing on save follows the value (bool -> BOOLEAN before int -> INT/
LONG by range, float -> FLOAT, str -> STRING, lists likewise); block-ref
attrs (the control-flow ops carry sub-block indices in _SUB_BLOCK_ATTRS)
are written as BLOCK so the reference reader sees real block references.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np
import torch

from .framework import (Block, Operator, Parameter, Program, Variable,
                        _PROTO_DTYPE, _SUB_BLOCK_ATTRS)
from . import op_version_registry as opver
from .proto import framework_pb2 as fp

__all__ = ["program_to_proto_bytes", "program_from_proto_bytes",
           "program_to_proto", "program_from_proto",
           "serialize_lod_tensor", "deserialize_lod_tensor",
           "save_combined_params", "load_combined_params",
           "strip_feed_fetch_ops"]

_DTYPE_TO_PROTO = {name: code for code, name in _PROTO_DTYPE.items()}

# attr names whose int value is a block index; written with AttrType.BLOCK
_BLOCK_ATTRS = _SUB_BLOCK_ATTRS

_INT32_MIN, _INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def _to_plain(v):
    """numpy or torch scalars and arrays, and tuples -> plain python
    values."""
    if isinstance(v, torch.Tensor):
        return v.tolist()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, tuple):
        return list(v)
    return v


_JSON_ATTR_TAG = "__pdtpu_json__:"


def _set_attr(pb_attr, name: str, value, op_type: str) -> bool:
    """Fill one OpDesc.Attr; returns False when the value has no proto
    representation (caller decides whether that is fatal)."""
    value = _to_plain(value)
    pb_attr.name = name
    if name in _BLOCK_ATTRS and isinstance(value, int):
        pb_attr.type = fp.BLOCK
        pb_attr.block_idx = int(value)
    elif isinstance(value, bool):
        pb_attr.type = fp.BOOLEAN
        pb_attr.b = value
    elif isinstance(value, int):
        if _INT32_MIN <= value <= _INT32_MAX:
            pb_attr.type = fp.INT
            pb_attr.i = value
        else:
            pb_attr.type = fp.LONG
            pb_attr.l = value
    elif isinstance(value, float):
        pb_attr.type = fp.FLOAT
        pb_attr.f = value
    elif isinstance(value, str):
        pb_attr.type = fp.STRING
        pb_attr.s = value
    elif isinstance(value, dict):
        # dict attrs (the AMP plane's __amp_cast__ slot->dtypes map) ride
        # as tagged-JSON STRINGs: the reference reader sees an opaque
        # string attr it ignores; our reader round-trips the dict
        import json
        try:
            pb_attr.type = fp.STRING
            pb_attr.s = _JSON_ATTR_TAG + json.dumps(value, sort_keys=True)
        except (TypeError, ValueError):
            return False
    elif isinstance(value, list):
        items = [_to_plain(x) for x in value]
        if not items:
            # empty lists carry no element type; INTS is the dominant
            # empty-list attr in practice (axes/shape/offsets)
            pb_attr.type = fp.INTS
        elif all(isinstance(x, bool) for x in items):
            pb_attr.type = fp.BOOLEANS
            pb_attr.bools.extend(items)
        elif all(isinstance(x, int) for x in items):
            if all(_INT32_MIN <= x <= _INT32_MAX for x in items):
                pb_attr.type = fp.INTS
                pb_attr.ints.extend(items)
            else:
                pb_attr.type = fp.LONGS
                pb_attr.longs.extend(items)
        elif all(isinstance(x, (int, float)) for x in items):
            pb_attr.type = fp.FLOATS
            pb_attr.floats.extend(float(x) for x in items)
        elif all(isinstance(x, str) for x in items):
            pb_attr.type = fp.STRINGS
            pb_attr.strings.extend(items)
        else:
            return False
    else:
        return False
    return True


def _get_attr(pb_attr):
    t = pb_attr.type
    if t == fp.INT:
        return pb_attr.i
    if t == fp.FLOAT:
        return pb_attr.f
    if t == fp.STRING:
        if pb_attr.s.startswith(_JSON_ATTR_TAG):
            import json
            return json.loads(pb_attr.s[len(_JSON_ATTR_TAG):])
        return pb_attr.s
    if t == fp.INTS:
        return list(pb_attr.ints)
    if t == fp.FLOATS:
        return list(pb_attr.floats)
    if t == fp.STRINGS:
        return list(pb_attr.strings)
    if t == fp.BOOLEAN:
        return pb_attr.b
    if t == fp.BOOLEANS:
        return list(pb_attr.bools)
    if t == fp.BLOCK:
        return pb_attr.block_idx
    if t == fp.LONG:
        return pb_attr.l
    if t == fp.BLOCKS:
        return list(pb_attr.blocks_idx)
    if t == fp.LONGS:
        return list(pb_attr.longs)
    raise ValueError(f"unknown attr type {t}")


def _var_to_proto(v: Variable, pb_var) -> None:
    pb_var.name = v.name
    # FEED_MINIBATCH / FETCH_LIST holder vars (reference io.py:1151,1179)
    kind = getattr(v, "proto_var_type", None)
    if kind == "feed":
        pb_var.type.type = fp.VarType.FEED_MINIBATCH
        pb_var.persistable = True
        return
    if kind == "fetch":
        pb_var.type.type = fp.VarType.FETCH_LIST
        pb_var.persistable = True
        return
    pb_var.type.type = fp.VarType.LOD_TENSOR
    td = pb_var.type.lod_tensor.tensor
    td.data_type = _DTYPE_TO_PROTO.get(v.dtype or "float32",
                                       fp.VarType.FP32)
    if v.shape is not None:
        td.dims.extend(int(d) for d in v.shape)
    if v.persistable:
        pb_var.persistable = True
    if getattr(v, "is_data", False):
        pb_var.need_check_feed = True


def program_to_proto(program: Program) -> "fp.ProgramDesc":
    pb = fp.ProgramDesc()
    op_types = []
    for block in program.blocks:
        pb_block = pb.blocks.add()
        pb_block.idx = block.idx
        pb_block.parent_idx = block.parent_idx
        for v in block.vars.values():
            _var_to_proto(v, pb_block.vars.add())
        for op in block.ops:
            pb_op = pb_block.ops.add()
            pb_op.type = op.type
            op_types.append(op.type)
            for slot, names in op.inputs.items():
                pv = pb_op.inputs.add()
                pv.parameter = slot
                pv.arguments.extend(names)
            for slot, names in op.outputs.items():
                pv = pb_op.outputs.add()
                pv.parameter = slot
                pv.arguments.extend(names)
            for aname in sorted(op.attrs):
                aval = op.attrs[aname]
                if aval is None:
                    continue
                pb_attr = pb_op.attrs.add()
                if not _set_attr(pb_attr, aname, aval, op.type):
                    raise ValueError(
                        f"op '{op.type}' attr '{aname}' "
                        f"({type(aval).__name__}) has no ProgramDesc "
                        f"representation — not serializable")
    for op_type, version in sorted(opver.snapshot(op_types).items()):
        pair = pb.op_version_map.pair.add()
        pair.op_name = op_type
        pair.op_version.version = version
    return pb


def program_to_proto_bytes(program: Program) -> bytes:
    return program_to_proto(program).SerializeToString()


def program_from_proto(pb: "fp.ProgramDesc") -> Program:
    prog = Program()
    saved_vers = {pair.op_name: pair.op_version.version
                  for pair in pb.op_version_map.pair}
    # allocate blocks first so parent links and block-attrs resolve;
    # place by idx — the repeated field may arrive in any order
    n_blocks = max((b.idx for b in pb.blocks), default=0) + 1
    prog.blocks.extend(None for _ in range(n_blocks - 1))
    for pb_block in pb.blocks:
        if pb_block.idx == 0:
            prog.blocks[0].parent_idx = pb_block.parent_idx
        else:
            prog.blocks[pb_block.idx] = Block(prog, pb_block.idx,
                                              pb_block.parent_idx)
    missing = [i for i, b in enumerate(prog.blocks) if b is None]
    if missing:
        raise ValueError(f"ProgramDesc has gaps in block indices: {missing}")
    # fill vars/ops in INDEX order: parent-block vars must exist before a
    # child block's ops resolve names, or a shadow var appears in the
    # child (wire order is arbitrary for repeated fields)
    for pb_block in sorted(pb.blocks, key=lambda b: b.idx):
        block = prog.blocks[pb_block.idx]
        for pb_var in pb_block.vars:
            _var_from_proto(pb_var, block)
        for pb_op in pb_block.ops:
            attrs = {}
            for pb_attr in pb_op.attrs:
                attrs[pb_attr.name] = _get_attr(pb_attr)
            opver.check_and_convert(pb_op.type, attrs,
                                    saved_vers.get(pb_op.type, 0))
            op = Operator(
                block, pb_op.type,
                {v.parameter: list(v.arguments) for v in pb_op.inputs},
                {v.parameter: list(v.arguments) for v in pb_op.outputs},
                attrs)
            block.ops.append(op)
            for names in op.outputs.values():
                for n in names:
                    if block._find_var_recursive(n) is None:
                        block.create_var(name=n)
                    block._find_var_recursive(n).op = op
    prog._bump_version()
    return prog


def _var_from_proto(pb_var, block: Block) -> None:
    t = pb_var.type.type
    if t == fp.VarType.FEED_MINIBATCH:
        v = block.create_var(name=pb_var.name, dtype=None)
        v.proto_var_type = "feed"
        v.persistable = True
        return
    if t == fp.VarType.FETCH_LIST:
        v = block.create_var(name=pb_var.name, dtype=None)
        v.proto_var_type = "fetch"
        v.persistable = True
        return
    td = None
    if t == fp.VarType.LOD_TENSOR and pb_var.type.HasField("lod_tensor"):
        td = pb_var.type.lod_tensor.tensor
    elif t == fp.VarType.SELECTED_ROWS \
            and pb_var.type.HasField("selected_rows"):
        td = pb_var.type.selected_rows
    elif t == fp.VarType.LOD_TENSOR_ARRAY \
            and pb_var.type.HasField("tensor_array"):
        td = pb_var.type.tensor_array.tensor
    shape = list(td.dims) if td is not None and len(td.dims) else None
    dtype = _PROTO_DTYPE.get(td.data_type, "float32") if td is not None \
        else None
    if pb_var.persistable and shape is not None \
            and t == fp.VarType.LOD_TENSOR:
        v = Parameter(block, pb_var.name, shape, dtype=dtype)
        block.vars[pb_var.name] = v
    else:
        v = block.create_var(name=pb_var.name, shape=shape, dtype=dtype,
                             persistable=pb_var.persistable,
                             is_data=pb_var.need_check_feed)


def program_from_proto_bytes(data: bytes) -> Program:
    pb = fp.ProgramDesc()
    pb.ParseFromString(data)
    return program_from_proto(pb)


def strip_feed_fetch_ops(program: Program
                         ) -> Tuple[List[str], List[str]]:
    """Remove reference-style feed/fetch ops from block 0 (the loader's
    PrepareProgram step, reference analysis_predictor.cc:199) and return
    (feed_names, fetch_names) ordered by their `col` attr."""
    block = program.global_block()
    feeds: List[Tuple[int, str]] = []
    fetches: List[Tuple[int, str]] = []
    kept = []
    for op in block.ops:
        if op.type == "feed":
            feeds.append((op.attrs.get("col", len(feeds)),
                          op.outputs["Out"][0]))
        elif op.type == "fetch":
            fetches.append((op.attrs.get("col", len(fetches)),
                            op.inputs["X"][0]))
        else:
            kept.append(op)
    if len(kept) != len(block.ops):
        block.ops[:] = kept
        program._bump_version()
    return ([n for _, n in sorted(feeds)], [n for _, n in sorted(fetches)])


# ---------------------------------------------------------------------------
# reference binary tensor streams (lod_tensor.cc:243 / tensor_util.cc:666)
# ---------------------------------------------------------------------------

def _raw(arr) -> Tuple[str, tuple, bytes]:
    """(dtype name, shape, C-order bytes) of a numpy array or a torch
    tensor; bfloat16 (a torch tensor, or a numpy array of a bfloat16
    extension type) by its 2-byte words."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:
            return name, tuple(t.shape), t.view(torch.int16).numpy() \
                .tobytes()
        return name, tuple(t.shape), t.numpy().tobytes()
    arr = np.ascontiguousarray(arr)
    return arr.dtype.name, arr.shape, arr.tobytes()


def serialize_lod_tensor(arr, lod=()) -> bytes:
    """One LoDTensor stream: uint32 version(0) | uint64 n_lod_levels
    {uint64 level_bytes, size_t[] level} | uint32 tensor version(0) |
    int32 desc_len, TensorDesc message | raw data (C order)."""
    name, shape, data = _raw(arr)
    if name not in _DTYPE_TO_PROTO:
        raise ValueError(f"dtype {name} not in the VarType contract")
    out = [struct.pack("<I", 0), struct.pack("<Q", len(lod))]
    for level in lod:
        level = np.ascontiguousarray(level, dtype=np.uint64)
        out.append(struct.pack("<Q", level.nbytes))
        out.append(level.tobytes())
    desc = fp.VarType.TensorDesc()
    desc.data_type = _DTYPE_TO_PROTO[name]
    desc.dims.extend(int(d) for d in shape)
    desc_bytes = desc.SerializeToString()
    out.append(struct.pack("<I", 0))                 # tensor version
    out.append(struct.pack("<i", len(desc_bytes)))
    out.append(desc_bytes)
    out.append(data)
    return b"".join(out)


_PROTO_TO_NP = {
    fp.VarType.BOOL: np.bool_, fp.VarType.INT16: np.int16,
    fp.VarType.INT32: np.int32, fp.VarType.INT64: np.int64,
    fp.VarType.FP16: np.float16, fp.VarType.FP32: np.float32,
    fp.VarType.FP64: np.float64, fp.VarType.UINT8: np.uint8,
    fp.VarType.INT8: np.int8,
    # bfloat16's 2-byte words, viewed as torch.bfloat16 after the read
    fp.VarType.BF16: np.int16,
}


def deserialize_lod_tensor(buf: bytes, offset: int = 0
                           ) -> Tuple[torch.Tensor, list, int]:
    """Parse one LoDTensor stream at `offset`; returns (CPU tensor, lod,
    next_offset) so combined files (save_combine) parse by iteration."""
    (version,) = struct.unpack_from("<I", buf, offset)
    offset += 4
    if version != 0:
        raise ValueError(f"unsupported LoDTensor stream version {version}")
    (n_levels,) = struct.unpack_from("<Q", buf, offset)
    offset += 8
    lod = []
    for _ in range(n_levels):
        (nbytes,) = struct.unpack_from("<Q", buf, offset)
        offset += 8
        level = np.frombuffer(buf, np.uint64, nbytes // 8, offset)
        lod.append(level.tolist())
        offset += nbytes
    (tversion,) = struct.unpack_from("<I", buf, offset)
    offset += 4
    if tversion != 0:
        raise ValueError(f"unsupported Tensor stream version {tversion}")
    (desc_len,) = struct.unpack_from("<i", buf, offset)
    offset += 4
    desc = fp.VarType.TensorDesc()
    desc.ParseFromString(bytes(buf[offset:offset + desc_len]))
    offset += desc_len
    np_dtype = np.dtype(_PROTO_TO_NP[desc.data_type])
    count = int(np.prod(desc.dims)) if len(desc.dims) else 1
    arr = np.frombuffer(buf, np_dtype, count, offset).reshape(
        tuple(desc.dims))
    offset += count * np_dtype.itemsize
    t = torch.from_numpy(arr.copy())
    if desc.data_type == fp.VarType.BF16:
        t = t.view(torch.bfloat16)
    return t, lod, offset


def save_combined_params(path: str, arrays: Dict[str, object]) -> None:
    """save_combine format: LoDTensor streams concatenated in sorted-name
    order (reference io.py save_vars sorts the combined var list); the
    values are numpy arrays or torch tensors."""
    with open(path, "wb") as f:
        for name in sorted(arrays):
            f.write(serialize_lod_tensor(arrays[name]))


def load_combined_params(path: str, names: List[str]
                         ) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        buf = f.read()
    out, offset = {}, 0
    for name in sorted(names):
        arr, _lod, offset = deserialize_lod_tensor(buf, offset)
        out[name] = arr
    if offset != len(buf):
        raise ValueError(
            f"combined params file has {len(buf) - offset} trailing bytes "
            f"after reading {len(names)} tensors — name list mismatch")
    return out
