"""The ProgramDesc messages of ``framework.proto``, written by hand.

The TPU package reads and writes ``__model__`` through the module that
``protoc`` generates from ``framework.proto``; the card's machine has no
protobuf package, so this module is the port's own codec of the same
schema.  It gives the names that generated code gives (``ProgramDesc``,
``OpDesc.Attr``, ``VarType.FP32``, ``fp.BLOCK``, ``AttrType.Name``) and
the part of the generated classes' API the port uses: fields as
attributes, ``add``/``append``/``extend`` on repeated fields,
``HasField``, ``ClearField``, ``CopyFrom``, ``SerializeToString``,
``ParseFromString`` and ``FromString``.

The bytes are protobuf's own, by proto2's rules:

* fields go out in field-number order, each repeated element as its own
  tag (the schema declares nothing ``[packed]``);
* a singular field goes out when it was set (to any value, its default
  included), a ``required`` one always;
* integers and enums are varints, a negative ``int32`` or ``int64`` as
  ten bytes; ``float`` is little-endian fixed32 (a value reads back
  rounded to float32, as the generated classes give it), ``bool`` a
  varint, strings UTF-8 with a length;
* on parse, a repeated scalar field is read packed or unpacked, a
  singular message met twice is merged, and a field number the schema
  does not know is skipped.

Reading an unset message field returns an empty message that joins its
parent the first time one of its fields is set, as in generated code:
``var.type.lod_tensor.tensor.data_type = FP32`` sets every level.
``text_format`` prints a message in protobuf's text format
(``Program.to_string``).
"""
from __future__ import annotations

import math
import struct
from typing import Dict, Tuple

__all__ = ["Version", "AttrType", "OpDesc", "VarType", "VarDesc",
           "BlockDesc", "OpVersion", "OpVersionMap", "ProgramDesc",
           "DecodeError", "EnumTypeWrapper", "text_format"]


class DecodeError(ValueError):
    """The bytes are no message of this type."""


class EnumTypeWrapper:
    """An enum's names and values (``Name``, ``Value``, ``keys``,
    ``values``, ``items``), as generated code exposes them."""

    def __init__(self, name: str, pairs):
        self.name = name
        self._by_name = dict(pairs)
        self._by_value = {}
        for k, v in pairs:
            self._by_value.setdefault(v, k)

    def Name(self, number: int) -> str:
        try:
            return self._by_value[number]
        except KeyError:
            raise ValueError(f"enum {self.name} has no value {number}") \
                from None

    def Value(self, name: str) -> int:
        try:
            return self._by_name[name]
        except KeyError:
            raise ValueError(f"enum {self.name} has no name {name!r}") \
                from None

    def keys(self):
        return list(self._by_name)

    def values(self):
        return list(self._by_name.values())

    def items(self):
        return list(self._by_name.items())


# --- wire primitives ---------------------------------------------------------
_VARINT, _FIXED64, _LEN, _START_GROUP, _END_GROUP, _FIXED32 = 0, 1, 2, 3, 4, 5
_INT32, _INT64, _BOOL, _ENUM, _STRING, _FLOAT, _MESSAGE = (
    "int32", "int64", "bool", "enum", "string", "float", "message")
_WIRE = {_INT32: _VARINT, _INT64: _VARINT, _BOOL: _VARINT, _ENUM: _VARINT,
         _STRING: _LEN, _FLOAT: _FIXED32, _MESSAGE: _LEN}
_OPTIONAL, _REQUIRED, _REPEATED = "optional", "required", "repeated"


def _varint(value: int) -> bytes:
    value &= (1 << 64) - 1          # a negative value: its 64-bit two's
    out = bytearray()               # complement, ten bytes
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than ten bytes")


def _signed(value: int, bits: int) -> int:
    value &= (1 << bits) - 1
    return value - (1 << bits) if value >> (bits - 1) else value


def _to_float32(value) -> float:
    """The float32 nearest ``value``, as a Python float (out of range:
    infinity, as a C cast gives it)."""
    value = float(value)
    try:
        return struct.unpack("<f", struct.pack("<f", value))[0]
    except OverflowError:
        return math.copysign(math.inf, value)


def _skip(buf, pos: int, wire: int, number: int) -> int:
    if wire == _VARINT:
        return _read_varint(buf, pos)[1]
    if wire == _FIXED64:
        return pos + 8
    if wire == _FIXED32:
        return pos + 4
    if wire == _LEN:
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire == _START_GROUP:
        while True:
            tag, pos = _read_varint(buf, pos)
            if tag & 7 == _END_GROUP:
                if tag >> 3 != number:
                    raise DecodeError("mismatched end of group")
                return pos
            pos = _skip(buf, pos, tag & 7, tag >> 3)
    raise DecodeError(f"field {number}: wire type {wire} is not valid here")


class _Field:
    __slots__ = ("number", "name", "kind", "label", "default", "msg", "enum")

    def __init__(self, number, name, kind, label=_OPTIONAL, default=None,
                 msg=None, enum=None):
        self.number, self.name, self.kind, self.label = number, name, kind, \
            label
        self.msg, self.enum = msg, enum
        if default is None and kind != _MESSAGE:
            default = {_STRING: "", _FLOAT: 0.0, _BOOL: False}.get(kind, 0)
        self.default = default

    def check(self, value):
        """``value`` as this field stores it; TypeError or ValueError for
        one the generated classes refuse."""
        k = self.kind
        if k == _STRING:
            if isinstance(value, bytes):
                value = value.decode("utf-8")
            if not isinstance(value, str):
                raise TypeError(f"{self.name}: {value!r} is no str")
            return value
        if k == _FLOAT:
            if isinstance(value, (str, bytes)) or not isinstance(
                    value, (int, float)) and not hasattr(value, "__float__"):
                raise TypeError(f"{self.name}: {value!r} is no number")
            return _to_float32(value)
        if k == _BOOL:
            return bool(value)
        if isinstance(value, bool) or not isinstance(value, int):
            if hasattr(value, "__index__") and not isinstance(value, bool):
                value = value.__index__()
            else:
                raise TypeError(f"{self.name}: {value!r} is no int")
        bits = 64 if k == _INT64 else 32
        if not -(1 << (bits - 1)) <= value < (1 << (bits - 1)):
            raise ValueError(f"{self.name}: {value} is out of int{bits} "
                             f"range")
        return int(value)

    def encode(self, value) -> bytes:
        k = self.kind
        if k == _STRING:
            data = value.encode("utf-8")
            return _varint(len(data)) + data
        if k == _MESSAGE:
            data = value.SerializeToString()
            return _varint(len(data)) + data
        if k == _FLOAT:
            return struct.pack("<f", value)
        return _varint(int(value))

    def decode(self, buf, pos: int, wire: int):
        """One value at ``pos`` (a packed run of them for a repeated
        scalar sent as one length); returns (values, next position)."""
        k = self.kind
        if wire == _LEN and k not in (_STRING, _MESSAGE):
            n, pos = _read_varint(buf, pos)
            end, vals = pos + n, []
            while pos < end:
                v, pos = self.decode(buf, pos, _WIRE[k])
                vals += v
            return vals, pos
        if wire != _WIRE[k]:
            raise DecodeError(f"field {self.name}: wire type {wire}, the "
                              f"schema says {_WIRE[k]}")
        if k == _FLOAT:
            return [struct.unpack_from("<f", buf, pos)[0]], pos + 4
        if k in (_STRING, _MESSAGE):
            n, pos = _read_varint(buf, pos)
            data = bytes(buf[pos:pos + n])
            if len(data) != n:
                raise DecodeError(f"field {self.name}: truncated")
            if k == _STRING:
                return [data.decode("utf-8")], pos + n
            return [self.msg.FromString(data)], pos + n
        v, pos = _read_varint(buf, pos)
        if k == _BOOL:
            return [bool(v)], pos
        return [_signed(v, 64 if k == _INT64 else 32)], pos


class _Repeated(list):
    """A repeated field: a list whose changes mark its owner present.
    Scalars are checked on the way in; ``add`` builds a message
    element."""

    def __init__(self, owner, field):
        super().__init__()
        self._owner, self._field = owner, field

    def _in(self, value):
        f = self._field
        if f.kind == _MESSAGE:
            if not isinstance(value, f.msg):
                raise TypeError(f"{f.name}: {value!r} is no {f.msg.__name__}")
            return value
        return f.check(value)

    def append(self, value):
        super().append(self._in(value))
        self._owner._mark()

    def extend(self, values):
        super().extend([self._in(v) for v in values])
        self._owner._mark()

    def insert(self, i, value):
        super().insert(i, self._in(value))
        self._owner._mark()

    def add(self, **kw):
        if self._field.kind != _MESSAGE:
            raise AttributeError("add() is for repeated message fields")
        m = self._field.msg(**kw)
        super().append(m)
        self._owner._mark()
        return m

    def __setitem__(self, i, value):
        if isinstance(i, slice):
            value = [self._in(v) for v in value]
        else:
            value = self._in(value)
        super().__setitem__(i, value)

    def __iadd__(self, values):
        self.extend(values)
        return self

    def __eq__(self, other):
        return list(self) == list(other)

    __hash__ = None


class Message:
    """One message type of the schema; subclasses set ``_FIELDS``."""

    _FIELDS: Tuple[_Field, ...] = ()
    _BY_NAME: Dict[str, _Field] = {}
    _BY_NUMBER: Dict[int, _Field] = {}

    def __init__(self, **kw):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_lazy", {})
        object.__setattr__(self, "_parent", None)
        for f in self._FIELDS:
            if f.label == _REPEATED:
                self._values[f.name] = _Repeated(self, f)
        for k, v in kw.items():
            f = self._field(k)
            if f.label == _REPEATED:
                getattr(self, k).extend(v)
            elif f.kind == _MESSAGE:
                getattr(self, k).CopyFrom(v)
            else:
                setattr(self, k, v)

    @classmethod
    def _field(cls, name) -> _Field:
        try:
            return cls._BY_NAME[name]
        except KeyError:
            raise AttributeError(f"{cls.__name__} has no field {name!r}") \
                from None

    def _mark(self):
        """This message holds a value now: join the parent whose lazy
        read made it, up the chain."""
        parent = self._parent
        if parent is not None:
            owner, name = parent
            object.__setattr__(self, "_parent", None)
            owner._lazy.pop(name, None)
            owner._values[name] = self
            owner._mark()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._field(name)
        if name in self._values:
            return self._values[name]
        if f.kind == _MESSAGE:
            child = self._lazy.get(name)
            if child is None:
                child = f.msg()
                object.__setattr__(child, "_parent", (self, name))
                self._lazy[name] = child
            return child
        return f.default

    def __setattr__(self, name, value):
        f = self._field(name)
        if f.label == _REPEATED or f.kind == _MESSAGE:
            raise AttributeError(
                f"assignment to {type(self).__name__}.{name} is not "
                f"allowed: use {'extend' if f.label == _REPEATED else 'CopyFrom'}")
        self._values[name] = f.check(value)
        self._mark()

    def HasField(self, name) -> bool:
        f = self._field(name)
        if f.label == _REPEATED:
            raise ValueError(f"{name} is a repeated field")
        return name in self._values

    def ClearField(self, name) -> None:
        f = self._field(name)
        if f.label == _REPEATED:
            del self._values[name][:]
        else:
            self._values.pop(name, None)
            self._lazy.pop(name, None)

    def ListFields(self):
        """(field name, value) of each set field, by field number."""
        out = []
        for f in self._FIELDS:
            v = self._values.get(f.name)
            if v is None or (f.label == _REPEATED and not v):
                continue
            out.append((f.name, v))
        return out

    def CopyFrom(self, other) -> None:
        if other is self:
            return
        if type(other) is not type(self):
            raise TypeError(f"CopyFrom needs a {type(self).__name__}")
        for f in self._FIELDS:
            self.ClearField(f.name)
        self.MergeFrom(other)
        self._mark()

    def MergeFrom(self, other) -> None:
        for f in self._FIELDS:
            if f.name not in other._values:
                continue
            v = other._values[f.name]
            if f.label == _REPEATED:
                if f.kind == _MESSAGE:
                    for m in v:
                        self._values[f.name].add().MergeFrom(m)
                elif v:
                    self._values[f.name].extend(v)
            elif f.kind == _MESSAGE:
                getattr(self, f.name).MergeFrom(v)
            else:
                self._values[f.name] = v
        self._mark()

    def SerializeToString(self, **_kw) -> bytes:
        out = []
        for f in self._FIELDS:
            tag = _varint(f.number << 3 | _WIRE[f.kind])
            if f.label == _REPEATED:
                for v in self._values[f.name]:
                    out += (tag, f.encode(v))
                continue
            if f.name in self._values:
                v = self._values[f.name]
            elif f.label == _REQUIRED:
                v = f.msg() if f.kind == _MESSAGE else f.default
            else:
                continue
            out += (tag, f.encode(v))
        return b"".join(out)

    def MergeFromString(self, data) -> int:
        buf = memoryview(bytes(data))
        pos, end = 0, len(buf)
        while pos < end:
            tag, pos = _read_varint(buf, pos)
            number, wire = tag >> 3, tag & 7
            if number == 0:
                raise DecodeError("field number 0")
            f = self._BY_NUMBER.get(number)
            if f is None:
                pos = _skip(buf, pos, wire, number)
                continue
            vals, pos = f.decode(buf, pos, wire)
            if f.label == _REPEATED:
                list.extend(self._values[f.name], vals)
            elif f.kind == _MESSAGE:
                if f.name in self._values:
                    self._values[f.name].MergeFrom(vals[-1])
                else:
                    self._lazy.pop(f.name, None)
                    self._values[f.name] = vals[-1]
            else:
                self._values[f.name] = vals[-1]
        if pos != end:
            raise DecodeError("truncated message")
        self._mark()
        return end

    def ParseFromString(self, data) -> int:
        for f in self._FIELDS:
            self.ClearField(f.name)
        return self.MergeFromString(data)

    @classmethod
    def FromString(cls, data):
        m = cls()
        m.MergeFromString(data)
        return m

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return self.ListFields() == other.ListFields()

    __hash__ = None

    def __repr__(self):
        return text_format(self, indent=0).rstrip("\n")

    __str__ = __repr__


def _describe(cls, *fields):
    cls._FIELDS = tuple(sorted(fields, key=lambda f: f.number))
    cls._BY_NAME = {f.name: f for f in fields}
    cls._BY_NUMBER = {f.number: f for f in fields}


# --- the schema --------------------------------------------------------------
_ATTR_TYPES = (("INT", 0), ("FLOAT", 1), ("STRING", 2), ("INTS", 3),
               ("FLOATS", 4), ("STRINGS", 5), ("BOOLEAN", 6),
               ("BOOLEANS", 7), ("BLOCK", 8), ("LONG", 9), ("BLOCKS", 10),
               ("LONGS", 11))
AttrType = EnumTypeWrapper("AttrType", _ATTR_TYPES)
globals().update(dict(_ATTR_TYPES))
__all__ += [k for k, _ in _ATTR_TYPES]

_VAR_TYPES = (("BOOL", 0), ("INT16", 1), ("INT32", 2), ("INT64", 3),
              ("FP16", 4), ("FP32", 5), ("FP64", 6), ("SIZE_T", 19),
              ("UINT8", 20), ("INT8", 21), ("BF16", 22), ("COMPLEX64", 23),
              ("COMPLEX128", 24), ("LOD_TENSOR", 7), ("SELECTED_ROWS", 8),
              ("FEED_MINIBATCH", 9), ("FETCH_LIST", 10), ("STEP_SCOPES", 11),
              ("LOD_RANK_TABLE", 12), ("LOD_TENSOR_ARRAY", 13),
              ("PLACE_LIST", 14), ("READER", 15), ("RAW", 17), ("TUPLE", 18))


class Version(Message):
    pass


class OpDesc(Message):
    class Attr(Message):
        pass

    class Var(Message):
        pass


class VarType(Message):
    Type = EnumTypeWrapper("Type", _VAR_TYPES)

    class TensorDesc(Message):
        pass

    class LoDTensorDesc(Message):
        pass

    class LoDTensorArrayDesc(Message):
        pass

    class ReaderDesc(Message):
        pass

    class Tuple(Message):
        pass


for _k, _v in _VAR_TYPES:
    setattr(VarType, _k, _v)
del _k, _v


class VarDesc(Message):
    pass


class BlockDesc(Message):
    pass


class OpVersion(Message):
    pass


class OpVersionMap(Message):
    class OpVersionPair(Message):
        pass


class ProgramDesc(Message):
    pass


F = _Field
_describe(Version, F(1, "version", _INT64))
_describe(OpDesc.Attr,
          F(1, "name", _STRING, _REQUIRED),
          F(2, "type", _ENUM, _REQUIRED, enum=AttrType),
          F(3, "i", _INT32), F(4, "f", _FLOAT), F(5, "s", _STRING),
          F(6, "ints", _INT32, _REPEATED), F(7, "floats", _FLOAT, _REPEATED),
          F(8, "strings", _STRING, _REPEATED), F(10, "b", _BOOL),
          F(11, "bools", _BOOL, _REPEATED), F(12, "block_idx", _INT32),
          F(13, "l", _INT64), F(14, "blocks_idx", _INT32, _REPEATED),
          F(15, "longs", _INT64, _REPEATED))
_describe(OpDesc.Var, F(1, "parameter", _STRING, _REQUIRED),
          F(2, "arguments", _STRING, _REPEATED))
_describe(OpDesc,
          F(3, "type", _STRING, _REQUIRED),
          F(1, "inputs", _MESSAGE, _REPEATED, msg=OpDesc.Var),
          F(2, "outputs", _MESSAGE, _REPEATED, msg=OpDesc.Var),
          F(4, "attrs", _MESSAGE, _REPEATED, msg=OpDesc.Attr),
          F(5, "is_target", _BOOL))
_describe(VarType.TensorDesc,
          F(1, "data_type", _ENUM, _REQUIRED, enum=VarType.Type),
          F(2, "dims", _INT64, _REPEATED))
_describe(VarType.LoDTensorDesc,
          F(1, "tensor", _MESSAGE, _REQUIRED, msg=VarType.TensorDesc),
          F(2, "lod_level", _INT32))
_describe(VarType.LoDTensorArrayDesc,
          F(1, "tensor", _MESSAGE, _REQUIRED, msg=VarType.TensorDesc),
          F(2, "lod_level", _INT32))
_describe(VarType.ReaderDesc,
          F(1, "lod_tensor", _MESSAGE, _REPEATED, msg=VarType.LoDTensorDesc))
_describe(VarType.Tuple,
          F(1, "element_type", _ENUM, _REPEATED, enum=VarType.Type))
_describe(VarType,
          F(1, "type", _ENUM, _REQUIRED, enum=VarType.Type),
          F(2, "selected_rows", _MESSAGE, msg=VarType.TensorDesc),
          F(3, "lod_tensor", _MESSAGE, msg=VarType.LoDTensorDesc),
          F(4, "tensor_array", _MESSAGE, msg=VarType.LoDTensorArrayDesc),
          F(5, "reader", _MESSAGE, msg=VarType.ReaderDesc),
          F(7, "tuple", _MESSAGE, msg=VarType.Tuple))
_describe(VarDesc,
          F(1, "name", _STRING, _REQUIRED),
          F(2, "type", _MESSAGE, _REQUIRED, msg=VarType),
          F(3, "persistable", _BOOL), F(4, "need_check_feed", _BOOL))
_describe(BlockDesc,
          F(1, "idx", _INT32, _REQUIRED), F(2, "parent_idx", _INT32,
                                            _REQUIRED),
          F(3, "vars", _MESSAGE, _REPEATED, msg=VarDesc),
          F(4, "ops", _MESSAGE, _REPEATED, msg=OpDesc),
          F(5, "forward_block_idx", _INT32, default=-1))
_describe(OpVersion, F(1, "version", _INT32, _REQUIRED))
_describe(OpVersionMap.OpVersionPair,
          F(1, "op_name", _STRING, _REQUIRED),
          F(2, "op_version", _MESSAGE, _REQUIRED, msg=OpVersion))
_describe(OpVersionMap,
          F(1, "pair", _MESSAGE, _REPEATED, msg=OpVersionMap.OpVersionPair))
_describe(ProgramDesc,
          F(1, "blocks", _MESSAGE, _REPEATED, msg=BlockDesc),
          F(4, "version", _MESSAGE, msg=Version),
          F(5, "op_version_map", _MESSAGE, msg=OpVersionMap))
del F


# --- protobuf's text format --------------------------------------------------
_ESCAPES = {ord("\n"): r"\n", ord("\r"): r"\r", ord("\t"): r"\t",
            ord('"'): r"\"", ord("'"): r"\'", ord("\\"): r"\\"}


def _escape(s: str) -> str:
    """text_format's C escaping of a UTF-8 string: the six named escapes,
    other control bytes in octal, the rest as UTF-8."""
    out = []
    for ch in s:
        c = ord(ch)
        if c in _ESCAPES:
            out.append(_ESCAPES[c])
        elif c < 0x20 or c == 0x7F:
            out.append("\\%03o" % c)
        else:
            out.append(ch)
    return "".join(out)


def _shortest_float(value: float) -> str:
    """A float field's text: the fewest significant digits (six or more)
    that read back as the same float32."""
    if math.isnan(value):
        return "nan"
    if math.isinf(value):
        return "inf" if value > 0 else "-inf"
    precision = 6
    rounded = float("{0:.{1}g}".format(value, precision))
    while _to_float32(rounded) != value:
        precision += 1
        rounded = float("{0:.{1}g}".format(value, precision))
    return str(rounded)


def _text_value(f: _Field, v) -> str:
    if f.kind == _STRING:
        return '"' + _escape(v) + '"'
    if f.kind == _FLOAT:
        return _shortest_float(v)
    if f.kind == _BOOL:
        return "true" if v else "false"
    if f.kind == _ENUM:
        try:
            return f.enum.Name(v)
        except ValueError:
            return str(v)
    return str(v)


def text_format(msg: Message, indent: int = 0) -> str:
    """``msg`` in protobuf's text format, as
    ``google.protobuf.text_format.MessageToString`` prints it."""
    pad = " " * indent
    out = []
    for name, v in msg.ListFields():
        f = msg._BY_NAME[name]
        for item in (v if f.label == _REPEATED else [v]):
            if f.kind == _MESSAGE:
                out.append(f"{pad}{name} {{\n")
                out.append(text_format(item, indent + 2))
                out.append(f"{pad}}}\n")
            else:
                out.append(f"{pad}{name}: {_text_value(f, item)}\n")
    return "".join(out)
