"""Program/Block/Operator/Variable IR — the fluid graph model.

Counterpart of ``paddle_tpu/fluid/framework.py``: the same two-program
idiom (startup/main), named variadic input/output slots, persistable
vars, op-seed assignment, ``clone(for_test=True)`` and reachability
pruning.  Execution differs: the port's executor interprets a block op by
op, eagerly, on torch tensors (executor.py).

Shape inference runs each op's own lowering rule on ``meta`` tensors
(shape and dtype only, no storage, no compute), with 1031 standing in for
a dynamic (-1) dim exactly as the TPU package does under
``jax.eval_shape``.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_dtype_aliases = {
    "float32": "float32", "fp32": "float32", np.float32: "float32",
    "float64": "float64", "fp64": "float64", np.float64: "float64",
    "float16": "float16", "fp16": "float16", np.float16: "float16",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int64": "int64", np.int64: "int64",
    "int32": "int32", np.int32: "int32",
    "int16": "int16", "int8": "int8", "uint8": "uint8",
    "bool": "bool", bool: "bool",
}

# framework.proto VarType.Type enum values — cast-op attrs and saved
# OpDescs carry these ints, not strings
_PROTO_DTYPE = {0: "bool", 1: "int16", 2: "int32", 3: "int64",
                4: "float16", 5: "float32", 6: "float64", 20: "uint8",
                21: "int8", 22: "bfloat16"}


def convert_dtype(dtype) -> str:
    """Normalise a user dtype spec (string, numpy or torch dtype, proto
    enum int) to a canonical string name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, (int, np.integer)) \
            and not isinstance(dtype, bool) and int(dtype) in _PROTO_DTYPE:
        return _PROTO_DTYPE[int(dtype)]
    if dtype in _dtype_aliases:
        return _dtype_aliases[dtype]
    try:
        return np.dtype(dtype).name
    except TypeError:
        raise ValueError(f"unsupported dtype: {dtype!r}") from None


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for a dtype spec.  Unlike the TPU package, 64-bit
    names stay 64-bit: ids are int64 on the card."""
    return getattr(torch, convert_dtype(dtype))


_name_counters: Dict[str, itertools.count] = {}


def unique_name(prefix: str = "tmp") -> str:
    """fluid.unique_name analog: the same ``<prefix>_<n>`` sequence as
    the TPU package, so both packages name every var alike."""
    c = _name_counters.setdefault(prefix, itertools.count())
    return f"{prefix}_{next(c)}"


def reset_unique_name():
    _name_counters.clear()


class Variable:
    """A named tensor in a Block (VarDesc analog).  Shape/dtype are
    advisory IR metadata; -1 marks a dynamic (batch) dim."""

    def __init__(self, block: "Block", name: str, shape=None, dtype="float32",
                 persistable: bool = False, stop_gradient: bool = False,
                 is_data: bool = False, trainable: bool = True):
        self.block = block
        self.name = name
        self.shape = tuple(int(d) for d in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.trainable = trainable
        self.op: Optional[Operator] = None   # defining op (set by append_op)

    # graph-building sugar: each operator appends its elementwise op
    def _binary(self, op_type, other, reverse=False):
        from . import layers
        other = layers.tensor._to_variable(self.block, other, self.dtype)
        x, y = (other, self) if reverse else (self, other)
        return layers.elementwise_op(op_type, x, y)

    def __add__(self, o):
        return self._binary("elementwise_add", o)

    def __radd__(self, o):
        return self._binary("elementwise_add", o, True)

    def __mul__(self, o):
        return self._binary("elementwise_mul", o)

    def __rmul__(self, o):
        return self._binary("elementwise_mul", o, True)

    def __sub__(self, o):
        return self._binary("elementwise_sub", o)

    def __rsub__(self, o):
        return self._binary("elementwise_sub", o, True)

    def __truediv__(self, o):
        return self._binary("elementwise_div", o)

    def __rtruediv__(self, o):
        return self._binary("elementwise_div", o, True)

    def __pow__(self, o):
        return self._binary("elementwise_pow", o)

    def __rpow__(self, o):
        return self._binary("elementwise_pow", o, True)

    def __floordiv__(self, o):
        return self._binary("elementwise_floordiv", o)

    def __rfloordiv__(self, o):
        return self._binary("elementwise_floordiv", o, True)

    def __mod__(self, o):
        return self._binary("elementwise_mod", o)

    def __rmod__(self, o):
        return self._binary("elementwise_mod", o, True)

    def __neg__(self):
        from . import layers
        return layers.scale(self, scale=-1.0)

    def __matmul__(self, o):
        from . import layers
        return layers.matmul(self, o)

    @property
    def ndim(self):
        return len(self.shape) if self.shape is not None else None

    def __repr__(self):
        return (f"Variable(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, persistable={self.persistable})")


class Parameter(Variable):
    """Persistable trainable variable."""

    def __init__(self, block, name, shape, dtype="float32", trainable=True,
                 regularizer=None, need_clip=True, **kw):
        super().__init__(block, name, shape=shape, dtype=dtype,
                         persistable=True, stop_gradient=not trainable,
                         trainable=trainable)
        self.regularizer = regularizer
        self.need_clip = need_clip


class Operator:
    """OpDesc analog: type + named input/output var-name lists + attrs."""

    def __init__(self, block: "Block", type: str,
                 inputs: Dict[str, List[str]], outputs: Dict[str, List[str]],
                 attrs: Optional[Dict[str, Any]] = None):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.outputs = {k: list(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for v in self.inputs.values() for n in v]

    @property
    def output_arg_names(self):
        return [n for v in self.outputs.values() for n in v]

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def set_attr(self, name: str, val) -> None:
        """Mutate an attr in place, bumping the program's mutation
        version so the executor's cached run plan is rebuilt."""
        self.attrs[name] = val
        self.block.program._bump_version()

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"


class Block:
    """BlockDesc analog: ordered ops + named vars, with parent scoping."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"variable '{name}' not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def create_var(self, name=None, shape=None, dtype="float32",
                   persistable=False, stop_gradient=False, is_data=False,
                   **kw) -> Variable:
        name = name or unique_name()
        v = Variable(self, name, shape=shape, dtype=dtype,
                     persistable=persistable, stop_gradient=stop_gradient,
                     is_data=is_data)
        self.vars[name] = v
        return v

    def create_parameter(self, name, shape, dtype="float32", trainable=True,
                         **kw) -> Parameter:
        p = Parameter(self, name, shape, dtype=dtype, trainable=trainable, **kw)
        # parameters live in block 0 (fluid global block convention)
        self.program.global_block().vars[name] = p
        return p

    def append_op(self, type: str, inputs: Dict[str, Any] = None,
                  outputs: Dict[str, Any] = None,
                  attrs: Dict[str, Any] = None) -> Operator:
        def norm(d):
            out = {}
            for k, v in (d or {}).items():
                if v is None:
                    continue
                if isinstance(v, (Variable, str)):
                    v = [v]
                out[k] = [x.name if isinstance(x, Variable) else x for x in v]
            return out
        op = Operator(self, type, norm(inputs), norm(outputs), attrs)
        self.ops.append(op)
        self.program._bump_version()
        for names in op.outputs.values():
            for n in names:
                if self._find_var_recursive(n) is None:
                    self.create_var(name=n)
                var = self._find_var_recursive(n)
                var.op = op
        _infer_op_shapes(self, op)
        return op

    def _remove_op(self, index: int, end: Optional[int] = None):
        """Remove ``ops[index:end]``, bumping the mutation version."""
        del self.ops[index:(index + 1) if end is None else end]
        self.program._bump_version()

    def _insert_op(self, index: int, type: str, inputs=None, outputs=None,
                   attrs=None) -> Operator:
        """Build an op exactly like append_op and place it at ``index``."""
        op = self.append_op(type, inputs, outputs, attrs)
        self.ops.insert(index, self.ops.pop())
        return op

    def _insert_op_obj(self, index: int, op: Operator) -> Operator:
        """Insert an already-constructed Operator at ``index`` (the
        pattern-rewriter path)."""
        self.ops.insert(index, op)
        for names in op.outputs.values():
            for n in names:
                if self._find_var_recursive(n) is None:
                    self.create_var(name=n)
        self.program._bump_version()
        return op

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.program.global_block().vars.values()
                if isinstance(v, Parameter)]


class Program:
    """ProgramDesc analog: layer calls append compute ops to the *main*
    program and parameter-initialisation ops to the *startup* program."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed: Optional[int] = None
        self._op_seed_counter = 0
        # annotations consumed by the executor and the serving plane
        self._hints: Dict[str, Any] = {}
        # bumped on every op mutation; keys the executor's run plans
        self._version = 0

    def _bump_version(self):
        self._version += 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def next_op_seed(self) -> int:
        base = self.random_seed if self.random_seed is not None else 0
        self._op_seed_counter += 1
        return base * 1_000_003 + self._op_seed_counter

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return self.global_block().all_parameters()

    def clone(self, for_test: bool = False) -> "Program":
        """Structural clone; with for_test=True marks inference mode
        (dropout switches to eval behaviour via ctx.is_test), strips the
        backward/optimizer tail, and prunes by reachability."""
        import copy
        p = copy.deepcopy(self)
        if for_test:
            p._hints["is_test"] = True
            for b in p.blocks:
                b.ops = [op for op in b.ops
                         if op.attr("op_role", 0) == 0 and
                         not op.type.endswith("_grad") and
                         op.type not in _OPTIMIZER_OP_TYPES]
            for b in p.blocks:
                b.ops = prune_ops(b, b.ops, targets=None,
                                  keep_state_writes=False)
        p._bump_version()
        return p

    def __repr__(self):
        n_ops = sum(len(b.ops) for b in self.blocks)
        return f"Program(blocks={len(self.blocks)}, ops={n_ops})"


_BATCH_PLACEHOLDER = 1031   # prime stand-in for -1 dims during inference


def _infer_op_shapes(block: "Block", op: "Operator"):
    """Advisory shape/dtype inference: run the op's own lowering rule on
    ``meta`` tensors.  Ops without a lowering, or whose lowering needs
    concrete values, leave their outputs' shapes unset — and a kernel-tier
    pass that needs a shape then declines to rewrite."""
    from ..ops.registry import has_op, get_op, LoweringContext
    if not has_op(op.type):
        return
    opdef = get_op(op.type)
    ins = {}
    had_batch = False
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            v = block._find_var_recursive(n)
            if v is None or v.shape is None or v.dtype is None:
                return
            shape = tuple(_BATCH_PLACEHOLDER if d == -1 else d
                          for d in v.shape)
            had_batch = had_batch or (-1 in v.shape)
            vals.append(torch.empty(shape, dtype=torch_dtype(v.dtype),
                                    device="meta"))
        ins[slot] = vals
    ctx = LoweringContext(device=torch.device("meta"))
    try:
        outs = opdef.fn(ins, op.attrs, ctx)
    except (RuntimeError, ValueError, TypeError, IndexError, KeyError,
            NotImplementedError):
        return
    for slot, names in op.outputs.items():
        for name, o in zip(names, outs.get(slot, []) or []):
            var = block._find_var_recursive(name)
            if var is None or o is None:
                continue
            if var.shape is None:
                var.shape = tuple(
                    -1 if (had_batch and d == _BATCH_PLACEHOLDER) else d
                    for d in o.shape)
            if var.dtype is None or var.dtype == "float32":
                var.dtype = convert_dtype(o.dtype)


_OPTIMIZER_OP_TYPES = frozenset({
    "sgd", "momentum", "adam", "adamw", "adagrad", "rmsprop", "lamb",
    "lars_momentum", "ftrl", "dpsgd", "dgc_momentum",
    "fused_adam", "fused_lamb", "fused_momentum",
})

# ops kept during pruning regardless of reachability: cross-device and
# control-flow effects the dataflow scan can't see
_SIDE_EFFECT_OP_TYPES = frozenset({
    "send_v2", "partial_send", "barrier", "c_sync_calc_stream",
    "c_sync_comm_stream", "while", "conditional_block", "py_func", "print",
})

_SUB_BLOCK_ATTRS = ("sub_block", "cond_block", "true_block", "false_block")


def _op_reads(block, op, _seen=None):
    """All vars an op may read, including captures of its control-flow
    sub-blocks."""
    reads = list(op.input_arg_names)
    if (op.type == "conditional_block"
            and op.attrs.get("false_block", -1) < 0):
        reads += list(op.attrs.get("true_outs", ()))
    _seen = _seen if _seen is not None else set()
    prog = block.program
    for attr in _SUB_BLOCK_ATTRS:
        idx = op.attrs.get(attr)
        if isinstance(idx, int) and 0 <= idx < len(prog.blocks) \
                and idx not in _seen:
            _seen.add(idx)
            sub = prog.blocks[idx]
            written = set()
            for sop in sub.ops:
                reads += [n for n in _op_reads(sub, sop, _seen)
                          if n not in written]
                written.update(sop.output_arg_names)
    return reads


def prune_ops(block, ops, targets=None, keep_state_writes=True,
              extra_state=(), feeds=()):
    """Backward-reachability prune (framework/prune.cc analog).

    Keeps an op iff it (a) produces a var in the needed set, seeded from
    ``targets`` (None = every non-persistable leaf output), (b) writes a
    persistable or ``extra_state`` var while ``keep_state_writes``, or
    (c) has side effects the dataflow can't see.  ``feeds`` names vars the
    caller materialises directly: an op whose needed outputs are all fed
    is dropped and its inputs are not traversed."""
    def persistable(n):
        v = block._find_var_recursive(n)
        return v is not None and v.persistable

    extra = set(extra_state)
    fed = set(feeds)
    if targets is None:
        consumed = {n for op in ops for n in _op_reads(block, op)}
        needed = {n for op in ops for n in op.output_arg_names
                  if n not in consumed and not persistable(n)}
    else:
        needed = set(targets)
    kept = []
    for op in reversed(ops):
        outs = op.output_arg_names
        state_write = keep_state_writes and any(
            persistable(n) or n in extra for n in outs)
        needed_outs = [n for n in outs if n in needed]
        if (fed and needed_outs and not state_write
                and op.type not in _SIDE_EFFECT_OP_TYPES
                and all(n in fed for n in needed_outs)
                and not (set(needed_outs) & set(_op_reads(block, op)))):
            continue          # feed satisfies everything this op is for
        keep = (op.type in _SIDE_EFFECT_OP_TYPES or needed_outs
                or state_write)
        if keep:
            kept.append(op)
            needed.update(_op_reads(block, op))
    kept.reverse()
    return kept


# the dtype layers give parameters created without one
_DEFAULT_DTYPE = "float32"
_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def set_default_dtype(d) -> None:
    """The dtype layers use for parameters created without one."""
    global _DEFAULT_DTYPE
    try:
        name = convert_dtype(d)
    except (TypeError, ValueError):
        name = str(d)
    if name not in _FLOAT_DTYPES:
        raise TypeError(
            f"set_default_dtype only supports {_FLOAT_DTYPES}, got {name!r}")
    _DEFAULT_DTYPE = name


def get_default_dtype() -> str:
    return _DEFAULT_DTYPE


# ---------------------------------------------------------------------------
# default program machinery
# ---------------------------------------------------------------------------
_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    prev_main, prev_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = prev_main, prev_startup


# ---------------------------------------------------------------------------
# the place entry points default to: the card unless paddle.set_device
# named another
# ---------------------------------------------------------------------------
_expected_place = None


def _set_expected_place(place) -> None:
    global _expected_place
    _expected_place = place


def _current_expected_place():
    from . import core
    return _expected_place if _expected_place is not None \
        else core.CUDAPlace(0)


# ---------------------------------------------------------------------------
# dygraph mode: the active tracer (dygraph/base.py), None in static mode
# ---------------------------------------------------------------------------
_dygraph_tracer_ = None


def in_dygraph_mode() -> bool:
    return _dygraph_tracer_ is not None


def _set_dygraph_tracer(tracer):
    global _dygraph_tracer_
    _dygraph_tracer_ = tracer


def _dygraph_tracer():
    return _dygraph_tracer_
