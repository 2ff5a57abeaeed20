"""Control-flow layers (counterpart of
``paddle_tpu/fluid/layers/control_flow.py``): the comparisons and logical
ops, ``cond``, ``while_loop``, ``While``, ``Switch``, ``case``,
``switch_case``, ``IfElse``, ``StaticRNN``, the tensor arrays, ``Print``
and ``Assert``.

Each builder records its bodies as sub-blocks of the program
(``Program._create_block``) and appends the ``while`` or
``conditional_block`` op the executor runs through
``fluid/control_flow_impl.py``.  As in the reference, ``cond`` records
both branches in one ``conditional_block``, and ``Switch`` makes one
``conditional_block`` per arm whose predicate is its case and none of
the earlier ones.  Where the reference keeps a tensor array as a Python
list built with the program, the port appends ``write_to_array`` and
``read_from_array`` ops, which read their index where they run; and
``StaticRNN`` builds its step block into the ``recurrent`` op, which the
reference's op runs but its builder does not reach.
"""
from __future__ import annotations

from ..framework import (Variable, default_main_program, in_dygraph_mode,
                         unique_name)
from ..layer_helper import LayerHelper
from . import nn as _nn
from .tensor import assign, fill_constant


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp("not_equal", x, y, cond)


def _cmp(op_type, x, y, out=None):
    helper = LayerHelper(op_type)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool",
                                                        stop_gradient=True)
    op = helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                          outputs={"Out": [out]})
    return op["Out"][0] if in_dygraph_mode() else out


def logical_and(x, y, out=None):
    return _cmp("logical_and", x, y, out)


def logical_or(x, y, out=None):
    return _cmp("logical_or", x, y, out)


def logical_not(x, out=None):
    helper = LayerHelper("logical_not")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype="bool",
                                                        stop_gradient=True)
    op = helper.append_op("logical_not", inputs={"X": [x]},
                          outputs={"Out": [out]})
    return op["Out"][0] if in_dygraph_mode() else out


def increment(x, value=1.0, in_place=True):
    from .tensor import increment as _inc
    return _inc(x, value, in_place)


def _names(res):
    items = list(res) if isinstance(res, (list, tuple)) else [res]
    return items, [v.name for v in items if v is not None]


def cond(pred, true_fn=None, false_fn=None, name=None):
    """Two branches, each a sub-block, in one ``conditional_block``;
    returns the outputs (a tuple when the branches return a sequence)."""
    if in_dygraph_mode():
        if bool(pred.numpy().reshape(-1)[0]):
            return true_fn() if true_fn else None
        return false_fn() if false_fn else None
    program = default_main_program()
    parent_idx = program.current_block_idx

    tb = program._create_block(parent_idx)
    t_res = true_fn() if true_fn else None
    t_list, t_names = _names(t_res)
    program.current_block_idx = parent_idx

    fb = program._create_block(parent_idx)
    f_res = false_fn() if false_fn else None
    _, f_names = _names(f_res)
    program.current_block_idx = parent_idx

    helper = LayerHelper("cond", name=name)
    outs = [helper.create_variable_for_type_inference(
        dtype=v.dtype if v is not None else "float32") for v in t_list]
    helper.append_op(
        "conditional_block", inputs={"Cond": [pred]},
        outputs={"Out": outs},
        attrs={"true_block": tb.idx, "false_block": fb.idx,
               "true_outs": t_names, "false_outs": f_names})
    if isinstance(t_res, (list, tuple)):
        return tuple(outs)
    return outs[0]


def while_loop(cond_fn, body_fn, loop_vars, is_test=False, name=None):
    """Run ``body_fn`` while ``cond_fn`` holds; the body's results are
    assigned back onto the loop vars, so they carry across trips."""
    if in_dygraph_mode():
        while bool(cond_fn(*loop_vars).numpy().reshape(-1)[0]):
            loop_vars = body_fn(*loop_vars)
            if not isinstance(loop_vars, (list, tuple)):
                loop_vars = [loop_vars]
        return loop_vars
    program = default_main_program()
    parent_idx = program.current_block_idx

    cb = program._create_block(parent_idx)
    c = cond_fn(*loop_vars)
    program.current_block_idx = parent_idx

    bb = program._create_block(parent_idx)
    new_vars = body_fn(*loop_vars)
    if not isinstance(new_vars, (list, tuple)):
        new_vars = [new_vars]
    for old, new in zip(loop_vars, new_vars):
        if new.name != old.name:
            bb.append_op("assign", inputs={"X": [new]},
                         outputs={"Out": [old]})
    program.current_block_idx = parent_idx

    LayerHelper("while", name=name).append_op(
        "while", inputs={"X": list(loop_vars)},
        outputs={"Out": list(loop_vars)},
        attrs={"cond_block": cb.idx, "sub_block": bb.idx,
               "cond_var": c.name})
    return loop_vars


class While:
    """The block-style loop: ``with While(cond).block(): ...``; the body
    updates ``cond`` itself (``less_than(i, n, cond=cond)``)."""

    def __init__(self, cond, is_test=False, name=None):
        self.cond_var = cond
        self.helper = LayerHelper("while", name=name)
        self._program = default_main_program()

    def block(self):
        return _WhileCtx(self)


class _WhileCtx:
    def __init__(self, w):
        self.w = w

    def __enter__(self):
        p = self.w._program
        self.parent_idx = p.current_block_idx
        self.body = p._create_block(self.parent_idx)
        return self

    def __exit__(self, *exc):
        p = self.w._program
        p.current_block_idx = self.parent_idx
        reads = sorted({n for op in self.body.ops
                        for n in op.input_arg_names})
        writes = sorted({n for op in self.body.ops
                         for n in op.output_arg_names})
        # the predicate, read in a block of its own before each trip
        cb = p._create_block(self.parent_idx)
        cond_copy = self.w.cond_var.name + "@COND"
        cb.append_op("assign", inputs={"X": [self.w.cond_var]},
                     outputs={"Out": [cond_copy]})
        p.current_block_idx = self.parent_idx
        self.w.helper.append_op(
            "while", inputs={"X": reads}, outputs={"Out": writes},
            attrs={"cond_block": cb.idx, "sub_block": self.body.idx,
                   "cond_var": cond_copy})
        return False


class _SwitchCase:
    """One ``with switch.case(pred)`` or ``switch.default()`` body: a
    sub-block, and the vars of enclosing blocks it writes."""

    def __init__(self, switch, condition):
        self._switch = switch
        self._condition = condition

    def __enter__(self):
        self._block = self._switch._prog._create_block(self._switch._parent)
        return self

    def __exit__(self, exc_type, *exc):
        prog = self._switch._prog
        prog.current_block_idx = self._switch._parent
        if exc_type is not None:
            return False
        parent = prog.blocks[self._switch._parent]
        written = []
        for op in self._block.ops:
            for n in op.output_arg_names:
                if parent._find_var_recursive(n) is not None \
                        and n not in written:
                    written.append(n)
        self._switch._cases.append((self._condition, self._block, written))
        return False


class Switch:
    """The first case whose predicate holds runs, else the default.
    Each arm is a ``conditional_block`` whose predicate is its case and
    none of the earlier ones; the vars it writes take its values."""

    def __init__(self, name=None):
        if in_dygraph_mode():
            raise RuntimeError(
                "Switch is a static-graph construct (the case bodies would "
                "run eagerly before the predicates are known): use Python "
                "control flow in dygraph")
        self._prog = default_main_program()
        self._parent = self._prog.current_block_idx
        self._cases = []

    def __enter__(self):
        return self

    def case(self, condition):
        return _SwitchCase(self, condition)

    def default(self):
        return _SwitchCase(self, None)

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:
            return False
        helper = LayerHelper("switch")
        parent = self._prog.blocks[self._parent]
        not_matched = None
        for condition, block, written in self._cases:
            if condition is None:
                effective = not_matched if not_matched is not None \
                    else fill_constant([1], "bool", True)
            elif not_matched is None:
                effective = condition
            else:
                effective = logical_and(not_matched, condition)
            outs = [helper.create_variable_for_type_inference(
                dtype=parent._find_var_recursive(n).dtype) for n in written]
            helper.append_op(
                "conditional_block", inputs={"Cond": [effective]},
                outputs={"Out": outs},
                attrs={"true_block": block.idx, "false_block": -1,
                       "true_outs": list(written),
                       "false_outs": list(written)})
            for n, o in zip(written, outs):
                assign(o, parent._find_var_recursive(n))
            if condition is not None:
                not_c = logical_not(condition)
                not_matched = not_c if not_matched is None \
                    else logical_and(not_matched, not_c)
        return False


# --- tensor arrays -----------------------------------------------------------
def create_array(dtype):
    """An empty tensor array: a list of tensors in the executor's env,
    made by its first ``array_write``."""
    return default_main_program().current_block().create_var(
        name=unique_name("array"), dtype=dtype)


def _index_var(i):
    return i if isinstance(i, Variable) else fill_constant([1], "int64", i)


def array_write(x, i, array=None):
    """``array[i] = x``; ``i`` is read where the op runs."""
    if array is None:
        array = create_array(x.dtype)
    LayerHelper("array_write").append_op(
        "write_to_array",
        inputs={"X": [x], "I": [_index_var(i)], "Array": [array]},
        outputs={"Out": [array]})
    return array


def array_read(array, i):
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(dtype=array.dtype)
    helper.append_op("read_from_array",
                     inputs={"X": [array], "I": [_index_var(i)]},
                     outputs={"Out": [out]})
    return out


def array_length(array):
    helper = LayerHelper("array_length")
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op("lod_array_length", inputs={"X": [array]},
                     outputs={"Out": [out]})
    return out


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=False,
          print_phase="both"):
    """The input, unchanged, with its first values printed on the host
    (print_op.cc)."""
    helper = LayerHelper("print")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("print", inputs={"In": [input]},
                          outputs={"Out": [out]},
                          attrs={"message": message or "",
                                 "first_n": first_n,
                                 "summarize": summarize})
    return op["Out"][0] if in_dygraph_mode() else out


def Assert(cond, data=None, summarize=20, name=None):
    """Stop with an error where ``cond`` is False (assert_op.cc)."""
    LayerHelper("assert").append_op(
        "assert", inputs={"Cond": [cond], "Data": list(data or [])},
        outputs={}, attrs={"summarize": summarize})


def is_empty(x, name=None):
    helper = LayerHelper("is_empty")
    out = helper.create_variable_for_type_inference(dtype="bool")
    op = helper.append_op("is_empty", inputs={"X": [x]},
                          outputs={"Out": [out]}, attrs={})
    return op["Out"][0] if in_dygraph_mode() else out


def case(pred_fn_pairs, default=None, name=None):
    """The first pair whose predicate holds: nested ``cond``s."""
    if not pred_fn_pairs:
        raise ValueError("case: pred_fn_pairs must be non-empty")

    def build(pairs):
        (pred, fn), rest = pairs[0], pairs[1:]
        if rest:
            return cond(pred, fn, lambda: build(rest))
        if default is not None:
            return cond(pred, fn, default)
        return cond(pred, fn, fn)      # the last fn doubles as default
    return build(list(pred_fn_pairs))


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch of index ``branch_index``: ``case`` over equality
    tests of the index."""
    items = sorted(branch_fns.items()) if isinstance(branch_fns, dict) \
        else list(enumerate(branch_fns))
    pairs = [(equal(branch_index, fill_constant([1], "int64", int(idx))),
              fn) for idx, fn in items]
    return case(pairs, default=default)


class IfElse:
    """The block-style conditional: each block's outputs, merged row by
    row by the predicate (``t * p + f * (1 - p)``, as the reference
    merges them)."""

    def __init__(self, cond, name=None):
        self._cond = cond
        self._true = []
        self._false = []
        self._in_true = None

    class _Branch:
        def __init__(self, owner, flag):
            self.owner, self.flag = owner, flag

        def __enter__(self):
            self.owner._in_true = self.flag
            return self

        def __exit__(self, *a):
            self.owner._in_true = None
            return False

    def true_block(self):
        return IfElse._Branch(self, True)

    def false_block(self):
        return IfElse._Branch(self, False)

    def output(self, *outs):
        (self._true if self._in_true else self._false).extend(outs)

    def __call__(self):
        if len(self._true) != len(self._false):
            raise ValueError("IfElse: both blocks must output the same "
                             "number of variables")
        res = []
        for t, f in zip(self._true, self._false):
            p = _nn.cast(self._cond, t.dtype)
            res.append(t * p + f * (1.0 - p))
        return res


class StaticRNN:
    """A step block run once per time step by the ``recurrent`` op:
    ``step_input`` gives a ``[B, T, ...]`` sequence's step ``[B, ...]``,
    ``memory`` a state carried from step to step (``update_memory`` sets
    its next value), ``step_output`` a value stacked over the steps on
    axis 1.  The vars of enclosing blocks that the step reads (weights)
    ride in as the op's ``Parameters``."""

    def __init__(self, name=None):
        self._prog = default_main_program()
        self._helper = LayerHelper("static_rnn", name=name)
        self._block = None
        self._parent = None
        self._seq = []           # (outer [B, T, ...] var, step var)
        self._mems = []          # [init var, step var, next value]
        self._outs = []          # step vars
        self._results = None

    class _Step:
        def __init__(self, owner):
            self.owner = owner

        def __enter__(self):
            o = self.owner
            o._parent = o._prog.current_block_idx
            o._block = o._prog._create_block(o._parent)
            return self

        def __exit__(self, exc_type, *a):
            o = self.owner
            o._prog.current_block_idx = o._parent
            if exc_type is None:
                o._complete()
            return False

    def step(self):
        return StaticRNN._Step(self)

    def _in_parent(self, fn):
        idx = self._prog.current_block_idx
        self._prog.current_block_idx = self._parent
        try:
            return fn()
        finally:
            self._prog.current_block_idx = idx

    def step_input(self, x):
        shape = None if x.shape is None \
            else (x.shape[0],) + tuple(x.shape[2:])
        step = self._block.create_var(name=unique_name("static_rnn_in"),
                                      shape=shape, dtype=x.dtype)
        self._seq.append((x, step))
        return step

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, dtype="float32"):
        if init is None:
            if batch_ref is None or shape is None:
                raise ValueError("StaticRNN.memory needs init or "
                                 "(shape, batch_ref)")
            rows = batch_ref.shape[0]
            init = self._in_parent(lambda: fill_constant(
                [rows] + list(shape[1:]), dtype, init_value))
        pre = self._block.create_var(name=unique_name("static_rnn_mem"),
                                     shape=init.shape, dtype=init.dtype)
        self._mems.append([init, pre, None])
        return pre

    def update_memory(self, mem, new):
        for m in self._mems:
            if m[1] is mem:
                m[2] = new
                return
        raise ValueError("update_memory: unknown memory variable")

    def step_output(self, o):
        self._outs.append(o)

    def output(self, *outs):
        for o in outs:
            self.step_output(o)

    def _complete(self):
        from ..control_flow_impl import _block_reads_writes
        missing = [m[1].name for m in self._mems if m[2] is None]
        if missing:
            raise ValueError(f"StaticRNN: memories {missing} were never "
                             f"given their next value (update_memory)")
        local = {s.name for _, s in self._seq} | \
            {m[1].name for m in self._mems}
        reads, _ = _block_reads_writes(self._block)
        params = [n for n in reads if n not in local]
        parent = self._prog.blocks[self._parent]
        self._results = [self._helper.create_variable_for_type_inference(
            dtype=o.dtype) for o in self._outs]
        parent.append_op(
            "recurrent",
            inputs={"Inputs": [x for x, _ in self._seq],
                    "InitStates": [m[0] for m in self._mems],
                    "Parameters": params},
            outputs={"Out": self._results},
            attrs={"sub_block": self._block.idx,
                   "inputs": [s.name for _, s in self._seq],
                   "ex_states": [m[1].name for m in self._mems],
                   "states": [m[2].name for m in self._mems],
                   "parameters": params,
                   "outputs": [o.name for o in self._outs]})

    def __call__(self):
        if self._results is None:
            raise ValueError("StaticRNN: call it after its step block")
        return self._results[0] if len(self._results) == 1 \
            else list(self._results)


def DynamicRNN(*a, **kw):
    raise NotImplementedError(
        "DynamicRNN is LoD-driven; the padded redesign covers its uses "
        "with nn.RNN (custom cells, eager semantics), fluid.layers.rnn and "
        "layers.while_loop for data-dependent loops")


def reorder_lod_tensor_by_rank(x, rank_table):
    helper = LayerHelper("reorder_lod_tensor_by_rank")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("reorder_lod_tensor_by_rank",
                          inputs={"X": [x], "RankTable": [rank_table]},
                          outputs={"Out": [out]}, attrs={})
    return op["Out"][0] if in_dygraph_mode() else out
