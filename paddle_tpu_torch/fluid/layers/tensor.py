"""Tensor layer functions (counterpart of
``paddle_tpu/fluid/layers/tensor.py``, the subset the ported slices
build)."""
from __future__ import annotations

import numpy as np

from ..framework import (Variable, default_main_program,
                         default_startup_program, in_dygraph_mode,
                         unique_name)
from ..layer_helper import LayerHelper


def _to_variable(block, x, dtype=None):
    """Promote a python scalar or numpy array to a constant: a VarBase
    under a tracer, else a ``fill_constant`` (one value) or
    ``assign_value`` (an array) in the main program."""
    if isinstance(x, Variable):
        return x
    if in_dygraph_mode():
        from ...dygraph.base import to_variable
        return to_variable(np.asarray(x, dtype=dtype or "float32"))
    arr = np.asarray(x, dtype=dtype or "float32")
    helper = LayerHelper("constant")
    out = helper.create_variable_for_type_inference(dtype=str(arr.dtype))
    out.stop_gradient = True
    if arr.ndim == 0:
        arr = arr.reshape(1)
    if arr.size == 1:
        helper.append_op("fill_constant", outputs={"Out": [out]},
                         attrs={"shape": list(arr.shape),
                                "value": float(arr.flat[0]),
                                "dtype": str(arr.dtype)})
    else:
        helper.append_op("assign_value", outputs={"Out": [out]},
                         attrs={"shape": list(arr.shape),
                                "dtype": str(arr.dtype),
                                "fp32_values":
                                    arr.astype("float64").flatten().tolist()})
    return out


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=False):
    """fluid.data: declare a feed variable (-1 marks the batch dim)."""
    block = default_main_program().global_block()
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            is_data=True, stop_gradient=True)


def fill_constant(shape, dtype, value, out=None, name=None):
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    op = helper.append_op("fill_constant", outputs={"Out": [out]},
                          attrs={"shape": list(shape), "dtype": dtype,
                                 "value": float(value)})
    # under a tracer the traced VarBase is the result; its shape is its
    # value's
    out = op["Out"][0] if in_dygraph_mode() else out
    out.stop_gradient = True
    if not in_dygraph_mode():
        out.shape = tuple(shape)
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    op = helper.append_op(
        "fill_constant_batch_size_like",
        inputs={"Input": [input]}, outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value),
               "input_dim_idx": input_dim_idx,
               "output_dim_idx": output_dim_idx})
    return op["Out"][0] if in_dygraph_mode() else out


def assign(input, output=None):
    """Copy ``input`` into ``output`` (a new var when None); naming an
    existing var as ``output`` is how a program writes carried state."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        input = _to_variable(None, input)
    if output is None:
        output = helper.create_variable_for_type_inference(
            dtype=getattr(input, "dtype", "float32"))
    op = helper.append_op("assign", inputs={"X": [input]},
                          outputs={"Out": [output]})
    return op["Out"][0] if in_dygraph_mode() else output


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    """A var of the main program whose value the startup program fills
    (the optimizers' learning rate and accumulators)."""
    name = name or unique_name("global_var")
    block = default_main_program().global_block()
    var = block.create_var(name=name, shape=shape, dtype=dtype,
                           persistable=persistable)
    var.stop_gradient = True
    sb = default_startup_program().global_block()
    sb.create_var(name=name, shape=shape, dtype=dtype, persistable=persistable)
    sb.append_op("fill_constant", outputs={"Out": [name]},
                 attrs={"shape": list(shape), "dtype": dtype,
                        "value": float(value)})
    return var


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    op = helper.append_op("concat", inputs={"X": list(input)},
                          outputs={"Out": [out]}, attrs={"axis": axis})
    return op["Out"][0] if in_dygraph_mode() else out


def zeros_like(x, out=None):
    """Zeros in ``x``'s shape and dtype (one ``fill_zeros_like`` op)."""
    helper = LayerHelper("fill_zeros_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("fill_zeros_like", inputs={"X": [x]},
                          outputs={"Out": [out]})
    return op["Out"][0] if in_dygraph_mode() else out


def ones_like(x, out=None):
    """Ones in ``x``'s shape and dtype (one ``fill_any_like`` op)."""
    helper = LayerHelper("fill_any_like")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("fill_any_like", inputs={"X": [x]},
                          outputs={"Out": [out]}, attrs={"value": 1.0})
    return op["Out"][0] if in_dygraph_mode() else out


def sums(input, out=None):
    """The elementwise sum of a list of vars (one ``sum`` op)."""
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    op = helper.append_op("sum", inputs={"X": list(input)},
                          outputs={"Out": [out]})
    return op["Out"][0] if in_dygraph_mode() else out


def zeros(shape, dtype="float32"):
    return fill_constant(shape, dtype, 0.0)


def ones(shape, dtype="float32"):
    return fill_constant(shape, dtype, 1.0)


def _arg(op_type, x, axis):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    op = helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                          attrs={"axis": axis})
    return op["Out"][0] if in_dygraph_mode() else out


def argmax(x, axis=0):
    return _arg("arg_max", x, axis)


def argmin(x, axis=0):
    return _arg("arg_min", x, axis)


def argsort(x, axis=-1, descending=False):
    """(sorted values, int64 indices) along ``axis``."""
    helper = LayerHelper("argsort")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    op = helper.append_op("argsort", inputs={"X": [x]},
                          outputs={"Out": [out], "Indices": [ids]},
                          attrs={"axis": axis, "descending": descending})
    if in_dygraph_mode():
        return op["Out"][0], op["Indices"][0]
    return out, ids


def linspace(start, stop, num, dtype="float32"):
    helper = LayerHelper("linspace")
    ins = {"Start": [_to_variable(None, start, dtype)],
           "Stop": [_to_variable(None, stop, dtype)],
           "Num": [_to_variable(None, int(num), "int32")]}
    out = helper.create_variable_for_type_inference(dtype=dtype)
    op = helper.append_op("linspace", inputs=ins, outputs={"Out": [out]},
                          attrs={"dtype": dtype})
    return op["Out"][0] if in_dygraph_mode() else out


def range(start, end, step, dtype="float32"):
    helper = LayerHelper("range")
    ins = {"Start": [_to_variable(None, start, dtype)],
           "End": [_to_variable(None, end, dtype)],
           "Step": [_to_variable(None, step, dtype)]}
    out = helper.create_variable_for_type_inference(dtype=dtype)
    op = helper.append_op("range", inputs=ins, outputs={"Out": [out]})
    return op["Out"][0] if in_dygraph_mode() else out


def increment(x, value=1.0, in_place=True):
    """x + value; in a program, into x itself unless ``in_place`` is
    False."""
    helper = LayerHelper("increment")
    out = x if in_place and not in_dygraph_mode() else \
        helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("increment", inputs={"X": [x]},
                          outputs={"Out": [out]},
                          attrs={"step": float(value)})
    return op["Out"][0] if in_dygraph_mode() else out


def eye(num_rows, num_columns=None, dtype="float32"):
    helper = LayerHelper("eye")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    op = helper.append_op("eye", outputs={"Out": [out]},
                          attrs={"num_rows": num_rows,
                                 "num_columns": num_columns or num_rows,
                                 "dtype": dtype})
    return op["Out"][0] if in_dygraph_mode() else out
