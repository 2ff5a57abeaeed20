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
    """Promote a python scalar to a graph constant (``fill_constant``)."""
    if isinstance(x, Variable):
        return x
    arr = np.asarray(x, dtype=dtype or "float32")
    if arr.size != 1:
        raise NotImplementedError(
            "array constants (assign_value) are not ported yet; only "
            "scalars become graph constants")
    helper = LayerHelper("constant")
    out = helper.create_variable_for_type_inference(dtype=str(arr.dtype))
    out.stop_gradient = True
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [1], "value": float(arr.flat[0]),
                            "dtype": str(arr.dtype)})
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
    helper.append_op("fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    out.stop_gradient = True
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
