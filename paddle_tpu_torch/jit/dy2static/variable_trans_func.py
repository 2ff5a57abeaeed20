"""variable_trans_func (reference jit/dy2static/variable_trans_func.py;
counterpart of ``paddle_tpu/jit/dy2static/variable_trans_func.py``):
AST-node factories + the to_static_variable runtime cast."""
from __future__ import annotations

import ast
import textwrap

__all__ = ["create_bool_as_type", "create_fill_constant_node",
           "create_static_variable_gast_node", "data_layer_not_check",
           "to_static_variable", "to_static_variable_gast_node"]


def to_static_variable(x):
    """Python bool/int/float -> filled tensor var inside a traced region."""
    if isinstance(x, (bool, int, float)):
        from ...fluid import layers as L
        dtype = ("bool" if isinstance(x, bool)
                 else "int64" if isinstance(x, int) else "float64")
        return L.fill_constant([1], dtype, x)
    return x


def create_bool_as_type(x, value=True):
    from ...fluid.framework import Variable
    from ...dygraph.base import VarBase
    if isinstance(x, (Variable, VarBase)):
        from ...fluid import layers as L
        return L.fill_constant([1], "bool", value)
    return value


def data_layer_not_check(name, shape, dtype="float32", lod_level=0):
    from ...fluid import layers as L
    return L.data(name, shape, dtype=dtype)


def _parse(code):
    return ast.parse(textwrap.dedent(code)).body[0]


def create_fill_constant_node(name, value):
    dtype = ("bool" if isinstance(value, bool)
             else "int64" if isinstance(value, int) else "float64")
    return _parse(f"{name} = paddle_tpu_torch.fluid.layers.fill_constant("
                  f"shape=[1], dtype='{dtype}', value={value})")


def to_static_variable_gast_node(name):
    return _parse(
        f"{name} = paddle_tpu_torch.jit.dy2static.to_static_variable({name})")


def create_static_variable_gast_node(name):
    return _parse(
        f"{name} = paddle_tpu_torch.jit.dy2static.data_layer_not_check("
        f"'{name}', shape=[-1], dtype='float32')")
