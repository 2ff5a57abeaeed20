"""LayerHelper: shared machinery for layer functions (counterpart of
``paddle_tpu/fluid/layer_helper.py``).

Creates parameters (appending their initializer ops to the *startup*
program) and temp output vars in the *main* program.  Names come from
the same counters in the same order as the TPU package, so a program
built by both packages names every parameter alike.  Under a dygraph
tracer (dygraph/base.py) the same calls run eagerly instead: parameters
are made at once and ``append_op`` returns the traced op's outputs.
"""
from __future__ import annotations

from .framework import (default_main_program, default_startup_program,
                        unique_name, in_dygraph_mode, _dygraph_tracer,
                        get_default_dtype)
from .initializer import (_to_initializer, _global_initializer,
                          ConstantInitializer, XavierInitializer)
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.layer_type = layer_type
        self.kwargs = kwargs

    @property
    def name(self):
        return self.kwargs.get("name") or unique_name(self.layer_type)

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def block(self):
        return self.main_program.current_block()

    def create_parameter(self, attr, shape, dtype=None,
                         is_bias=False, default_initializer=None):
        attr = ParamAttr._to_attr(attr)
        if attr is False:
            return None
        dtype = dtype or get_default_dtype()
        name = attr.name or unique_name(
            f"{self.kwargs.get('name') or self.layer_type}.w"
            if not is_bias else
            f"{self.kwargs.get('name') or self.layer_type}.b")
        init = attr.initializer or default_initializer or \
            _global_initializer(is_bias) or (
                ConstantInitializer(0.0) if is_bias else XavierInitializer())
        init = _to_initializer(init)
        if in_dygraph_mode():
            return _dygraph_tracer().create_parameter(
                name, shape, dtype, init, trainable=attr.trainable,
                regularizer=attr.regularizer, need_clip=attr.need_clip)
        param = self.block().create_parameter(
            name=name, shape=shape, dtype=dtype, trainable=attr.trainable,
            regularizer=attr.regularizer, need_clip=attr.need_clip)
        param.optimize_attr = {"learning_rate": attr.learning_rate}
        # mirror into the startup program and append its init op there
        sb = self.startup_program.global_block()
        sp = sb.create_parameter(name=name, shape=shape, dtype=dtype,
                                 trainable=attr.trainable)
        init(sp, sb)
        return param

    def create_variable_for_type_inference(self, dtype="float32",
                                           stop_gradient=False):
        if in_dygraph_mode():
            return None     # the tracer makes dygraph outputs
        return self.block().create_var(
            name=unique_name(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient)

    def append_op(self, type, inputs=None, outputs=None, attrs=None):
        """The Operator appended in static mode; the traced op's outputs
        (``{slot: [VarBase]}``) in dygraph mode."""
        if in_dygraph_mode():
            return _dygraph_tracer().trace_op(type, inputs, outputs, attrs)
        return self.block().append_op(type, inputs, outputs, attrs)

    # activation sugar: fluid layers take act="relu" etc.
    def append_activation(self, out, act=None):
        if act is None:
            return out
        if isinstance(act, str):
            act = {"type": act}
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=out.dtype)
        op = self.append_op(act_type, inputs={"X": [out]},
                            outputs={"Out": [tmp]}, attrs=act)
        return op["Out"][0] if in_dygraph_mode() else tmp

    def append_bias_op(self, out, bias, axis=1):
        if bias is None:
            return out
        tmp = self.create_variable_for_type_inference(dtype=out.dtype)
        op = self.append_op("elementwise_add",
                            inputs={"X": [out], "Y": [bias]},
                            outputs={"Out": [tmp]}, attrs={"axis": axis})
        return op["Out"][0] if in_dygraph_mode() else tmp


def emit_op(layer_type, op_type, ins, out_slots, attrs):
    """Mode-agnostic op emission for layer classes: traced in dygraph
    mode, appended in static mode; returns ``{slot: [output]}``."""
    if in_dygraph_mode():
        return _dygraph_tracer().trace_op(
            op_type, ins, {s: [None] for s in out_slots}, attrs)
    helper = LayerHelper(layer_type)
    outs = {s: [helper.create_variable_for_type_inference()]
            for s in out_slots}
    helper.append_op(op_type, inputs=ins, outputs=outs, attrs=attrs)
    return outs
