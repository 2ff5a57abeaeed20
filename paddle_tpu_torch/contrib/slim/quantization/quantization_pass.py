"""QAT program rewriting (counterpart of
``paddle_tpu/contrib/slim/quantization/quantization_pass.py``).

Reference: python/paddle/fluid/contrib/slim/quantization/
quantization_pass.py.  ``QuantizationTransformPass`` puts a fake
quant-dequant op before each float input of a quantizable op
(conv2d, depthwise_conv2d, mul, matmul, matmul_v2, fc): channel-wise on
the weight slot, per-tensor abs max on the activations.
``QuantizationFreezePass`` takes those ops out again and records each
input's scale var on the program (``program._quant_scales``).

The reference's choices are kept (ROADMAP queue C): the transform never
reads ``activation_quantize_type``; ``matmul``'s and ``matmul_v2``'s
``Y``, an activation in attention, counts as a weight (channel-wise on
axis 1); the freeze keeps the float weights; ``ConvertToInt8Pass`` and
``OutScaleForTrainingPass`` only set program hints; the mobile and
mkldnn passes are the identity.
"""
from __future__ import annotations

from ....fluid.framework import Program

QUANTIZABLE_OPS = ("conv2d", "depthwise_conv2d", "mul", "matmul",
                   "matmul_v2", "fc")
_WEIGHT_SLOTS = {"conv2d": "Filter", "depthwise_conv2d": "Filter",
                 "mul": "Y", "matmul": "Y", "matmul_v2": "Y", "fc": "W"}


class QuantizationTransformPass:
    """Insert activation + weight fake-quant-dequant before quantizable ops."""

    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="moving_average_abs_max",
                 weight_quantize_type="channel_wise_abs_max",
                 quantizable_op_type=QUANTIZABLE_OPS):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_type = activation_quantize_type
        self.weight_type = weight_quantize_type
        self.op_types = tuple(quantizable_op_type)

    def apply(self, program: Program) -> Program:
        block = program.global_block()
        new_ops = []
        quanted = {}          # (var name, is weight) -> quant-dequant output

        def qdq(name, is_weight, pos):
            key = (name, is_weight)
            if key in quanted:
                return quanted[key], []
            out = f"{name}@QUANT_DEQUANT"
            scale = f"{name}@QUANT_SCALE"
            block.create_var(name=out, stop_gradient=False)
            block.create_var(name=scale, stop_gradient=True)
            bits = self.weight_bits if is_weight else self.activation_bits
            if is_weight and self.weight_type == "channel_wise_abs_max":
                # per-channel scale over axis 0 for Filter, axis 1 for Y/W;
                # the quant-DEQUANT op: consumers train on float weights
                op_type = "fake_channel_wise_quantize_dequantize_abs_max"
                attrs = {"bit_length": bits,
                         "quant_axis": 0 if pos == "Filter" else 1}
            else:
                op_type = "fake_quantize_dequantize_abs_max"
                attrs = {"bit_length": bits}
            op = block.append_op(op_type, inputs={"X": [name]},
                                 outputs={"Out": [out],
                                          "OutScale": [scale]},
                                 attrs=attrs)
            block.ops.pop()
            quanted[key] = out
            return out, [op]

        for op in list(block.ops):
            if op.type in self.op_types:
                w_slot = _WEIGHT_SLOTS.get(op.type)
                for slot, names in op.inputs.items():
                    if slot not in ("X", "Input", w_slot):
                        continue
                    renamed = []
                    for n in names:
                        v = block._find_var_recursive(n)
                        if v is None or getattr(v, "dtype", "float32") not in (
                                "float32", None):
                            renamed.append(n)
                            continue
                        out, qops = qdq(n, slot == w_slot, slot)
                        new_ops.extend(qops)
                        renamed.append(out)
                    op.inputs[slot] = renamed
            new_ops.append(op)
        block.ops = new_ops
        program._bump_version()
        program._quant_bits = (self.weight_bits, self.activation_bits)
        return program


class QuantizationFreezePass:
    """Fold the fake-quant ops for inference: (a) take them out, their
    consumers reading the float inputs again, (b) record ``{var: scale
    var}`` in ``program._quant_scales``."""

    def apply(self, program: Program) -> Program:
        block = program.global_block()
        scales = {}
        keep = []
        rename = {}
        for op in block.ops:
            if op.type.startswith(("fake_quantize", "fake_channel_wise",
                                   "fake_quantize_dequantize")):
                src = op.inputs["X"][0]
                rename[op.outputs["Out"][0]] = src
                scales[src] = op.outputs.get("OutScale", [None])[0]
                continue
            for slot, names in op.inputs.items():
                op.inputs[slot] = [rename.get(n, n) for n in names]
            keep.append(op)
        block.ops = keep
        program._bump_version()
        program._quant_scales = scales
        return program


def quant_aware(program, weight_bits=8, activation_bits=8, **kw):
    """paddleslim's one-call QAT entry."""
    return QuantizationTransformPass(
        weight_bits=weight_bits, activation_bits=activation_bits,
        **kw).apply(program)


def convert(program):
    """paddleslim's freeze for inference."""
    return QuantizationFreezePass().apply(program)


class ConvertToInt8Pass:
    """Records the intent to keep int8 weights (``int8_weights`` hint);
    the weights stay float, as in the reference."""

    def __init__(self, scope=None, place=None, quantizable_op_type=None):
        self._scope = scope

    def apply(self, graph_or_program):
        p = getattr(graph_or_program, "_program", graph_or_program)
        p._hints["int8_weights"] = True
        return graph_or_program


class TransformForMobilePass:
    """The identity: there is no mobile runtime to rename ops for."""

    def apply(self, graph_or_program):
        return graph_or_program


class OutScaleForTrainingPass:
    """Records the output-scale moving rate (``out_scales`` hint); no op
    is added, as in the reference."""

    def __init__(self, scope=None, place=None, moving_rate=0.9):
        self._rate = moving_rate

    def apply(self, graph_or_program):
        p = getattr(graph_or_program, "_program", graph_or_program)
        p._hints.setdefault("out_scales", {})["moving_rate"] = self._rate
        return graph_or_program


class OutScaleForInferencePass:
    def __init__(self, scope=None):
        pass

    def apply(self, graph_or_program):
        return graph_or_program


class AddQuantDequantPass:
    """Fake quant-dequant around further op types (by default
    ``elementwise_add`` and ``pool2d``), through the shared rewrite."""

    def __init__(self, scope=None, place=None, moving_rate=0.9,
                 quant_bits=8, skip_pattern="skip_quant",
                 quantizable_op_type=None):
        self._bits = quant_bits
        self._ops = quantizable_op_type or ["elementwise_add", "pool2d"]

    def apply(self, graph_or_program):
        p = getattr(graph_or_program, "_program", graph_or_program)
        quant_aware(p, weight_bits=self._bits, activation_bits=self._bits,
                    quantizable_op_type=self._ops)
        return graph_or_program


class Quant2Int8MkldnnPass:
    """The identity: no mkldnn backend (kept for the API)."""

    def __init__(self, *a, **kw):
        pass

    def apply(self, graph_or_program):
        return graph_or_program


QuantInt8MkldnnPass = Quant2Int8MkldnnPass
