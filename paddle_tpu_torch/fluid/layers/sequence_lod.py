"""Sequence ops without LoD: padded batches and explicit lengths
(counterpart of ``paddle_tpu/fluid/layers/sequence_lod.py``: the
``sequence_pool``, ``sequence_mask``, ``sequence_softmax``,
``sequence_expand``, ``sequence_reverse`` and ``sequence_concat`` ops,
and the ``sequence_*`` layers over them and over
``ops/sequence_extra.py``'s).

A batch of sequences is a dense ``[batch, max_len, ...]`` tensor plus an
optional ``Length`` int tensor; the op masks the positions past each
row's length.  As in the reference, the op lowering lives beside its
layer.
"""
from __future__ import annotations

import torch

from ...ops.registry import register_op
from ..framework import in_dygraph_mode, torch_dtype
from ..layer_helper import LayerHelper


def _mask(length, max_len, dtype):
    pos = torch.arange(max_len, device=length.device)
    return (pos[None, :] < length.reshape(-1, 1)).to(dtype)


@register_op("sequence_mask", nondiff_inputs=("X",), differentiable=False)
def _sequence_mask(ins, attrs, ctx):
    """[..., maxlen] of ``out_dtype``: 1 where the position is below the
    length; ``maxlen`` <= 0 takes the largest length (read on the
    host)."""
    x = ins["X"][0]
    maxlen = attrs.get("maxlen", -1)
    if maxlen <= 0:
        maxlen = int(x.max())
    pos = torch.arange(maxlen, device=x.device)
    return {"Y": [(pos[None, :] < x.reshape(-1, 1)).to(
        torch_dtype(attrs.get("out_dtype", "int64")))]}


@register_op("sequence_pool", nondiff_inputs=("Length",))
def _sequence_pool(ins, attrs, ctx):
    """x: [B, T, D] padded; Length: [B].  pooltype SUM / AVERAGE / SQRT /
    MAX / LAST / FIRST (sequence_pool_op.h semantics, padded layout)."""
    x = ins["X"][0]
    ptype = attrs.get("pooltype", "SUM").upper()
    if ins.get("Length"):
        length = ins["Length"][0]
        m = _mask(length, x.shape[1], x.dtype)[..., None]
    else:
        length = torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                            device=x.device)
        m = torch.ones(x.shape[:2] + (1,), dtype=x.dtype, device=x.device)
    if ptype == "SUM":
        out = torch.sum(x * m, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * m, dim=1) / torch.clamp(
            length.reshape(-1, 1).to(x.dtype), min=1)
    elif ptype == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(torch.clamp(
            length.reshape(-1, 1).to(x.dtype), min=1))
    elif ptype == "MAX":
        out = torch.amax(torch.where(m > 0, x, -torch.inf), dim=1)
        out = torch.where(torch.isfinite(out), out, 0.0)
    elif ptype == "LAST":
        idx = torch.clamp(length - 1, min=0).long()
        idx = idx.reshape(-1, 1, *([1] * (x.ndim - 2)))
        out = torch.take_along_dim(
            x, idx.expand(-1, 1, *x.shape[2:]), dim=1).squeeze(1)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool type {ptype}")
    return {"Out": [out],
            "MaxIndex": [torch.zeros((1,), dtype=torch.int32,
                                     device=x.device)]}


@register_op("sequence_softmax", nondiff_inputs=("Length",))
def _sequence_softmax(ins, attrs, ctx):
    """The softmax over the time axis (axis 1); with ``Length`` the
    positions past it read -1e9 and come out 0."""
    x = ins["X"][0]
    if not ins.get("Length"):
        return {"Out": [torch.softmax(x, dim=1)]}
    m = _mask(ins["Length"][0], x.shape[1], x.dtype)
    return {"Out": [torch.softmax(torch.where(m > 0, x, -1e9), dim=1) * m]}


@register_op("sequence_expand", nondiff_inputs=("Y",))
def _sequence_expand(ins, attrs, ctx):
    """Padded: each row of X repeated over Y's time axis."""
    x, y = ins["X"][0], ins["Y"][0]
    return {"Out": [x[:, None].expand((x.shape[0], y.shape[1])
                                      + tuple(x.shape[1:]))]}


@register_op("sequence_reverse", nondiff_inputs=("Length",))
def _sequence_reverse(ins, attrs, ctx):
    """Each row's first ``Length`` steps reversed in place (the whole time
    axis without ``Length``)."""
    x = ins["X"][0]
    if not ins.get("Length"):
        return {"Y": [torch.flip(x, dims=[1])]}
    length = ins["Length"][0].reshape(-1, 1).long()
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    rev = torch.where(idx < length, length - 1 - idx, idx)
    rev = rev.reshape(rev.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return {"Y": [torch.gather(x, 1, rev)]}


@register_op("sequence_concat")
def _sequence_concat(ins, attrs, ctx):
    """Padded: the inputs concatenated on the time axis."""
    return {"Out": [torch.cat(ins["X"], dim=1)]}


def _seq_layer(op_type, out_slot="Out"):
    def f(input, length=None, **attrs):
        helper = LayerHelper(op_type)
        out = helper.create_variable_for_type_inference(dtype=input.dtype)
        inputs = {"X": [input]}
        if length is not None:
            inputs["Length"] = [length]
        op = helper.append_op(op_type, inputs=inputs,
                              outputs={out_slot: [out]}, attrs=attrs)
        return op[out_slot][0] if in_dygraph_mode() else out
    f.__name__ = op_type
    return f


def _one(op_type, inputs, attrs=None, dtype=None):
    """One op of one ``Out``, static or traced."""
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(
        dtype=dtype or inputs["X"][0].dtype)
    op = helper.append_op(op_type, inputs=inputs, outputs={"Out": [out]},
                          attrs=attrs or {})
    return op["Out"][0] if in_dygraph_mode() else out


def sequence_pool(input, pool_type="sum", length=None, is_test=False):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    mi = helper.create_variable_for_type_inference(dtype="int32",
                                                   stop_gradient=True)
    inputs = {"X": [input]}
    if length is not None:
        inputs["Length"] = [length]
    op = helper.append_op("sequence_pool", inputs=inputs,
                          outputs={"Out": [out], "MaxIndex": [mi]},
                          attrs={"pooltype": pool_type.upper()})
    return op["Out"][0] if in_dygraph_mode() else out


sequence_softmax = _seq_layer("sequence_softmax")
sequence_reverse = _seq_layer("sequence_reverse", "Y")


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=True, padding_start=None, param_attr=None,
                  bias_attr=None, act=None, length=None):
    """The context-window convolution over the time axis: ``input``
    [B, T, D] padded, its filter [filter_size · D, num_filters], the bias
    on the last axis.  Only ``filter_stride`` 1 (the reference raises
    too)."""
    if filter_stride != 1:
        raise ValueError("sequence_conv only supports filter_stride=1")
    helper = LayerHelper("sequence_conv")
    w = helper.create_parameter(param_attr,
                                [filter_size * input.shape[-1], num_filters],
                                input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    if padding_start is None:
        padding_start = -int(filter_size // 2)
    inputs = {"X": [input], "Filter": [w]}
    if length is not None:
        inputs["Length"] = [length]
    op = helper.append_op(
        "sequence_conv", inputs=inputs, outputs={"Out": [out]},
        attrs={"contextStart": padding_start, "contextLength": filter_size,
               "contextStride": filter_stride})
    pre_bias = op["Out"][0] if in_dygraph_mode() else out
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters],
                                    pre_bias.dtype, is_bias=True)
        pre_bias = helper.append_bias_op(pre_bias, b, axis=2)
    return helper.append_activation(pre_bias, act)


def sequence_expand(x, y, ref_level=-1):
    return _one("sequence_expand", {"X": [x], "Y": [y]})


def sequence_mask(x, maxlen=None, dtype="int64"):
    helper = LayerHelper("sequence_mask")
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    op = helper.append_op("sequence_mask", inputs={"X": [x]},
                          outputs={"Y": [out]},
                          attrs={"maxlen": maxlen or -1, "out_dtype": dtype})
    return op["Y"][0] if in_dygraph_mode() else out


def sequence_pad(x, pad_value, maxlen=None, length=None, name=None):
    """The time axis cut or extended to ``maxlen`` and ``pad_value``
    written past each row's ``length``: (Out, Length), as the
    reference."""
    helper = LayerHelper("sequence_pad")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    len_out = helper.create_variable_for_type_inference(
        dtype="int64", stop_gradient=True)
    inputs = {"X": [x], "PadValue": [pad_value]}
    if length is not None:
        inputs["Length"] = [length]
    op = helper.append_op(
        "sequence_pad", inputs=inputs,
        outputs={"Out": [out], "Length": [len_out]},
        attrs={"padded_length": -1 if maxlen is None else maxlen})
    if in_dygraph_mode():
        return op["Out"][0], op["Length"][0]
    return out, len_out


def sequence_unpad(x, length, name=None):
    """Positions at or past each row's length zeroed (the padded
    convention's unpad)."""
    return _one("sequence_unpad", {"X": [x], "Length": [length]})


def sequence_erase(input, tokens=None, name=None):
    return _one("sequence_erase", {"X": [input]},
                {"tokens": list(tokens or [])})


def sequence_concat(input, name=None):
    """Concatenated on the time axis (equal batch; ragged tails keep to
    the length convention)."""
    return _one("sequence_concat", {"X": list(input)})


def sequence_first_step(input, length=None):
    return sequence_pool(input, "first", length)


def sequence_last_step(input, length=None):
    return sequence_pool(input, "last", length)


def sequence_slice(input, offset, length, name=None):
    return _one("sequence_slice", {"X": [input], "Offset": [offset],
                                   "Length": [length]})


def sequence_expand_as(x, y, name=None):
    return _one("sequence_expand_as", {"X": [x], "Y": [y]})


def sequence_reshape(input, new_dim):
    return _one("sequence_reshape", {"X": [input]}, {"new_dim": new_dim})


def sequence_scatter(input, index, updates, name=None):
    return _one("sequence_scatter", {"X": [input], "Ids": [index],
                                     "Updates": [updates]})


def sequence_enumerate(input, win_size, pad_value=0, name=None):
    return _one("sequence_enumerate", {"X": [input]},
                {"win_size": win_size, "pad_value": pad_value})
