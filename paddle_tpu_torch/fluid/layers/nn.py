"""fluid.layers op builders (counterpart of
``paddle_tpu/fluid/layers/nn.py``, the subset the ported slices build).  Each
builder appends the same op type, slots and attrs as the TPU package; under
a dygraph tracer it runs the op eagerly and returns its output VarBase."""
from __future__ import annotations

import sys

import numpy as np

from ..framework import in_dygraph_mode, unique_name
from ..layer_helper import LayerHelper
from .tensor import _to_variable


def _out(op, slot, var):
    """The layer's result: the traced output in dygraph mode, the
    declared Variable in static mode."""
    return op[slot][0] if in_dygraph_mode() else var


def _single_out(op_type, x, attrs=None, dtype=None, out_slot="Out",
                in_slot="X", stop_gradient=False):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(
        dtype=dtype or getattr(x, "dtype", "float32"),
        stop_gradient=stop_gradient)
    op = helper.append_op(op_type, inputs={in_slot: [x]},
                          outputs={out_slot: [out]}, attrs=attrs or {})
    return _out(op, out_slot, out)


def relu(x, name=None, **attrs):
    attrs.pop("inplace", None)
    return _single_out("relu", x, attrs)


def relu6(x, name=None, **attrs):
    """``clip(x, 0, threshold)``; ``threshold`` (default 6) among
    ``attrs``, as the reference's generated layer function takes it."""
    attrs.pop("inplace", None)
    return _single_out("relu6", x, attrs)


def gelu(x, name=None, **attrs):
    """``approximate`` (default False) among ``attrs``, as the
    reference's generated layer function takes it."""
    attrs.pop("inplace", None)
    return _single_out("gelu", x, attrs)


def tanh(x, name=None, **attrs):
    attrs.pop("inplace", None)
    return _single_out("tanh", x, attrs)


def sigmoid(x, name=None):
    return _single_out("sigmoid", x)


def elementwise_op(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    if not in_dygraph_mode():
        y = _to_variable(None, y, getattr(x, "dtype", None))
    out = helper.create_variable_for_type_inference(
        dtype=getattr(x, "dtype", "float32"))
    op = helper.append_op(op_type, inputs={"X": [x], "Y": [y]},
                          outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(_out(op, "Out", out), act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_add", x, y, axis, act, name)


def _reduce_layer(op_type, x, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    if dim is None:
        dim, reduce_all = [0], True
    else:
        dim = [dim] if isinstance(dim, int) else list(dim)
        reduce_all = False
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op(op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                          attrs={"dim": dim, "keep_dim": keep_dim,
                                 "reduce_all": reduce_all})
    return _out(op, "Out", out)


def reduce_mean(x, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", x, dim, keep_dim, name)


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", x, dim, keep_dim, name)


def mean(x, name=None):
    return _single_out("mean", x)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully-connected: input [d0..dk, in] -> [d0..dk, size] through a
    ``mul`` op (mul_op.cc flatten semantics) and a bias add; several
    inputs get a weight each and their products one ``sum``."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    outs = []
    for inp in inputs:
        in_dim = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [in_dim, size], inp.dtype)
        tmp = helper.create_variable_for_type_inference(dtype=inp.dtype)
        op = helper.append_op("mul", inputs={"X": [inp], "Y": [w]},
                              outputs={"Out": [tmp]},
                              attrs={"x_num_col_dims": num_flatten_dims,
                                     "y_num_col_dims": 1})
        # under a tracer the bias adds to the traced product
        outs.append(_out(op, "Out", tmp))
    if len(outs) > 1:
        from .tensor import sums
        pre_bias = sums(outs)
    else:
        pre_bias = outs[0]
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], pre_bias.dtype,
                                    is_bias=True)
        pre_act = helper.append_bias_op(pre_bias, b, axis=num_flatten_dims)
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """embedding -> lookup_table_v2."""
    helper = LayerHelper("embedding")
    w = helper.create_parameter(param_attr, list(size), dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    op = helper.append_op("lookup_table_v2",
                          inputs={"W": [w], "Ids": [input]},
                          outputs={"Out": [out]},
                          attrs={"padding_idx": padding_idx,
                                 "is_sparse": is_sparse})
    return _out(op, "Out", out)


def data_norm(input, act=None, epsilon=1e-4, param_attr=None,
              data_layout="NCHW", in_place=False, name=None,
              moving_mean_name=None, moving_variance_name=None,
              do_model_average_for_mean_and_var=True, slot_dim=-1,
              sync_stats=False, summary_decay_rate=0.9999999,
              enable_scale_and_shift=False):
    """CTR feature normalisation over persistable summary statistics
    (data_norm_op.cc): ``batch_size`` (1e4), ``batch_sum`` (0) and
    ``batch_square_sum`` (1e4) a column, not trainable; the op writes
    their decayed update itself.  The op reads ``assign`` snapshots of
    them, so the backward reads the step's values while the update
    writes the parameters."""
    from ..initializer import ConstantInitializer
    from ..param_attr import ParamAttr

    helper = LayerHelper("data_norm", name=name)
    c = int(input.shape[-1])
    cfg = param_attr if isinstance(param_attr, dict) else {}
    base = name or unique_name("data_norm")
    stats = {}
    for suffix, default in (("batch_size", cfg.get("batch_size", 1e4)),
                            ("batch_sum", cfg.get("batch_sum", 0.0)),
                            ("batch_square_sum",
                             cfg.get("batch_square", 1e4))):
        p = helper.create_parameter(
            ParamAttr(name=f"{base}.{suffix}",
                      initializer=ConstantInitializer(float(default))),
            [c], input.dtype)
        p.stop_gradient = True
        p.trainable = False
        snap = helper.create_variable_for_type_inference(dtype=input.dtype)
        helper.append_op("assign", inputs={"X": [p]},
                         outputs={"Out": [snap]})
        stats[suffix] = (p, snap)
    inputs = {"X": [input], "BatchSize": [stats["batch_size"][1]],
              "BatchSum": [stats["batch_sum"][1]],
              "BatchSquareSum": [stats["batch_square_sum"][1]]}
    if enable_scale_and_shift:
        sw = helper.create_parameter(
            ParamAttr(name=f"{base}.scale_w",
                      initializer=ConstantInitializer(
                          float(cfg.get("scale_w", 1.0)))), [c], input.dtype)
        b = helper.create_parameter(
            ParamAttr(name=f"{base}.bias",
                      initializer=ConstantInitializer(
                          float(cfg.get("bias", 0.0)))), [c], input.dtype)
        inputs["ScaleW"], inputs["Bias"] = [sw], [b]
    y = helper.create_variable_for_type_inference(dtype=input.dtype)
    means = helper.create_variable_for_type_inference(dtype=input.dtype)
    scales = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op(
        "data_norm", inputs=inputs,
        outputs={"Y": [y], "Means": [means], "Scales": [scales],
                 "BatchSizeOut": [stats["batch_size"][0]],
                 "BatchSumOut": [stats["batch_sum"][0]],
                 "BatchSquareSumOut": [stats["batch_square_sum"][0]]},
        attrs={"epsilon": epsilon, "slot_dim": slot_dim,
               "summary_decay_rate": summary_decay_rate,
               "enable_scale_and_shift": enable_scale_and_shift})
    out = op["Y"][0] if in_dygraph_mode() else y
    return helper.append_activation(out, act)


def pull_box_sparse(input, size, table_name="default_box", dtype="float32"):
    """layers.pull_box_sparse (pull_box_sparse_op.cc): embedding lookups
    served by the BoxPS tier (distributed/ps/box.py).  The host table may
    be larger than the card; the op gathers from the pass's device cache,
    the parameter ``<table_name>@HBMCACHE``, whose rows ``begin_pass``
    stages and ``end_pass`` writes back.  The ids the program sees are
    cache slots: the trainer's box plan (``program._hints["box_plan"]``)
    translates raw feasign ids per batch."""
    from ..framework import default_main_program

    helper = LayerHelper("pull_box_sparse")
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    main = default_main_program()
    gb = main.global_block()
    cache_name = f"{table_name}@HBMCACHE"
    # checked before the program changes: a half-appended op would leave
    # the graph broken
    prior = main._hints.get("box_plan")
    if prior is not None:
        if prior["table"] != table_name:
            raise ValueError(
                "one box table per program (the reference BoxWrapper is a "
                f"singleton); got a second table '{table_name}' vs "
                f"'{prior['table']}'")
        if prior["dim"] != int(size):
            raise ValueError(
                f"box table '{table_name}' used with size {size} but was "
                f"first declared with size {prior['dim']}")
    if gb.has_var(cache_name):
        w = gb.var(cache_name)
    else:
        # no startup init op on purpose: begin_pass seeds the scope value
        w = gb.create_parameter(name=cache_name, shape=(-1, int(size)),
                                dtype=dtype)
    outs = [helper.create_variable_for_type_inference(dtype=dtype)
            for _ in inputs]
    helper.append_op("pull_box_sparse",
                     inputs={"W": [w], "Ids": inputs},
                     outputs={"Out": outs},
                     attrs={"size": int(size)})
    plan = main._hints.setdefault(
        "box_plan", {"table": table_name, "cache": cache_name,
                     "dim": int(size), "ids": []})
    for v in inputs:
        n = v.name if hasattr(v, "name") else str(v)
        if n not in plan["ids"]:
            plan["ids"].append(n)
    if isinstance(input, (list, tuple)):
        return outs
    return outs[0]


def cos_sim(X, Y, name=None):
    """Cosine similarity along the last axis (cos_sim_op.cc)."""
    helper = LayerHelper("cos_sim", name=name)
    out = helper.create_variable_for_type_inference(dtype=X.dtype)
    xn = helper.create_variable_for_type_inference(dtype=X.dtype)
    yn = helper.create_variable_for_type_inference(dtype=X.dtype)
    op = helper.append_op("cos_sim", inputs={"X": [X], "Y": [Y]},
                          outputs={"Out": [out], "XNorm": [xn],
                                   "YNorm": [yn]})
    return _out(op, "Out", out)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("matmul", inputs={"X": [x], "Y": [y]},
                          outputs={"Out": [out]},
                          attrs={"transpose_X": transpose_x,
                                 "transpose_Y": transpose_y,
                                 "alpha": float(alpha)})
    return _out(op, "Out", out)


def _dropout_attrs(helper, dropout_prob, is_test, seed,
                   dropout_implementation):
    """A static op draws its op_seed from the program; a traced one keeps
    ``seed or 0`` and takes its randomness from the tracer's per-op seed
    (dygraph/base.py)."""
    return {"dropout_prob": dropout_prob, "is_test": is_test,
            "dropout_implementation": dropout_implementation,
            "op_seed": seed or (0 if in_dygraph_mode()
                                else helper.main_program.next_op_seed())}


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    mask = helper.create_variable_for_type_inference(dtype="uint8",
                                                     stop_gradient=True)
    attrs = _dropout_attrs(helper, dropout_prob, is_test, seed,
                           dropout_implementation)
    op = helper.append_op("dropout", inputs={"X": [x]},
                          outputs={"Out": [out], "Mask": [mask]},
                          attrs=attrs)
    return _out(op, "Out", out)


def fused_dropout_add(x, residual, dropout_prob, is_test=False, seed=None,
                      name=None, dropout_implementation="upscale_in_train"):
    """dropout(x) + residual as one op (one kernel on the card), the mask
    regenerated in the backward."""
    helper = LayerHelper("fused_dropout_add", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("fused_dropout_add",
                          inputs={"X": [x], "Residual": [residual]},
                          outputs={"Out": [out]},
                          attrs=_dropout_attrs(helper, dropout_prob, is_test,
                                               seed, dropout_implementation))
    return _out(op, "Out", out)


def fused_act_dropout(x, act="gelu", dropout_prob=0.0, is_test=False,
                      seed=None, name=None,
                      dropout_implementation="upscale_in_train"):
    """dropout(act(x)) as one op; its backward fuses act'(x) with the
    regenerated mask."""
    helper = LayerHelper("fused_act_dropout", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    attrs = _dropout_attrs(helper, dropout_prob, is_test, seed,
                           dropout_implementation)
    attrs["act"] = act
    op = helper.append_op("fused_act_dropout", inputs={"X": [x]},
                          outputs={"Out": [out]}, attrs=attrs)
    return _out(op, "Out", out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    from ..initializer import ConstantInitializer
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, norm_shape, input.dtype,
            default_initializer=ConstantInitializer(1.0))]
    if shift:
        inputs["Bias"] = [helper.create_parameter(
            bias_attr, norm_shape, input.dtype, is_bias=True)]
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    m = helper.create_variable_for_type_inference(dtype="float32",
                                                  stop_gradient=True)
    v = helper.create_variable_for_type_inference(dtype="float32",
                                                  stop_gradient=True)
    op = helper.append_op("layer_norm", inputs=inputs,
                          outputs={"Y": [out], "Mean": [m], "Variance": [v]},
                          attrs={"epsilon": epsilon,
                                 "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(_out(op, "Y", out), act)


def cast(x, dtype):
    from ..framework import convert_dtype
    helper = LayerHelper("cast")
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    op = helper.append_op("cast", inputs={"X": [x]}, outputs={"Out": [out]},
                          attrs={"out_dtype": dtype})
    return _out(op, "Out", out)


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    op = helper.append_op("squeeze2", inputs={"X": [input]},
                          outputs={"Out": [out], "XShape": [xshape]},
                          attrs={"axes": list(axes)})
    return _out(op, "Out", out)


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=input.dtype,
                                                       stop_gradient=True)
    op = helper.append_op("unsqueeze2", inputs={"X": [input]},
                          outputs={"Out": [out], "XShape": [xshape]},
                          attrs={"axes": list(axes)})
    return _out(op, "Out", out)


def one_hot(input, depth, allow_out_of_range=False):
    return _single_out("one_hot", input, {"depth": depth}, dtype="float32",
                       stop_gradient=True)


def gather(input, index, overwrite=True):
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("gather", inputs={"X": [input], "Index": [index]},
                          outputs={"Out": [out]})
    return _out(op, "Out", out)


def split(input, num_or_sections, dim=-1, name=None):
    """``input`` cut along ``dim`` into ``num_or_sections`` equal parts,
    or parts of the listed sizes; a list of outputs."""
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n, sections = num_or_sections, []
    else:
        n, sections = len(num_or_sections), list(num_or_sections)
    outs = [helper.create_variable_for_type_inference(dtype=input.dtype)
            for _ in range(n)]
    op = helper.append_op("split", inputs={"X": [input]},
                          outputs={"Out": outs},
                          attrs={"axis": dim, "num": n, "sections": sections})
    return list(op["Out"]) if in_dygraph_mode() else outs


def stack(x, axis=0):
    helper = LayerHelper("stack")
    x = x if isinstance(x, (list, tuple)) else [x]
    out = helper.create_variable_for_type_inference(dtype=x[0].dtype)
    op = helper.append_op("stack", inputs={"X": list(x)},
                          outputs={"Y": [out]}, attrs={"axis": axis})
    return _out(op, "Y", out)


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice")
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("slice", inputs={"Input": [input]},
                          outputs={"Out": [out]},
                          attrs={"axes": list(axes), "starts": list(starts),
                                 "ends": list(ends)})
    return _out(op, "Out", out)


def softmax(input, axis=-1, use_cudnn=False, name=None):
    return _single_out("softmax", input, {"axis": axis})


def reshape(x, shape, actual_shape=None, act=None, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    op = helper.append_op("reshape2", inputs={"X": [x]},
                          outputs={"Out": [out], "XShape": [xshape]},
                          attrs={"shape": list(shape)})
    return helper.append_activation(_out(op, "Out", out), act)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    op = helper.append_op("transpose2", inputs={"X": [x]},
                          outputs={"Out": [out], "XShape": [xshape]},
                          attrs={"axis": list(perm)})
    return _out(op, "Out", out)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("scale", inputs={"X": [x]}, outputs={"Out": [out]},
                          attrs={"scale": float(scale), "bias": float(bias),
                                 "bias_after_scale": bias_after_scale})
    return helper.append_activation(_out(op, "Out", out), act)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return elementwise_op("elementwise_max", x, y, axis, act, name)


def square(x, name=None, **attrs):
    attrs.pop("inplace", None)
    return _single_out("square", x, attrs)


def sqrt(x, name=None, **attrs):
    attrs.pop("inplace", None)
    return _single_out("sqrt", x, attrs)


def clip(x, min, max, name=None):
    return _single_out("clip", x, {"min": float(min), "max": float(max)})


def clip_by_norm(x, max_norm, name=None):
    return _single_out("clip_by_norm", x, {"max_norm": float(max_norm)})


def _pair(v):
    return [v, v] if isinstance(v, int) else list(v)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, param_attr=None, bias_attr=None, use_cudnn=True,
           act=None, name=None, data_format="NCHW"):
    """conv2d with a He-normal filter [num_filters, C/groups, kh, kw] and a
    bias added on the channel axis (1 for NCHW, the last for NHWC, as the
    dygraph ``Conv2D`` adds it; the reference's static layer adds it on
    axis 1 in either layout, which fails for NHWC); ``padding`` is an
    int, 2 or 4 ints, or ``"SAME"`` / ``"VALID"``."""
    import math
    from ..initializer import NormalInitializer
    helper = LayerHelper("conv2d", name=name)
    filter_size = _pair(filter_size)
    stride, dilation = _pair(stride), _pair(dilation)
    padding_algorithm = "EXPLICIT"
    if isinstance(padding, str):
        padding_algorithm = padding.upper()
        padding = [0, 0]
    elif isinstance(padding, int):
        padding = [padding, padding]
    num_channels = input.shape[1 if data_format == "NCHW" else -1]
    w_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    w = helper.create_parameter(
        param_attr, w_shape, input.dtype,
        default_initializer=NormalInitializer(0., math.sqrt(2.0 / fan_in)))
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op(
        "conv2d", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]},
        attrs={"strides": stride, "paddings": list(padding),
               "dilations": dilation, "groups": groups,
               "padding_algorithm": padding_algorithm,
               "data_format": data_format})
    out = _out(op, "Output", out)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(
            out, b, axis=1 if data_format == "NCHW" else -1)
    return helper.append_activation(out, act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, exclusive=True, name=None, data_format="NCHW"):
    helper = LayerHelper("pool2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op(
        "pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"ksize": _pair(pool_size), "pooling_type": pool_type,
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "global_pooling": global_pooling, "exclusive": exclusive,
               "ceil_mode": ceil_mode, "data_format": data_format})
    return _out(op, "Out", out)


def adaptive_pool2d(input, pool_size, pool_type="max", name=None,
                    data_format="NCHW"):
    helper = LayerHelper("adaptive_pool2d", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("adaptive_pool2d", inputs={"X": [input]},
                          outputs={"Out": [out]},
                          attrs={"ksize": _pair(pool_size),
                                 "pooling_type": pool_type,
                                 "data_format": data_format})
    return _out(op, "Out", out)


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None,
               do_model_average_for_mean_and_var=True,
               use_global_stats=False):
    """batch_norm with scale 1, bias 0 and the moving mean and variance
    (0 and 1) as persistable parameters that are not trained; the op
    writes the moving statistics back under their own names."""
    from ..initializer import ConstantInitializer
    from ..param_attr import ParamAttr
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1 if data_layout == "NCHW" else -1]
    scale = helper.create_parameter(
        param_attr, [c], input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, [c], input.dtype, is_bias=True)
    mean = helper.create_parameter(
        ParamAttr(name=moving_mean_name, trainable=False,
                  initializer=ConstantInitializer(0.0)), [c], input.dtype)
    var = helper.create_parameter(
        ParamAttr(name=moving_variance_name, trainable=False,
                  initializer=ConstantInitializer(1.0)), [c], input.dtype)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    saved_m = helper.create_variable_for_type_inference(dtype="float32",
                                                        stop_gradient=True)
    saved_v = helper.create_variable_for_type_inference(dtype="float32",
                                                        stop_gradient=True)
    op = helper.append_op(
        "batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [var]},
        outputs={"Y": [out], "MeanOut": [mean], "VarianceOut": [var],
                 "SavedMean": [saved_m], "SavedVariance": [saved_v]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout,
               "use_global_stats": use_global_stats})
    return helper.append_activation(_out(op, "Y", out), act)


def flatten(x, axis=1, name=None):
    helper = LayerHelper("flatten2", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    xshape = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                       stop_gradient=True)
    op = helper.append_op("flatten2", inputs={"X": [x]},
                          outputs={"Out": [out], "XShape": [xshape]},
                          attrs={"axis": axis})
    return _out(op, "Out", out)


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    ids = helper.create_variable_for_type_inference(dtype="int64",
                                                    stop_gradient=True)
    op = helper.append_op("top_k", inputs={"X": [input]},
                          outputs={"Out": [out], "Indices": [ids]},
                          attrs={"k": k})
    if in_dygraph_mode():
        return op["Out"][0], op["Indices"][0]
    return out, ids



# ---------------------------------------------------------------------------
# the 2.0 surface's builders (paddle.tensor, nn.functional): the generated
# unary, elementwise and reduce families, and the layout ops
# ---------------------------------------------------------------------------
_this = sys.modules[__name__]
_UNARY = [
    "logsigmoid", "tanh_shrink", "erf", "exp", "log", "log2", "log10",
    "log1p", "rsqrt", "abs", "ceil", "floor", "round", "reciprocal", "sign",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "softplus",
    "softsign", "softshrink", "hard_shrink", "hard_sigmoid", "hard_swish",
    "swish", "mish", "selu", "elu", "leaky_relu", "brelu",
    "thresholded_relu", "stanh", "silu", "logsumexp",
]
for _name in _UNARY:
    def _mk(op_type):
        def f(x, name=None, **attrs):
            attrs.pop("inplace", None)
            return _single_out(op_type, x, attrs)
        f.__name__ = op_type
        return f
    setattr(_this, _name, _mk(_name))

for _name in ["elementwise_min", "elementwise_pow", "elementwise_mod",
              "elementwise_floordiv"]:
    def _mk2(op_type):
        def f(x, y, axis=-1, act=None, name=None):
            return elementwise_op(op_type, x, y, axis, act, name)
        f.__name__ = op_type
        return f
    setattr(_this, _name, _mk2(_name))

for _name in ["reduce_max", "reduce_min", "reduce_prod", "reduce_all",
              "reduce_any"]:
    def _mkr(op_type):
        def f(x, dim=None, keep_dim=False, name=None):
            return _reduce_layer(op_type, x, dim, keep_dim, name)
        f.__name__ = op_type
        return f
    setattr(_this, _name, _mkr(_name))


def log_softmax(input, axis=-1):
    return _single_out("log_softmax", input, {"axis": axis})


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1):
    """The matrix-flattening ``mul`` op (mul_op.cc), not an elementwise
    product."""
    helper = LayerHelper("mul")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("mul", inputs={"X": [x], "Y": [y]},
                          outputs={"Out": [out]},
                          attrs={"x_num_col_dims": x_num_col_dims,
                                 "y_num_col_dims": y_num_col_dims})
    return _out(op, "Out", out)


def _two_in(op_type, x, y, slots=("X", "Y"), attrs=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op(op_type, inputs={slots[0]: [x], slots[1]: [y]},
                          outputs={"Out": [out]}, attrs=attrs or {})
    return _out(op, "Out", out)


def gather_nd(input, index, name=None):
    return _two_in("gather_nd", input, index, ("X", "Index"), name=name)


def scatter(input, index, updates, name=None, overwrite=True):
    helper = LayerHelper("scatter", name=name)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op("scatter",
                          inputs={"X": [input], "Ids": [index],
                                  "Updates": [updates]},
                          outputs={"Out": [out]},
                          attrs={"overwrite": overwrite})
    return _out(op, "Out", out)


def unstack(x, axis=0, num=None):
    helper = LayerHelper("unstack")
    num = num or x.shape[axis]
    outs = [helper.create_variable_for_type_inference(dtype=x.dtype)
            for _ in range(num)]
    op = helper.append_op("unstack", inputs={"X": [x]}, outputs={"Y": outs},
                          attrs={"axis": axis, "num": num})
    return list(op["Y"]) if in_dygraph_mode() else outs


def expand(x, expand_times, name=None):
    return _single_out("expand", x, {"expand_times": list(expand_times)})


def expand_as(x, target_tensor, name=None):
    return _two_in("expand_as_v2", x, target_tensor, name=name)


def pad(x, paddings, pad_value=0.0, name=None):
    return _single_out("pad", x, {"paddings": list(paddings),
                                  "pad_value": float(pad_value)})


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    norm = helper.create_variable_for_type_inference(dtype=x.dtype,
                                                     stop_gradient=True)
    op = helper.append_op("l2_normalize", inputs={"X": [x]},
                          outputs={"Out": [out], "Norm": [norm]},
                          attrs={"axis": axis, "epsilon": epsilon})
    return _out(op, "Out", out)


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype=dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    op = helper.append_op("label_smooth", inputs=inputs,
                          outputs={"Out": [out]},
                          attrs={"epsilon": float(epsilon)})
    return _out(op, "Out", out)


def where(condition, x, y):
    helper = LayerHelper("where")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("where", inputs={"Condition": [condition],
                                           "X": [x], "Y": [y]},
                          outputs={"Out": [out]})
    return _out(op, "Out", out)


def cond_value(cond, tv, fv):
    return where(cond, tv, fv)


def _random(op_type, shape, dtype, seed, **attrs):
    """A random op's output of ``shape``; in a program an unseeded op
    takes the program's next op seed."""
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype=dtype,
                                                    stop_gradient=True)
    attrs = dict(attrs, shape=list(shape), dtype=dtype)
    if not in_dygraph_mode():
        attrs["op_seed"] = seed or helper.main_program.next_op_seed()
    op = helper.append_op(op_type, outputs={"Out": [out]}, attrs=attrs)
    return _out(op, "Out", out)


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    return _random("uniform_random", shape, dtype, seed, min=min, max=max)


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    return _random("gaussian_random", shape, dtype, seed, mean=mean,
                   std=std)


def matmul_v2(x, y, trans_x=False, trans_y=False):
    helper = LayerHelper("matmul_v2")
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    op = helper.append_op("matmul_v2", inputs={"X": [x], "Y": [y]},
                          outputs={"Out": [out]},
                          attrs={"trans_x": trans_x, "trans_y": trans_y})
    return _out(op, "Out", out)


# -- the image layers ---------------------------------------------------------
def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     stride=1, padding=0, dilation=1, groups=1,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """A transposed convolution with a filter ``[C, num_filters/groups,
    kh, kw]`` and a bias on axis 1.  ``output_size`` reaches the op, which
    adds the rows it asks for on the high edge (the reference's builder
    drops it and gives ``(in - 1)·s - 2p + k``)."""
    helper = LayerHelper("conv2d_transpose", name=name)
    if filter_size is None:
        raise ValueError("conv2d_transpose needs filter_size")
    w = helper.create_parameter(
        param_attr, [input.shape[1], num_filters // groups]
        + _pair(filter_size), input.dtype)
    attrs = {"strides": _pair(stride), "paddings": _pair(padding),
             "dilations": _pair(dilation), "groups": groups}
    if output_size is not None:
        attrs["output_size"] = _pair(output_size)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    op = helper.append_op(
        "conv2d_transpose", inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [out]}, attrs=attrs)
    out = _out(op, "Output", out)
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [num_filters], input.dtype,
                                    is_bias=True)
        out = helper.append_bias_op(out, b, axis=1)
    return helper.append_activation(out, act)


def _norm_affine(helper, input, param_attr, bias_attr):
    """The per-channel scale (1) and bias (0) of a norm layer, each left
    out when its attr is False."""
    from ..initializer import ConstantInitializer
    c = input.shape[1]
    inputs = {"X": [input]}
    if param_attr is not False:
        inputs["Scale"] = [helper.create_parameter(
            param_attr, [c], input.dtype,
            default_initializer=ConstantInitializer(1.0))]
    if bias_attr is not False:
        inputs["Bias"] = [helper.create_parameter(bias_attr, [c], input.dtype,
                                                  is_bias=True)]
    return inputs


def group_norm(input, groups, epsilon=1e-5, param_attr=None, bias_attr=None,
               act=None, data_layout="NCHW", name=None):
    helper = LayerHelper("group_norm", name=name)
    inputs = _norm_affine(helper, input, param_attr, bias_attr)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    m = helper.create_variable_for_type_inference(dtype="float32",
                                                  stop_gradient=True)
    v = helper.create_variable_for_type_inference(dtype="float32",
                                                  stop_gradient=True)
    op = helper.append_op("group_norm", inputs=inputs,
                          outputs={"Y": [out], "Mean": [m], "Variance": [v]},
                          attrs={"groups": groups, "epsilon": epsilon})
    return helper.append_activation(_out(op, "Y", out), act)


def instance_norm(input, epsilon=1e-5, param_attr=None, bias_attr=None,
                  name=None):
    helper = LayerHelper("instance_norm", name=name)
    inputs = _norm_affine(helper, input, param_attr, bias_attr)
    out = helper.create_variable_for_type_inference(dtype=input.dtype)
    sm = helper.create_variable_for_type_inference(dtype="float32",
                                                   stop_gradient=True)
    sv = helper.create_variable_for_type_inference(dtype="float32",
                                                   stop_gradient=True)
    op = helper.append_op("instance_norm", inputs=inputs,
                          outputs={"Y": [out], "SavedMean": [sm],
                                   "SavedVariance": [sv]},
                          attrs={"epsilon": epsilon})
    return _out(op, "Y", out)


def pad2d(input, paddings=[0, 0, 0, 0], mode="constant", pad_value=0.0,
          data_format="NCHW", name=None):
    return _single_out("pad2d", input,
                       {"paddings": list(paddings), "mode": mode,
                        "pad_value": float(pad_value),
                        "data_format": data_format})


def relu_(x):
    """relu (in place in the reference's name only)."""
    return relu(x)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    p = [paddings] * 4 if isinstance(paddings, int) else list(paddings)
    return _single_out("unfold", x,
                       {"kernel_sizes": _pair(kernel_sizes),
                        "strides": _pair(strides), "paddings": p,
                        "dilations": _pair(dilations)}, out_slot="Y")
