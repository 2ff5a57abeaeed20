"""fluid.contrib.layers.nn (counterpart of
``paddle_tpu/contrib/layers/nn.py``): the qingshui/search-ads layer tier.
Every builder is sugar over a lowering of the op catalog
(ops/{ctr,misc,nlp,random,fused_extra,catalog_tail}_ops.py), on padded
layouts in place of LoD.
``_pull_box_extended_sparse`` appends no ``W``, as the reference's does,
so its op raises when it runs."""
from __future__ import annotations

from ...fluid.layer_helper import LayerHelper, emit_op
from ...fluid.framework import in_dygraph_mode
from ...fluid import layers as L

__all__ = [
    "fused_elemwise_activation", "sequence_topk_avg_pooling", "var_conv_2d",
    "match_matrix_tensor", "tree_conv", "fused_embedding_seq_pool",
    "multiclass_nms2", "search_pyramid_hash", "shuffle_batch",
    "partial_concat", "sparse_embedding", "partial_sum", "tdm_child",
    "rank_attention", "tdm_sampler", "batch_fc",
    "_pull_box_extended_sparse", "bilateral_slice", "correlation",
    "fused_bn_add_act", "fused_seqpool_cvm", "cross_norm_layer_hadamard",
    "fused_seqpool_cvm_with_pcoc", "scaled_fc", "scaled_int8fc",
]


def _emit(op_type, ins, out_slots, attrs=None, dtype=None):
    """Tuple-unpacking sugar over the shared mode-agnostic emit_op
    (fluid/layer_helper.py) — one op-emission implementation for the whole
    framework.  `dtype` annotates the created output vars in static mode
    (int-output ops like tdm_child)."""
    if dtype is not None and not in_dygraph_mode():
        helper = LayerHelper(op_type)
        outs = {s: [helper.create_variable_for_type_inference(dtype=dtype)]
                for s in out_slots}
        helper.append_op(op_type, inputs=ins, outputs=outs,
                         attrs=attrs or {})
        got = outs
    else:
        got = emit_op(op_type, op_type, ins, out_slots, attrs or {})
    vals = tuple(got[s][0] for s in out_slots)
    return vals if len(vals) > 1 else vals[0]


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    out, inter = _emit("fused_elemwise_activation", {"X": [x], "Y": [y]},
                       ("Out", "IntermediateOut"),
                       {"functor_list": list(functor_list), "axis": axis,
                        "scale": scale,
                        "save_intermediate_out": save_intermediate_out})
    return out


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):
    return _emit("sequence_topk_avg_pooling",
                 {"X": [input], "ROW": [row], "COLUMN": [col]}, ("Out",),
                 {"topks": list(topks), "channel_num": channel_num})


def var_conv_2d(input, row, col, input_channel, output_channel, filter_size,
                stride=1, param_attr=None, act=None, dtype="float32",
                name=None):
    ks = filter_size if isinstance(filter_size, (list, tuple)) \
        else [filter_size, filter_size]
    st = stride if isinstance(stride, (list, tuple)) else [stride, stride]
    helper = LayerHelper("var_conv_2d", name=name)
    w = helper.create_parameter(
        param_attr, [output_channel, input_channel * ks[0] * ks[1]], dtype)
    out, _ = _emit("var_conv_2d",
                   {"X": [input], "ROW": [row], "COLUMN": [col], "W": [w]},
                   ("Out", "Col"),
                   {"input_channel": input_channel,
                    "output_channel": output_channel,
                    "kernel_h": ks[0], "kernel_w": ks[1],
                    "stride_h": st[0], "stride_w": st[1]})
    return L.nn.relu(out) if act == "relu" else out


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None):
    helper = LayerHelper("match_matrix_tensor", name=name)
    dim_in = int(x.shape[-1])
    w = helper.create_parameter(param_attr,
                                [dim_in, channel_num, int(y.shape[-1])],
                                dtype)
    out, tmp = _emit("match_matrix_tensor",
                     {"X": [x], "Y": [y], "W": [w]}, ("Out", "Tmp"),
                     {"dim_t": channel_num})
    if act == "relu":
        out = L.nn.relu(out)
    return out, tmp


def tree_conv(nodes_vector, edge_set, output_size, num_filters=1,
              max_depth=2, act="tanh", param_attr=None, bias_attr=None,
              name=None):
    helper = LayerHelper("tree_conv", name=name)
    feat = int(nodes_vector.shape[-1])
    w = helper.create_parameter(param_attr,
                                [feat, 3, output_size, num_filters],
                                "float32")
    out = _emit("tree_conv",
                {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                 "Filter": [w]}, ("Out",),
                {"max_depth": max_depth, "output_size": output_size,
                 "num_filters": num_filters})
    if bias_attr:
        b = helper.create_parameter(bias_attr, [num_filters], "float32",
                                    is_bias=True)
        out = out + b
    return L.tanh(out) if act == "tanh" else out


def fused_embedding_seq_pool(input, size, is_sparse=False,
                             padding_idx=None, combiner="sum",
                             param_attr=None, dtype="float32"):
    helper = LayerHelper("fused_embedding_seq_pool")
    w = helper.create_parameter(param_attr, list(size), dtype)
    return _emit("fused_embedding_seq_pool", {"Ids": [input], "W": [w]},
                 ("Out",),
                 {"combiner": combiner, "is_sparse": is_sparse,
                  "padding_idx": -1 if padding_idx is None
                  else padding_idx})


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k, keep_top_k,
                    nms_threshold=0.3, normalized=True, nms_eta=1.0,
                    background_label=0, return_index=False, name=None):
    """multiclass_nms with an Index output; its op raises, as
    multiclass_nms's does (its outputs' shapes depend on the data)."""
    out, index = _emit("multiclass_nms2",
                       {"BBoxes": [bboxes], "Scores": [scores]},
                       ("Out", "Index"),
                       {"score_threshold": score_threshold,
                        "nms_top_k": nms_top_k, "keep_top_k": keep_top_k,
                        "nms_threshold": nms_threshold,
                        "normalized": normalized, "nms_eta": nms_eta,
                        "background_label": background_label})
    return (out, index) if return_index else out


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer, rand_len,
                        drop_out_percent, is_training, use_filter,
                        white_list_len, black_list_len, seed, lr,
                        param_attr=None, param_attr_wl=None,
                        param_attr_bl=None, name=None,
                        distribute_update_vars=None, dtype="float32"):
    helper = LayerHelper("pyramid_hash", name=name)
    w = helper.create_parameter(param_attr, [space_len, rand_len], dtype)
    return _emit("pyramid_hash", {"X": [input], "W": [w]}, ("Out",),
                 {"num_emb": num_emb, "space_len": space_len,
                  "pyramid_layer": pyramid_layer, "rand_len": rand_len,
                  "drop_out_percent": drop_out_percent,
                  "is_training": is_training, "use_filter": use_filter,
                  "white_list_len": white_list_len,
                  "black_list_len": black_list_len, "seed": seed, "lr": lr})


def shuffle_batch(x, seed=None):
    out, _idx = _emit("shuffle_batch", {"X": [x]}, ("Out", "ShuffleIdx"),
                      {"startup_seed": seed or 0})
    return out


def partial_concat(input, start_index=0, length=-1):
    ins = input if isinstance(input, (list, tuple)) else [input]
    return _emit("partial_concat", {"X": list(ins)}, ("Out",),
                 {"start_index": start_index, "length": length})


def partial_sum(input, start_index=0, length=-1):
    ins = input if isinstance(input, (list, tuple)) else [input]
    return _emit("partial_sum", {"X": list(ins)}, ("Out",),
                 {"start_index": start_index, "length": length})


def sparse_embedding(input, size, padding_idx=None, is_test=False,
                     entry=None, param_attr=None, dtype="float32"):
    """Large-scale sparse embedding: the embedding builder with
    ``is_distributed`` set, as in the reference."""
    return L.embedding(input, size=list(size), is_sparse=True,
                       is_distributed=True, padding_idx=padding_idx,
                       param_attr=param_attr, dtype=dtype)


def tdm_child(x, node_nums, child_nums, param_attr=None, dtype="int32"):
    helper = LayerHelper("tdm_child")
    tree_info = helper.create_parameter(param_attr,
                                        [node_nums, 3 + child_nums],
                                        "int32")
    tree_info.stop_gradient = True
    child, mask = _emit("tdm_child", {"X": [x], "TreeInfo": [tree_info]},
                        ("Child", "LeafMask"),
                        {"child_nums": child_nums, "dtype": dtype},
                        dtype="int32")
    return child, mask


def tdm_sampler(x, neg_samples_num_list, layer_node_num_list, leaf_node_num,
                tree_travel_attr=None, tree_layer_attr=None,
                output_positive=True, output_list=True, seed=0,
                tree_dtype="int32", dtype="int32"):
    helper = LayerHelper("tdm_sampler")
    n_layers = len(layer_node_num_list)
    travel = helper.create_parameter(tree_travel_attr,
                                     [leaf_node_num, n_layers], "int32")
    layer = helper.create_parameter(tree_layer_attr,
                                    [n_layers, max(layer_node_num_list)],
                                    "int32")
    travel.stop_gradient = True
    layer.stop_gradient = True
    out, labels, mask = _emit(
        "tdm_sampler", {"X": [x], "Travel": [travel], "Layer": [layer]},
        ("Out", "Labels", "Mask"),
        {"neg_samples_num_list": list(neg_samples_num_list),
         "output_positive": output_positive,
         "layer_offset_lod": list(layer_node_num_list), "seed": seed},
        dtype="int32")
    return out, labels, mask


def rank_attention(input, rank_offset, rank_param_shape, rank_param_attr,
                   max_rank=3, max_size=0):
    helper = LayerHelper("rank_attention")
    rank_param = helper.create_parameter(rank_param_attr,
                                         list(rank_param_shape), "float32")
    out, *_ = _emit("rank_attention",
                    {"X": [input], "RankOffset": [rank_offset],
                     "RankParam": [rank_param]},
                    ("Out", "InputHelp", "ParamHelp", "InsRank"),
                    {"MaxRank": max_rank, "MaxSize": max_size})
    return out


def batch_fc(input, param_size, param_attr, bias_size, bias_attr, act=None):
    helper = LayerHelper("batch_fc")
    w = helper.create_parameter(param_attr, list(param_size), "float32")
    b = helper.create_parameter(bias_attr, list(bias_size), "float32",
                                is_bias=True)
    out = _emit("batch_fc", {"Input": [input], "W": [w], "Bias": [b]},
                ("Out",), {"activation": act or "relu"})
    return out


def _pull_box_extended_sparse(input, size, extend_size=64, dtype="float32"):
    ins = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("pull_box_extended_sparse")
    outs = {"Out": [helper.create_variable_for_type_inference(dtype=dtype)
                    for _ in ins],
            "OutExtend": [helper.create_variable_for_type_inference(
                dtype=dtype) for _ in ins]}
    op = helper.append_op("pull_box_extended_sparse",
                          inputs={"Ids": list(ins)}, outputs=outs,
                          attrs={"size": size,
                                 "emb_extended_size": extend_size})
    got = op if in_dygraph_mode() else outs
    if len(ins) == 1:
        return got["Out"][0], got["OutExtend"][0]
    return list(got["Out"]), list(got["OutExtend"])


def bilateral_slice(x, guide, grid, has_offset=False, name=None):
    return _emit("bilateral_slice",
                 {"X": [x], "Guide": [guide], "Grid": [grid]}, ("Out",),
                 {"has_offset": has_offset})


def correlation(x, y, pad_size, kernel_size, max_displacement, stride1,
                stride2, corr_type_multiply=1):
    return _emit("correlation", {"Input1": [x], "Input2": [y]},
                 ("Output",),
                 {"pad_size": pad_size, "kernel_size": kernel_size,
                  "max_displacement": max_displacement, "stride1": stride1,
                  "stride2": stride2,
                  "corr_type_multiply": corr_type_multiply})


def fused_bn_add_act(x, y, momentum=0.9, epsilon=1e-5, param_attr=None,
                     bias_attr=None, moving_mean_name=None,
                     moving_variance_name=None, act=None, name=None):
    """bn(x) + y then act (fused_bn_add_act_op), composed of the
    batch_norm layer, an add and the activation, as in the reference."""
    bn = L.batch_norm(x, momentum=momentum, epsilon=epsilon,
                      param_attr=param_attr, bias_attr=bias_attr,
                      moving_mean_name=moving_mean_name,
                      moving_variance_name=moving_variance_name)
    out = bn + y
    if act:
        out = getattr(L.nn, act)(out)
    return out


def fused_seqpool_cvm(input, pool_type, cvm, pad_value=0.0, use_cvm=True,
                      cvm_offset=2):
    ins = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("fused_seqpool_cvm")
    outs = {"Out": [helper.create_variable_for_type_inference()
                    for _ in ins]}
    op = helper.append_op(
        "fused_seqpool_cvm", inputs={"X": list(ins), "CVM": [cvm]},
        outputs=outs,
        attrs={"pooltype": pool_type.upper(), "pad_value": pad_value,
               "use_cvm": use_cvm, "cvm_offset": cvm_offset})
    got = op if in_dygraph_mode() else outs
    return list(got["Out"])


def fused_seqpool_cvm_with_pcoc(input, pool_type, cvm, pad_value=0.0,
                                use_cvm=True, cvm_offset=3):
    ins = input if isinstance(input, (list, tuple)) else [input]
    helper = LayerHelper("fused_seqpool_cvm_with_pcoc")
    outs = {"Out": [helper.create_variable_for_type_inference()
                    for _ in ins]}
    op = helper.append_op(
        "fused_seqpool_cvm_with_pcoc",
        inputs={"X": list(ins), "CVM": [cvm]}, outputs=outs,
        attrs={"pooltype": pool_type.upper(), "pad_value": pad_value,
               "use_cvm": use_cvm, "cvm_offset": cvm_offset})
    got = op if in_dygraph_mode() else outs
    return list(got["Out"])


def cross_norm_layer_hadamard(input, fields_num, embed_dim, param_attr=None,
                              summary_decay_rate=0.9999999, name=None):
    import numpy as np
    from ...fluid.initializer import NumpyArrayInitializer
    helper = LayerHelper("cross_norm_hadamard", name=name)
    cols = fields_num * embed_dim * 3
    if param_attr is None:
        # SummaryInput rows: [0] running mean (0), [1] running scale (1)
        param_attr = {"initializer": NumpyArrayInitializer(
            np.concatenate([np.zeros((1, cols), "float32"),
                            np.ones((1, cols), "float32")]))}
        from ...fluid.param_attr import ParamAttr
        param_attr = ParamAttr(**param_attr)
    summ = helper.create_parameter(param_attr, [2, cols], "float32")
    out, *_ = _emit("cross_norm_hadamard",
                    {"Input": [input], "SummaryInput": [summ]},
                    ("Out", "CudaMeans", "CudaScales"),
                    {"fields_num": fields_num, "embed_dim": embed_dim,
                     "summary_decay_rate": summary_decay_rate})
    return out


def scaled_fc(input, size, input_scale_factor, bias_scale_factor,
              grad_scale_factor, act=None, param_attr=None, bias_attr=None):
    helper = LayerHelper("scaled_fc")
    in_dim = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [in_dim, size], "float32")
    b = helper.create_parameter(bias_attr, [size], "float32", is_bias=True)
    out = _emit("scaled_fc", {"Input": [input], "W": [w], "Bias": [b]},
                ("Out",),
                {"input_scale_factor": input_scale_factor,
                 "bias_scale_factor": bias_scale_factor,
                 "grad_scale_factor": grad_scale_factor})
    return out


def scaled_int8fc(input, size, input_scale, weight_scale, act=None,
                  param_attr=None, bias_attr=None):
    helper = LayerHelper("scaled_int8fc")
    in_dim = int(input.shape[-1])
    w = helper.create_parameter(param_attr, [in_dim, size], "float32")
    b = helper.create_parameter(bias_attr, [size], "float32", is_bias=True)
    return _emit("scaled_int8fc",
                 {"Input": [input], "W": [w], "Bias": [b]}, ("Out",),
                 {"input_scale": input_scale, "weight_scale": weight_scale})
