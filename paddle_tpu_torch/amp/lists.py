"""AMP op lists (counterpart of ``paddle_tpu/amp/lists.py``): the two lists
the dygraph tracer's bf16 autocast reads, and the taxonomy the static
``amp_bf16`` pass classifies ops by (``classify``, with the fp32 family
and the registry audit ``unclassified_family_ops``).

White ops run in bf16 (their products accumulate in float32 and return
bf16, as ``torch.matmul`` does); black ops run in float32; every other op
is gray and follows its inputs (``dygraph/base.py Tracer._autocast``).
The norm family is gray on purpose: its lowerings take their statistics
in float32 inside and cast back.
"""
import re

WHITE_OPS = {
    "matmul", "matmul_v2", "mul", "bmm", "mv", "conv2d",
    "depthwise_conv2d", "conv2d_transpose", "conv3d", "conv3d_transpose",
    "conv_fusion", "fc", "batch_fc", "scaled_fc", "multihead_matmul",
    "fused_multihead_attention", "var_conv_2d", "sequence_conv",
    "row_conv",
}
BLACK_OPS = {
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "reduce_mean", "reduce_sum", "mean", "sum", "exp",
    "log", "rsqrt", "sqrt", "square", "sigmoid_cross_entropy_with_logits",
    "cumsum", "p_norm", "l2_normalize", "softplus",
}

# matmul/conv-family ops deliberately kept fp32: recurrent cells whose
# hidden-state chains drift in bf16, int8-quantized kernels, gather-heavy
# deformable/tree variants, and fusions that embed a norm (stats must be
# f32) — classified so the registry audit can tell "decided fp32" from
# "nobody looked".
FP32_FAMILY_OPS = {
    "attention_lstm", "fused_embedding_fc_lstm", "multi_gru",
    # paged decode attention: the op's contract is bit-identity with the
    # unfused gather+softmax chain (serving exactness gate) — bf16 would
    # break it, and decode is bound by memory, not by products
    "paged_attention",
    "scaled_int8fc", "fused_fc_elementwise_layernorm", "deformable_conv",
    "deformable_conv_v1", "conv_shift", "rank_attention",
    "fusion_conv_inception", "fusion_repeated_fc_relu",
    "fusion_seqconv_eltadd_relu", "fusion_seqexpand_concat_fc",
    "tree_conv", "dot",
}
# the norm family (batch/sync_batch/layer/instance/group_norm) is gray,
# not black: their lowerings compute statistics in float32 inside and
# cast back, so black-listing them would only add a bf16 -> f32 -> bf16
# round trip of every activation at every conv+BN / matmul+LN boundary.
# everything else: gray — runs in whatever dtype arrives

# names that MATCH the family regex but are not matmul/conv compute
# (elementwise mul, NMS "multi", comm plumbing, accumulators)
_FAMILY_FALSE_POSITIVES = {
    "elementwise_mul", "multiclass_nms", "multiclass_nms2", "multinomial",
    "multiplex", "multi_gru", "slice_multi_tensor", "average_accumulates",
    "c_comm_init_multitrainer",
}

_FAMILY_RE = re.compile(r"matmul|conv|bmm|attention|fc|gemm|^mul$|^mv$"
                        r"|^dot$|^multi")


def is_mxu_family(op_type: str) -> bool:
    """Does this op name claim matmul/conv-family compute?"""
    return (bool(_FAMILY_RE.search(op_type))
            and op_type not in _FAMILY_FALSE_POSITIVES)


def classify(op_type: str, white=None, black=None) -> str:
    """'white' | 'black' | 'fp32' | 'gray' under optional custom lists.
    Custom lists EXTEND the defaults and WIN over them — a custom white
    entry moves an op out of the default black list (reference
    fp16_lists semantics: custom_white_list overrides), and custom black
    wins custom-white overlaps.  This is the single source of truth for
    the taxonomy: AmpBf16Pass delegates here, so
    BuildStrategy.amp_custom_white_list/_black_list get exactly these
    semantics."""
    custom_black = set(black or ())
    if op_type in custom_black:
        return "black"
    if op_type in set(white or ()) - custom_black:
        return "white"
    if op_type in BLACK_OPS:
        return "black"
    if op_type in WHITE_OPS:
        return "white"
    if op_type in FP32_FAMILY_OPS:
        return "fp32"
    if is_mxu_family(op_type):
        return "unclassified"      # family op nobody classified — caller
    return "gray"                  # warns once and runs it fp32


def unclassified_family_ops():
    """Registered matmul/conv-family ops missing from every list — the
    registry-audit surface (kept empty by tests/test_amp_plane.py)."""
    from ..ops.registry import all_ops
    return sorted(op for op in all_ops()
                  if is_mxu_family(op)
                  and op not in WHITE_OPS
                  and op not in BLACK_OPS
                  and op not in FP32_FAMILY_OPS)
