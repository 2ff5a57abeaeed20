"""AMP op lists (counterpart of ``paddle_tpu/amp/lists.py``, the two lists
the dygraph tracer's bf16 autocast reads; the registry audit and the
fp32-family list come with the static AMP pass).

White ops run in bf16 (their products accumulate in float32 and return
bf16, as ``torch.matmul`` does); black ops run in float32; every other op
is gray and follows its inputs (``dygraph/base.py Tracer._autocast``).
The norm family is gray on purpose: its lowerings take their statistics
in float32 inside and cast back.
"""

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
