"""Per-op exclusion reasons for the grad sweep (counterpart of
``paddle_tpu/ops/nondiff_reasons.py``).

Every ``differentiable=False`` lowering gets one structural category
(int outputs, optimizer updates, RNG, host plumbing...), stamped onto
its ``OpDef.nondiff_reason`` when ``ops/__init__.py`` is imported, so an
op is either differentiated by ``generic_grad`` or carries the reason it
is not.  The categories and the op -> category map are the reference's,
entry for entry; an op the port does not register yet is skipped.
"""
from __future__ import annotations

from .registry import _OP_REGISTRY

CATEGORIES = {
    "optimizer": "parameter-update rule: consumes grads, produces new "
                 "state; has no cotangent of its own (reference excludes "
                 "all optimizer ops from check_grad)",
    "int_output": "integer/boolean/index outputs only — the map is "
                  "piecewise constant, d/dx == 0 everywhere it exists",
    "rng": "output is a random sample; no deterministic input->output "
           "map to differentiate (seeds are not differentiable)",
    "metric": "evaluation metric (counts/ratios over comparisons): "
              "piecewise-constant by construction",
    "comm": "communication/process plumbing: init handles, barriers, "
            "queue/stream sync; moves bytes, computes nothing",
    "plumbing": "graph/scope/IO plumbing (save/load, arrays, lod "
                "bookkeeping, var lifecycle): no numeric surface",
    "constant": "materialises a constant/shape-derived tensor from attrs; "
                "no tensor input to differentiate",
    "detection_post": "detection post-processing (NMS, anchor/proposal "
                      "generation, target assignment): argmax/threshold "
                      "selection logic, piecewise-constant outputs",
    "quant_int": "integer quantize/dequantize storage transform; the "
                 "trainable STE variants (fake_quantize_*) are separate "
                 "ops handled by the sweep's SKIPS with STE reasons",
    "sparse_tier": "host-side sparse-table storage op (pull/push/init/"
                   "save): gradient flows through the paired device-side "
                   "lookup op, not the storage plane",
    "grad_plumbing": "the generic grad op itself — it IS the derivative",
    "selection": "discrete search/decode (beam search, decoding): index "
                 "outputs drive the result",
}

# op -> category key
REASONS = {
    # -- optimizer updates ---------------------------------------------------
    **{op: "optimizer" for op in (
        "sgd", "momentum", "adam", "adamw", "adamax", "adagrad", "adadelta",
        "decayed_adagrad", "rmsprop", "ftrl", "lamb", "lars_momentum",
        "dgc_momentum", "dpsgd", "proximal_adagrad", "proximal_gd",
        "localsgd_select", "average_accumulates", "check_finite_and_unscale",
        "update_loss_scaling", "lookup_sparse_table_fuse_adam",
        "lookup_sparse_table_fuse_sgd",
        "fused_adam", "fused_lamb", "fused_momentum")},
    # -- integer / boolean / index outputs ----------------------------------
    **{op: "int_output" for op in (
        "equal", "equal_all", "not_equal", "less_than", "less_equal",
        "greater_than", "greater_equal", "allclose", "isfinite",
        "isfinite_v2", "isinf_v2", "isnan_v2", "logical_and", "logical_or",
        "logical_not", "logical_xor", "arg_max", "arg_min", "reduce_all",
        "reduce_any", "shape", "size", "rank", "one_hot", "one_hot_v2",
        "where_index", "unique", "unique_with_counts", "shard_index",
        "masked_select", "sequence_mask", "sequence_enumerate",
        "sequence_erase", "histogram", "similarity_focus", "hash",
        "filter_by_instag", "tdm_child", "edit_distance", "ctc_align",
        "chunk_eval", "crf_decoding", "gather_tree", "is_empty",
        "split_ids", "merge_ids")},
    # -- RNG samplers --------------------------------------------------------
    **{op: "rng" for op in (
        "uniform_random", "gaussian_random", "truncated_gaussian_random",
        "randint", "randperm", "bernoulli", "multinomial", "sampling_id",
        "random_crop", "seed", "gaussian_random_batch_size_like",
        "uniform_random_batch_size_like", "tdm_sampler")},
    # -- metrics -------------------------------------------------------------
    **{op: "metric" for op in (
        "accuracy", "auc", "precision_recall", "mean_iou", "detection_map",
        "positive_negative_pair")},
    # -- communication / process plumbing ------------------------------------
    **{op: "comm" for op in (
        "barrier", "c_allreduce_coalesced", "c_comm_init",
        "c_comm_init_all", "shard_constraint",
        "c_comm_init_multitrainer", "c_gen_nccl_id", "gen_nccl_id",
        "c_sync_calc_stream", "c_sync_comm_stream", "send_v2", "recv_v2",
        "partial_send", "enqueue", "dequeue", "queue_generator")},
    # -- graph / scope / IO plumbing -----------------------------------------
    **{op: "plumbing" for op in (
        "assert", "save", "load", "save_combine", "load_combine",
        "delete_var", "fake_init", "coalesce_tensor", "slice_multi_tensor",
        "write_to_array", "read_from_array", "array_to_lod_tensor",
        "lod_tensor_to_array", "tensor_array_to_tensor",
        "lod_array_length", "lod_rank_table", "max_sequence_len",
        "reorder_lod_tensor_by_rank", "split_selected_rows", "py_func",
        "recurrent", "store_q_value", "push_dense")},
    # -- constant materialisers ----------------------------------------------
    **{op: "constant" for op in (
        "fill_constant", "fill_constant_batch_size_like", "fill",
        "assign_value", "eye", "diag", "diag_v2", "linspace", "range",
        "empty")},
    # -- detection post-processing -------------------------------------------
    **{op: "detection_post" for op in (
        "multiclass_nms", "multiclass_nms2", "matrix_nms", "locality_aware_nms", "prior_box",
        "density_prior_box", "anchor_generator", "bipartite_match",
        "generate_proposals", "generate_proposals_v2",
        "generate_proposal_labels", "generate_mask_labels",
        "mine_hard_examples", "rpn_target_assign", "target_assign",
        "collect_fpn_proposals", "distribute_fpn_proposals",
        "retinanet_detection_output", "polygon_box_transform")},
    # -- integer quant storage ----------------------------------------------
    **{op: "quant_int" for op in (
        "quantize", "dequantize", "requantize", "dequantize_abs_max",
        "dequantize_log")},
    # -- host sparse-table tier ----------------------------------------------
    **{op: "sparse_tier" for op in (
        "distributed_lookup_table", "lookup_sparse_table_init",
        "lookup_sparse_table_read", "lookup_sparse_table_write",
        "lookup_sparse_table_grad_split", "lookup_sparse_table_merge",
        "push_box_sparse", "pull_box_extended_sparse", "pull_sparse_v2")},
    # -- discrete search / decode -------------------------------------------
    **{op: "selection" for op in ("beam_search", "beam_search_decode")},
    # -- autodiff internals --------------------------------------------------
    "generic_grad": "grad_plumbing",
}


def apply_reasons():
    """Stamp nondiff_reason onto every registered non-differentiable op.
    Unknown ops are left unstamped — the sweep's accounting test fails on
    them, forcing a conscious category choice for new ops."""
    for op, cat in REASONS.items():
        d = _OP_REGISTRY.get(op)
        if d is not None and not d.differentiable:
            d.nondiff_reason = f"{cat}: {CATEGORIES[cat]}"
