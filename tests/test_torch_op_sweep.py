"""Every op type both registries hold, through both lowerings: the
forward half of the op sweep (``test_torch_op_sweep_grad.py`` holds
``generic_grad``; the two files run on two workers).

The inputs are the reference's own, imported from
``tests/test_op_grads_auto.py``: its ``build_specs()``, else its generic
probe (``_probe``, which wants a float output), else the first of its
probe candidates (``_cands()``) that the reference's lowering runs at
all (comparisons, reductions to bool, index ops).  The recurrent,
beam-search and sequence-tier op types, which those lack, take the first
case of each in ``test_torch_rnn_ops.OP_CASES``,
``test_torch_rnn_decode.NLP_CASES``, ``test_torch_sequence_ops.OP_CASES``,
``test_torch_fused_tier.OP_CASES`` and
``test_torch_plumbing_tier.OP_CASES``; the detection op types those lack
are held on their own cases by ``test_torch_detection_ops.py``, and the
CTR op types the probe cannot feed by ``test_torch_ctr_tier.py``
(``SKIPS``).

- Forward: every output slot of the reference's, floats within rtol 1e-4
  (and 1e-4 of the slot's largest value), ids and bools equal.
- The dropout family (``dropout``, ``fused_dropout_add``,
  ``fused_act_dropout``, ``dropout_nd``) is held to ROADMAP ground rule
  5's contract
  instead: at rate 0 and under ``is_test`` the port gives the
  reference's output.
- Each op type the sweep does not run is in ``SKIPS`` with its reason,
  and the accounting test fails on an op type in neither list.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu  # noqa: F401  registers every lowering
import paddle_tpu.fluid  # noqa: F401  generic_grad
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid  # noqa: F401  registers every lowering
from paddle_tpu_torch.ops import registry as treg

from test_op_grads_auto import _cands, _probe, _specs
from test_torch_fused_tier import OP_CASES as FUSED_CASES
from test_torch_plumbing_tier import OP_CASES as PLUMBING_CASES
from test_torch_rnn_decode import NLP_CASES
from test_torch_rnn_ops import OP_CASES
from test_torch_sequence_ops import OP_CASES as SEQUENCE_CASES

jax.config.update("jax_platforms", "cpu")

FWD_RTOL = 1e-4

COMMON = sorted(set(treg.all_ops()) & set(jreg.all_ops()))

# held to ground rule 5's contract, not to the reference's draws
CONTRACT = ("dropout", "fused_dropout_add", "fused_act_dropout",
            "dropout_nd")

_OPTIMIZER = ("an optimizer's update over a parameter, its gradient, its "
              "accumulators and a learning rate, which the probe does not "
              "make: tests/test_torch_static_optim.py and "
              "test_torch_eager_optim.py hold the optimizers")
_RANDOM = ("draws random numbers: ground rule 5 holds it to a contract "
           "(tests/test_torch_tensor.py, test_torch_rnn_decode.py, "
           "test_torch_sequence_ops.py)")
_DETECTION = ("boxes, RoIs and matches the probe does not make: "
              "tests/test_torch_detection_ops.py holds it forward and "
              "through generic_grad against the reference")
_CTR = ("the CTR tier's ids, tags, trees, shards or histograms, which the "
        "probe does not make: tests/test_torch_ctr_tier.py holds it against "
        "the reference")
_CTR_RANDOM = ("draws random numbers: tests/test_torch_ctr_tier.py holds "
               "it to its contract (ground rule 5)")
_QUANT = ("a scale, a moving-average state, a log dictionary, a confusion "
          "matrix's classes or a class count's states, which the probe "
          "does not make: tests/test_torch_quant_tier.py holds it against "
          "the reference")
_PLUMBING = ("a tensor array, a rank table, a file, a queue or a "
             "registry of sparse tables, which the probe does not make: "
             "tests/test_torch_plumbing_tier.py holds it against the "
             "reference")
_ATTRS_ONLY = ("makes its output from attributes (shape, value, range) "
               "alone; the probe feeds tensors: "
               "tests/test_torch_tensor.py")
SKIPS = {
    **{op: _OPTIMIZER for op in (
        "adadelta", "adagrad", "adam", "adamax", "adamw",
        "average_accumulates", "decayed_adagrad", "dgc_momentum", "dpsgd",
        "ftrl", "fused_adam", "fused_lamb", "fused_momentum", "lamb",
        "lars_momentum", "momentum", "rmsprop", "sgd")},
    "check_finite_and_unscale": "AMP's loss-scale plumbing over a list of "
                                "gradients and a scale: "
                                "tests/test_torch_static_amp.py",
    "update_loss_scaling": "AMP's loss-scale state machine: "
                           "tests/test_torch_static_amp.py",
    **{op: _RANDOM for op in (
        "bernoulli", "gaussian_random", "multinomial", "nce", "randint",
        "randperm", "sample_logits", "sampling_id",
        "truncated_gaussian_random", "uniform_random")},
    **{op: _ATTRS_ONLY for op in (
        "assign_value", "eye", "fill_constant_batch_size_like", "linspace",
        "range")},
    "generic_grad": "the vjp of another op: test_torch_op_sweep_grad.py "
                    "runs it over every op type swept here",
    "__partial_grad__": "the tape's create_graph vjp: "
                        "tests/test_torch_grad.py",
    "run_program": "a whole sub-program as one op: tests/test_torch_jit.py",
    "recurrent": "StaticRNN's step block: tests/test_torch_control_flow.py",
    "read_from_array": "a tensor array and an index: "
                       "tests/test_torch_control_flow.py",
    "write_to_array": "see read_from_array",
    "reorder_lod_tensor_by_rank": "a rank table from lod_rank_table: "
                                  "tests/test_torch_control_flow.py",
    "print": "a side effect on the host's output, no value of its own",
    "assert": "raises on a false condition; no value of its own",
    "push_box_sparse": "writes gradients into a BoxPS cache: "
                       "tests/test_torch_boxps.py",
    "rnn_scan": "a WeightList of (layer, direction) weights: "
                "tests/test_torch_rnn.py",
    "accuracy": "top-k indices and int labels: "
                "tests/test_torch_static_ops.py",
    "allclose": "two tensors and its tolerances, both bool-valued: "
                "tests/test_torch_tensor.py",
    "masked_select": "a bool mask: tests/test_torch_tensor.py",
    "where_index": "a bool condition: tests/test_torch_tensor.py",
    "one_hot": "int ids: tests/test_torch_nn_functional.py",
    "one_hot_v2": "int ids: tests/test_torch_decode.py",
    "shard_index": "int ids: tests/test_torch_tensor.py",
    "multiclass_nms": "raises NotImplementedError in both packages (its "
                      "outputs' shapes depend on the data): "
                      "tests/test_torch_detection_ops.py",
    "multiclass_nms2": "see multiclass_nms",
    **{op: _CTR for op in (
        "auc", "filter_by_instag", "merge_ids", "pull_box_extended_sparse",
        "scaled_int8fc", "tdm_child")},
    **{op: _CTR_RANDOM for op in ("shuffle_batch", "tdm_sampler")},
    **{op: _PLUMBING for op in (
        "array_to_lod_tensor", "dequeue", "distributed_lookup_table",
        "enqueue", "load", "load_combine", "lod_tensor_to_array",
        "lookup_sparse_table_fuse_adam", "lookup_sparse_table_fuse_sgd",
        "lookup_sparse_table_init", "lookup_sparse_table_read",
        "lookup_sparse_table_write", "max_sequence_len", "queue_generator",
        "save", "save_combine", "shrink_rnn_memory",
        "tensor_array_to_tensor")},
    **{op: ("draws random numbers: tests/test_torch_plumbing_tier.py holds "
            "it to its contract (ground rule 5)")
       for op in ("gaussian_random_batch_size_like",
                  "uniform_random_batch_size_like")},
    **{op: _QUANT for op in (
        "dequantize_abs_max", "dequantize_log",
        "fake_channel_wise_dequantize_max_abs", "fake_dequantize_max_abs",
        "fake_quantize_dequantize_moving_average_abs_max",
        "fake_quantize_moving_average_abs_max", "fake_quantize_range_abs_max",
        "mean_iou", "precision_recall")},
    "random_crop": "draws its offsets: tests/test_torch_quant_tier.py holds "
                   "it to its contract (ground rule 5)",
    "py_func": "a host callable registered in each package under its own "
               "id: tests/test_torch_fused_tier.py",
    **{op: _DETECTION for op in (
        "bipartite_match", "box_decoder_and_assign", "collect_fpn_proposals",
        "deformable_psroi_pooling", "density_prior_box", "detection_map",
        "distribute_fpn_proposals", "generate_mask_labels",
        "generate_proposal_labels", "generate_proposals",
        "generate_proposals_v2", "locality_aware_nms", "matrix_nms",
        "mine_hard_examples", "polygon_box_transform", "prior_box",
        "retinanet_detection_output", "roi_perspective_transform",
        "rpn_target_assign", "target_assign", "yolo_box", "yolov3_loss")},
}

SWEPT = [op for op in COMMON if op not in SKIPS and op not in CONTRACT]

_NEW_OPS = {}
for _op, _ins, _attrs in (list(OP_CASES.values()) + list(NLP_CASES.values())
                          + list(SEQUENCE_CASES.values())
                          + list(FUSED_CASES.values())
                          + list(PLUMBING_CASES.values())):
    _NEW_OPS.setdefault(_op, dict(inputs=_ins, attrs=_attrs))


def _probe_any(op):
    """The first of the probe's candidates that the reference's lowering
    runs and answers with any output."""
    fn = jreg.get_op(op).fn
    for c in _cands():
        try:
            outs = fn({k: [jnp.asarray(v)] for k, v in c.items()}, {},
                      _jctx())
        except Exception:       # noqa: BLE001  probing by contract
            continue
        if any(len(v) for v in outs.values()):
            return dict(inputs=c)
    return None


def spec_for(op):
    """(inputs, attrs, grad slots or None) for ``op``, or None."""
    spec = _specs().get(op) or _probe(op) or _NEW_OPS.get(op) \
        or _probe_any(op)
    if spec is None:
        return None
    return spec["inputs"], dict(spec.get("attrs", {})), \
        spec.get("grad_slots")


def _jctx(is_test=False):
    return jreg.LoweringContext(base_key=jax.random.PRNGKey(0),
                                is_test=is_test)


def _tctx(is_test=False):
    return treg.LoweringContext(base_seed=0, is_test=is_test)


def _listed(v):
    return v if isinstance(v, list) else [v]


def run_both(op, ins, attrs, is_test=False):
    """The op's outputs in each package from the same numpy inputs."""
    ref = jreg.get_op(op).fn(
        {k: [jnp.asarray(np.asarray(a)) for a in _listed(v)]
         for k, v in ins.items()}, dict(attrs), _jctx(is_test))
    port = treg.get_op(op).fn(
        {k: [torch.from_numpy(np.array(a)) for a in _listed(v)]
         for k, v in ins.items()}, dict(attrs), _tctx(is_test))
    return ref, port


def _leaves(v):
    """The arrays in an output: a tensor, or a dict of them (a rank
    table), in key order."""
    if isinstance(v, dict):
        return [a for k in sorted(v) for a in _leaves(v[k])]
    if isinstance(v, torch.Tensor):
        return [v.detach().numpy()]
    return [np.asarray(v)]


def assert_close(got, want, rtol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "fc":
        np.testing.assert_allclose(
            got, want, rtol=rtol,
            atol=rtol * (np.abs(want).max() if want.size else 0) + 1e-7,
            err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def assert_outputs_match(ref, port, rtol, what):
    for slot, vals in ref.items():
        assert slot in port, (what, slot)
        for i, (w, g) in enumerate(zip(vals, port[slot])):
            if w is None:
                continue
            ws, gs = _leaves(w), _leaves(g)
            assert len(ws) == len(gs), (what, slot)
            for j, (a, b) in enumerate(zip(ws, gs)):
                assert_close(b, a, rtol, f"{what}: {slot}[{i}] {j}")


@pytest.mark.parametrize("op", SWEPT)
def test_forward_matches_reference(op):
    spec = spec_for(op)
    assert spec is not None, (
        f"op type '{op}' has no spec, fails both probes and has no SKIPS "
        f"entry")
    ins, attrs, _ = spec
    ref, port = run_both(op, ins, attrs)
    assert_outputs_match(ref, port, FWD_RTOL, op)


@pytest.mark.parametrize("op", CONTRACT)
@pytest.mark.parametrize("mode", ["rate 0", "is_test"])
def test_dropout_family_contract(op, mode):
    ins, attrs, _ = spec_for(op)
    attrs = dict(attrs, dropout_prob=0.0 if mode == "rate 0" else 0.4,
                 is_test=mode == "is_test")
    ref, port = run_both(op, ins, attrs, is_test=mode == "is_test")
    assert_close(port["Out"][0].numpy(), np.asarray(ref["Out"][0]),
                 FWD_RTOL, f"{op} at {mode}")


def test_every_op_type_is_accounted_for():
    assert len(COMMON) == len(treg.all_ops()), \
        sorted(set(treg.all_ops()) - set(COMMON))
    assert not set(SKIPS) - set(COMMON), "stale SKIPS entries"
    assert all(isinstance(r, str) and len(r) >= 8 for r in SKIPS.values())
    assert len(SWEPT) + len(SKIPS) + len(CONTRACT) == len(COMMON)
    assert len(SWEPT) > len(SKIPS)
