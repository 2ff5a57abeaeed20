"""The dygraph slice: paddle_tpu_torch against paddle_tpu, eager BERT.

Both packages build the same dygraph models at a small size (vocab 97,
hidden 64, 2 layers, 2 heads, FFN 128, seq 16, batch 2).  The JAX model
is built first; its ``state_dict()`` is carried into the port's model by
``interop.layer_from_numpy``, and both run on the CPU (the reference's
attention op takes its plain reference there, the port's every op its
plain version).

Tolerances, float32: op outputs rtol=atol=1e-5 (the libraries sum in
different orders); layer outputs, logits and losses rtol 1e-4, atol 1e-5;
gradients within 1e-4 of their tensor's largest magnitude plus 1e-6 of
the largest over all (see ``_close_each``), which float32 rounding
through two encoder layers stays far inside.  With bf16 autocast each
matmul input and every gray op's output is rounded to bf16's 8
significant bits (relative 2^-9) at places that differ between the
libraries, so logits and the loss are held to atol 5e-2 (logits within
+-3) and rtol 2^-6, gradients to 5e-2 of their largest magnitude plus
2^-8 of the largest over all: a few bf16 roundings, far below what a
wrong op changes.  Dropout runs at rate 0 here: masks are never compared
across packages (tests/test_torch_dropout.py holds the dropout
contract).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.dygraph import base as jdy
from paddle_tpu.dygraph.functional import functional_loss as j_functional, \
    functionalize as j_functionalize
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.models.bert import BertForPretraining as JBert
from paddle_tpu.nn import layer as jlayer
from paddle_tpu.dygraph import nn as jnn
from paddle_tpu.ops import registry as jreg
from paddle_tpu.optimizer.fused import make_fused_adam as j_adam

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch import interop
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.dygraph.functional import functional_loss as t_functional
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.models.bert import BertForPretraining as TBert
from paddle_tpu_torch.nn import layer as tlayer
from paddle_tpu_torch.dygraph import nn as tnn
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.optimizer.fused import make_fused_adam as t_adam

CFG = dict(vocab_size=97, hidden_size=64, num_layers=2, num_heads=2,
           intermediate_size=128, max_position=16, dropout=0.0,
           attn_dropout=0.0)
BATCH, SEQ = 2, 16
LR = 1e-3
R = np.random.RandomState(11)


def _f(*shape):
    return R.randn(*shape).astype("float32")


# ---------------------------------------------------------------------------
# ops of modules 4 to 6 against paddle_tpu's lowerings
# ---------------------------------------------------------------------------
OP_CASES = {
    "layer_norm": ("layer_norm", {"X": [_f(2, 5, 8)], "Scale": [_f(8)],
                                  "Bias": [_f(8)]},
                   {"epsilon": 1e-5, "begin_norm_axis": 2}),
    "layer_norm_axis1_no_affine": ("layer_norm", {"X": [_f(3, 4, 6)]},
                                   {"epsilon": 1e-12,
                                    "begin_norm_axis": 1}),
    "gelu": ("gelu", {"X": [_f(4, 9)]}, {}),
    "tanh": ("tanh", {"X": [_f(4, 9)]}, {}),
    "cast_int64": ("cast", {"X": [_f(3, 4) * 10]}, {"out_dtype": "int32"}),
    "cast_bf16": ("cast", {"X": [_f(3, 4)]}, {"out_dtype": "bfloat16"}),
    "slice_first_token": ("slice", {"Input": [_f(2, 5, 8)]},
                          {"axes": [1], "starts": [0], "ends": [1]}),
    "slice_negative_decrease": ("slice", {"Input": [_f(4, 6)]},
                                {"axes": [0, 1], "starts": [-3, 1],
                                 "ends": [100, -1],
                                 "decrease_axis": []}),
    "squeeze2": ("squeeze2", {"X": [_f(2, 1, 8)]}, {"axes": [1]}),
    "squeeze2_all": ("squeeze2", {"X": [_f(1, 3, 1)]}, {"axes": []}),
    "dropout_rate0": ("dropout", {"X": [_f(3, 8)]},
                      {"dropout_prob": 0.0, "op_seed": 3}),
    "fused_dropout_add_rate0": ("fused_dropout_add",
                                {"X": [_f(3, 8)], "Residual": [_f(3, 8)]},
                                {"dropout_prob": 0.0, "op_seed": 3}),
    "fused_act_dropout_gelu_rate0": ("fused_act_dropout", {"X": [_f(3, 8)]},
                                     {"dropout_prob": 0.0, "act": "gelu"}),
    "fused_act_dropout_relu_test": ("fused_act_dropout", {"X": [_f(3, 8)]},
                                    {"dropout_prob": 0.3, "act": "relu",
                                     "is_test": True}),
}


def _np(x):
    a = np.asarray(x.float() if isinstance(x, torch.Tensor)
                   and x.dtype == torch.bfloat16 else x)
    return a.astype(np.float64)


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_reference(case):
    op_type, ins, attrs = OP_CASES[case]
    j_out = jreg.get_op(op_type).fn(
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs), jreg.LoweringContext())
    t_out = treg.get_op(op_type).fn(
        {s: [torch.from_numpy(a.copy()) for a in v]
         for s, v in ins.items()}, dict(attrs), treg.LoweringContext())
    assert set(j_out) == set(t_out)
    for slot in j_out:
        for j, t in zip(j_out[slot], t_out[slot]):
            assert tuple(j.shape) == tuple(t.shape), (slot, j.shape, t.shape)
            if j.dtype == jnp.bfloat16:
                assert t.dtype == torch.bfloat16
            np.testing.assert_allclose(_np(t), _np(j.astype(jnp.float32)
                                                   if j.dtype == jnp.bfloat16
                                                   else j),
                                       rtol=1e-5, atol=1e-5, err_msg=slot)


# ---------------------------------------------------------------------------
# layers, with the JAX weights carried across
# ---------------------------------------------------------------------------
LAYER_CASES = {
    "linear": (lambda m: m.Linear(64, 32), lambda m: m, (2, 5, 64)),
    "layer_norm": (lambda m: m.LayerNorm(64), lambda m: m, (2, 5, 64)),
    "encoder_layer_eval": (
        lambda m: m.TransformerEncoderLayer(64, 2, 128, dropout=0.1,
                                            activation="gelu"),
        lambda m: m.eval(), (2, SEQ, 64)),
    "encoder_layer_train_rate0": (
        lambda m: m.TransformerEncoderLayer(64, 2, 128, dropout=0.0,
                                            activation="relu"),
        lambda m: m.train(), (2, SEQ, 64)),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_reference(case):
    build, mode, shape = LAYER_CASES[case]
    x = _f(*shape)
    np.random.seed(0)
    with jdy.guard():
        mod = jlayer if "encoder" in case else jnn
        jm = mode(build(mod))
        want = np.asarray(jm(jdy.to_variable(jnp.asarray(x))).value())
        state = jm.state_dict()
    with tdy.guard(tfluid.CPUPlace()):
        mod = tlayer if "encoder" in case else tnn
        tm = mode(build(mod))
        assert list(state) == list(tm.state_dict())
        interop.layer_from_numpy(tm, state)
        got = tm(tdy.to_variable(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_embedding_matches_reference():
    ids = R.randint(0, 97, (2, 7)).astype("int64")
    with jdy.guard():
        jm = jnn.Embedding([97, 16], padding_idx=-1)
        want = np.asarray(jm(jdy.to_variable(jnp.asarray(ids))).value())
        state = jm.state_dict()
    with tdy.guard(tfluid.CPUPlace()):
        tm = tnn.Embedding([97, 16], padding_idx=-1)
        interop.layer_from_numpy(tm, state)
        got = tm(tdy.to_variable(ids)).numpy()
    assert not np.any(got[ids == 96])
    np.testing.assert_array_equal(got, want)


def test_layer_from_numpy_refuses_mismatches():
    with tdy.guard(tfluid.CPUPlace()):
        tm = tnn.Linear(4, 3)
    state = tm.state_dict()
    with pytest.raises(KeyError, match="missing"):
        interop.layer_from_numpy(tm, {"weight": state["weight"]})
    with pytest.raises(KeyError, match="unexpected"):
        interop.layer_from_numpy(tm, dict(state, extra=state["bias"]))
    with pytest.raises(ValueError, match="shape"):
        interop.layer_from_numpy(tm, dict(state, bias=np.zeros(4,
                                                               "float32")))


# ---------------------------------------------------------------------------
# the whole BertForPretraining: logits, loss, functional grads, 2 Adam steps
# ---------------------------------------------------------------------------
def _inputs():
    rng = np.random.RandomState(5)
    return (rng.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int64"),
            rng.randint(0, CFG["vocab_size"], (BATCH, SEQ)).astype("int64"),
            rng.randint(0, 2, (BATCH,)).astype("int64"))


def _reference_run(amp):
    """paddle_tpu, as bench.py runs it (each program jitted): the
    state_dict, logits, both steps' losses and gradients, and the
    parameters after two fused-Adam steps."""
    jframework.reset_unique_name()
    np.random.seed(1)
    ids, mlm, nsp = (jnp.asarray(a) for a in _inputs())
    with jdy.guard():
        jdy._dygraph_tracer()._amp_enabled = amp
        model = JBert(**CFG)
        model.train()
        state = model.state_dict()
        pv, fwd = j_functionalize(model)
        logits = [np.asarray(v.astype(jnp.float32))
                  for v in jax.jit(fwd)(pv, ids)]

        def loss_fn(i, m, n):
            return model.loss(*model(i), m, n)

        _, lfn = j_functional(model, loss_fn)
        jgrad = jax.jit(jax.value_and_grad(lfn))
        loss, grads = jgrad(pv, ids, mlm, nsp)
        opt, _, update = j_adam(pv, lr=LR)
        opt, params = update(opt, grads)
        loss2, grads2 = jgrad(params, ids, mlm, nsp)
        opt, params = update(opt, grads2)
    return {"state": state, "logits": logits,
            "losses": [float(loss), float(loss2)],
            "grads": [[np.asarray(g) for g in gs] for gs in (grads, grads2)],
            "params": [np.asarray(p.astype(jnp.float32)) for p in params]}


def _port_run(ref, amp):
    """The port from the reference's weights: logits, two steps' losses
    and first gradients on its own trajectory, and the parameters its
    fused Adam makes of the reference's two gradients."""
    tframework.reset_unique_name()
    ids, mlm, nsp = (torch.from_numpy(a) for a in _inputs())
    with tdy.guard(tfluid.CPUPlace()):
        tframework._dygraph_tracer()._amp_enabled = amp
        model = TBert(**CFG)
        model.train()
        assert list(model.state_dict()) == list(ref["state"])
        interop.layer_from_numpy(model, ref["state"])
        mlm_logits, nsp_logits = model(tdy.to_variable(ids))
        logits = [v.numpy() for v in (mlm_logits, nsp_logits)]

        def loss_fn(i, m, n):
            return model.loss(*model(i), m, n)

        pv, lfn = t_functional(model, loss_fn)
        grads, loss = torch.func.grad_and_value(lfn)(pv, ids, mlm, nsp)
        opt, _, update = t_adam(pv, lr=LR)
        _, params = update(opt, grads)
        _, loss2 = torch.func.grad_and_value(lfn)(params, ids, mlm, nsp)
        for gs in ref["grads"]:
            opt, params = update(opt, [torch.from_numpy(g.copy())
                                       for g in gs])
    return {"logits": logits, "losses": [float(loss), float(loss2)],
            "grads": [g.numpy() for g in grads],
            "params": [p.float().numpy() for p in params]}


@pytest.fixture(scope="module")
def runs():
    out = {}
    for amp in (False, True):
        ref = _reference_run(amp)
        out[amp] = (ref, _port_run(ref, amp))
    return out


def _close_each(got, want, rel, floor):
    """Each tensor within ``rel`` of its own largest magnitude, plus
    ``floor`` of the largest over all tensors: the key projection's bias
    has a zero gradient in exact arithmetic (softmax ignores a shift
    shared by a row's scores), and both packages give it rounding noise
    that no scale of its own can hold."""
    floor *= max(float(np.abs(w).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=0.0,
                                   atol=rel * float(np.abs(w).max()) + floor,
                                   err_msg=f"tensor {i}")


# (rtol, atol) of logits and losses; (rel, floor) of gradients: float32,
# then bf16 (2^-8: one bf16 rounding of the largest gradient)
TOL = {False: ((1e-4, 1e-5), (1e-4, 1e-6)),
       True: ((2 ** -6, 5e-2), (5e-2, 2 ** -8))}


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
def test_bert_logits_and_loss_match_reference(runs, amp):
    ref, port = runs[amp]
    rtol, atol = TOL[amp][0]
    for g, w in zip(port["logits"], ref["logits"]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    np.testing.assert_allclose(port["losses"][0], ref["losses"][0],
                               rtol=rtol)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
def test_bert_functional_grads_match_reference(runs, amp):
    ref, port = runs[amp]
    _close_each(port["grads"], ref["grads"][0], *TOL[amp][1])


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "bf16"])
def test_bert_two_fused_adam_steps_match_reference(runs, amp):
    """The second step's loss, each package on its own trajectory; and
    the port's fused Adam fed the reference's two gradients against the
    reference's parameters, within 1e-6 of each tensor's largest
    magnitude (float32 rounding of the same elementwise formula; fed its
    own gradients, Adam's first step is lr·sign(g), which flips on the
    noise of a zero gradient)."""
    ref, port = runs[amp]
    rtol = TOL[amp][0][0]
    np.testing.assert_allclose(port["losses"][1], ref["losses"][1],
                               rtol=rtol)
    _close_each(port["params"], ref["params"], 1e-6, 0.0)


# ---------------------------------------------------------------------------
# entry point and the flash-attention backward under torch.func.grad
# ---------------------------------------------------------------------------
def test_enable_dygraph_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        tdy.enable_dygraph()
    with pytest.raises(RuntimeError, match=r"CPUPlace\(\)"):
        with tdy.guard():
            pass
    assert tframework._dygraph_tracer() is None
    with tdy.guard(tfluid.CPUPlace()):
        assert tframework._dygraph_tracer().device.type == "cpu"


def test_flash_backward_launch_runs_under_func_grad(monkeypatch):
    """The card's attention Function under ``torch.func.grad`` (the
    dygraph step's transform): its backward launch must not re-enter
    autograd with the saved tensors, which still require grad at the
    transform's level.  The kernels are stood in for by their plain
    versions (the test runs without a card); the gradient must be the
    plain attention's."""
    from paddle_tpu_torch.ops import attention, cuda_kernels

    def fwd(q, k, v, mask, scale, causal, return_stats=False):
        o = attention._reference_attention(q, k, v, mask, scale, causal)
        return (o, *attention._reference_stats(q, k, mask, scale, causal))

    monkeypatch.setattr(cuda_kernels, "flash_attention_fwd", fwd)
    monkeypatch.setattr(cuda_kernels, "flash_attention_bwd",
                        lambda q, k, v, mask, *a:
                        attention._reference_attention_bwd(
                            q, k, v, mask, a[0], *a[2:], causal=a[1]))
    q, k, v = (torch.from_numpy(_f(1, 2, 6, 8)) for _ in range(3))

    def kernel_loss(q, k, v):
        return (attention._FlashAttention.apply(q, k, v, None, 0.3,
                                                False)[0] ** 2).sum()

    def plain_loss(q, k, v):
        return (attention._reference_attention(q, k, v, None, 0.3,
                                               False) ** 2).sum()

    got = torch.func.grad(kernel_loss, argnums=(0, 1, 2))(q, k, v)
    want = torch.func.grad(plain_loss, argnums=(0, 1, 2))(q, k, v)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
