"""paddle.nn.functional, and nn's activation and loss classes, in both
packages: every ported function against ``paddle_tpu.nn.functional`` on
the same seeded numpy inputs, forward under a dygraph tracer and in a
static program, and the input gradient on the tape, float32 at rtol
1e-5.  The dropout family is held to its contract (the two packages
draw different masks).  Each function whose op is not ported yet raises
``NotImplementedError`` naming its ROADMAP queue A item.  Mirrors
``tests/test_nn_functional.py``.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.dygraph import base as jdy
from paddle_tpu.fluid import layers as JL

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.dygraph import base as tdy
from paddle_tpu_torch.fluid import layers as TL
from paddle_tpu_torch.ops import has_op


def _rnd(*s, seed=0):
    return np.random.RandomState(seed).randn(*s).astype("float32")


_logp = np.log(np.random.RandomState(11).dirichlet(
    np.ones(5), 6).astype("float32"))
A = {
    "x": _rnd(4, 6, seed=1),
    "y": _rnd(4, 6, seed=2),
    "img": _rnd(2, 4, 6, 6, seed=3),
    "seq": _rnd(2, 3, 8, seed=4),
    "vol": _rnd(1, 2, 4, 4, 4, seed=5),
    "w_lin": _rnd(6, 3, seed=6),
    "b3": _rnd(3, seed=7),
    "w_conv": _rnd(5, 4, 3, 3, seed=8),
    "w_conv1d": _rnd(4, 3, 3, seed=9),
    "b5": _rnd(5, seed=10),
    "b4": _rnd(4, seed=11),
    "logp": _logp,
    "lbl": np.random.RandomState(12).randint(0, 5, (6,)).astype("int64"),
    "lbl_col": np.random.RandomState(13).randint(0, 6, (4, 1))
    .astype("int64"),
    "cls_w": np.abs(_rnd(5, seed=14)) + 0.5,
    "prob": np.random.RandomState(15).uniform(0.05, 0.95, (4, 6))
    .astype("float32"),
    "bin": (np.random.RandomState(16).rand(4, 6) > 0.5).astype("float32"),
    "soft": np.random.RandomState(17).dirichlet(np.ones(6), 4)
    .astype("float32"),
    "sign": np.sign(_rnd(4, 1, seed=18)) + 0.0,
    "a1": _rnd(4, 1, seed=19),
    "a2": _rnd(4, 1, seed=20),
    "alpha1": np.array([0.2], "float32"),
    "alpha4": np.array([0.1, 0.2, 0.3, 0.4], "float32"),
    "emb_w": _rnd(7, 4, seed=21),
    "ids": np.array([[0, 2, 6], [3, 2, 1]], "int64"),
    "ln_w": (np.abs(_rnd(6, seed=22)) + 0.5),
    "ln_b": _rnd(6, seed=23),
    "bn_m": _rnd(4, seed=24),
    "bn_v": np.abs(_rnd(4, seed=25)) + 0.5,
    "pair_lbl": np.array([0, 1, 0, 2], "int64"),
    "dice_in": np.random.RandomState(26).dirichlet(np.ones(3), 4)
    .astype("float32"),
    "dice_lbl": np.array([[0], [2], [1], [2]], "int64"),
}

# name -> (fn(F, L, *vars), input keys, static too?, input gradient?)
CASES = {
    # activations
    "relu": (lambda F, L, x: F.relu(x), ["x"], True, True),
    "relu6": (lambda F, L, x: F.relu6(x * 4.0), ["x"], True, True),
    "gelu": (lambda F, L, x: F.gelu(x), ["x"], True, True),
    "sigmoid": (lambda F, L, x: F.sigmoid(x), ["x"], True, True),
    "tanh": (lambda F, L, x: F.tanh(x), ["x"], True, True),
    "silu": (lambda F, L, x: F.silu(x), ["x"], True, True),
    "leaky_relu": (lambda F, L, x: F.leaky_relu(x, alpha=0.1), ["x"], True,
                   True),
    "elu": (lambda F, L, x: F.elu(x), ["x"], True, True),
    "selu": (lambda F, L, x: F.selu(x), ["x"], True, True),
    "softplus": (lambda F, L, x: F.softplus(x), ["x"], True, True),
    "softsign": (lambda F, L, x: F.softsign(x), ["x"], True, True),
    "softshrink": (lambda F, L, x: F.softshrink(x), ["x"], True, True),
    "hardshrink": (lambda F, L, x: F.hardshrink(x), ["x"], True, True),
    "tanhshrink": (lambda F, L, x: F.tanhshrink(x), ["x"], True, True),
    "thresholded_relu": (lambda F, L, x: F.thresholded_relu(x), ["x"],
                         True, True),
    "hardswish": (lambda F, L, x: F.hardswish(x * 3.0), ["x"], True, True),
    "hardsigmoid": (lambda F, L, x: F.hardsigmoid(x * 2.0), ["x"], True,
                    True),
    "mish": (lambda F, L, x: F.mish(x), ["x"], True, True),
    "swish": (lambda F, L, x: F.swish(x), ["x"], True, True),
    "log_sigmoid": (lambda F, L, x: F.log_sigmoid(x), ["x"], True, True),
    "softmax": (lambda F, L, x: F.softmax(x), ["x"], True, True),
    "log_softmax": (lambda F, L, x: F.log_softmax(x), ["x"], True, True),
    "hardtanh": (lambda F, L, x: F.hardtanh(x * 2.0), ["x"], True, True),
    "prelu": (lambda F, L, x, a: F.prelu(x, a), ["x", "alpha1"], True,
              True),
    "prelu_channel": (lambda F, L, x, a: F.prelu(x, a), ["img", "alpha4"],
                      True, True),
    "glu": (lambda F, L, x: F.glu(x), ["x"], True, True),
    # normalization and embedding
    "one_hot": (lambda F, L, i: F.one_hot(i, 6), ["lbl_col"], True, False),
    "pad": (lambda F, L, x: F.pad(x, [1, 0, 0, 2], 0.5), ["x"], True, True),
    "label_smooth": (lambda F, L, x: F.label_smooth(x, epsilon=0.2),
                     ["soft"], True, True),
    "normalize": (lambda F, L, x: F.normalize(x, axis=1), ["x"], True,
                  True),
    "embedding": (lambda F, L, i, w: F.embedding(i, w, padding_idx=2),
                  ["ids", "emb_w"], True, False),
    "layer_norm": (lambda F, L, x, w, b: F.layer_norm(x, 6, w, b),
                   ["x", "ln_w", "ln_b"], True, True),
    "batch_norm": (lambda F, L, x, m, v, w, b: F.batch_norm(
        x, m, v, w, b), ["img", "bn_m", "bn_v", "alpha4", "b4"], False,
        True),
    "local_response_norm": (lambda F, L, x: F.local_response_norm(x, 3),
                            ["img"], True, True),
    "maxout": (lambda F, L, x: F.maxout(x, 2), ["img"], True, True),
    "assign": (lambda F, L, x: F.assign(x), ["x"], True, True),
    # losses
    "cross_entropy": (lambda F, L, x, l: F.cross_entropy(x, l),
                      ["x", "lbl_col"], True, True),
    "cross_entropy_soft": (lambda F, L, x, s: F.cross_entropy(
        x, s, soft_label=True), ["x", "soft"], True, True),
    "softmax_with_cross_entropy": (lambda F, L, x, l: F.
                                   softmax_with_cross_entropy(x, l),
                                   ["x", "lbl_col"], True, True),
    "square_error_cost": (lambda F, L, x, y: F.square_error_cost(x, y),
                          ["x", "y"], True, True),
    "mse_loss": (lambda F, L, x, y: F.mse_loss(x, y), ["x", "y"], True,
                 True),
    "sigmoid_cross_entropy_with_logits": (
        lambda F, L, x, y: F.sigmoid_cross_entropy_with_logits(x, y),
        ["x", "bin"], True, True),
    "binary_cross_entropy": (lambda F, L, p, y: F.binary_cross_entropy(
        p, y), ["prob", "bin"], True, True),
    "binary_cross_entropy_with_logits": (
        lambda F, L, x, y: F.binary_cross_entropy_with_logits(x, y),
        ["x", "bin"], True, True),
    "kl_div": (lambda F, L, x, s: F.kl_div(x, s), ["x", "soft"], True,
               True),
    "kl_div_batchmean": (lambda F, L, x, s: F.kl_div(x, s, "batchmean"),
                         ["x", "soft"], True, True),
    "cosine_similarity": (lambda F, L, a, b: F.cosine_similarity(a, b),
                          ["x", "y"], True, True),
    "l1_loss": (lambda F, L, a, b: F.l1_loss(a, b), ["x", "y"], True, True),
    "l1_loss_sum": (lambda F, L, a, b: F.l1_loss(a, b, "sum"), ["x", "y"],
                    True, True),
    "smooth_l1_loss": (lambda F, L, a, b: F.smooth_l1_loss(a, b),
                       ["x", "y"], True, True),
    "nll_loss": (lambda F, L, p, l: F.nll_loss(p, l), ["logp", "lbl"],
                 True, True),
    "nll_loss_weighted": (lambda F, L, p, l, w: F.nll_loss(
        p, l, weight=w, ignore_index=1), ["logp", "lbl", "cls_w"], True,
        True),
    "nll_loss_none": (lambda F, L, p, l: F.nll_loss(p, l, reduction="none"),
                      ["logp", "lbl"], True, True),
    "margin_ranking_loss": (lambda F, L, a, b, s: F.margin_ranking_loss(
        a, b, s, margin=0.1), ["a1", "a2", "sign"], True, True),
    "pairwise_distance": (lambda F, L, a, b: F.pairwise_distance(a, b),
                          ["x", "y"], True, True),
    "pairwise_distance_p3": (lambda F, L, a, b: F.pairwise_distance(
        a, b, p=3.0), ["x", "y"], True, True),
    "log_loss": (lambda F, L, p, y: F.log_loss(p, y), ["prob", "bin"],
                 True, True),
    "dice_loss": (lambda F, L, x, l: F.dice_loss(x, l),
                  ["dice_in", "dice_lbl"], True, True),
    "sigmoid_focal_loss": (lambda F, L, x, y: F.sigmoid_focal_loss(x, y),
                           ["x", "bin"], True, True),
    "npair_loss": (lambda F, L, a, p, l: F.npair_loss(a, p, l),
                   ["x", "y", "pair_lbl"], True, True),
    # products, convolutions and pools
    "linear": (lambda F, L, x, w, b: F.linear(x, w, b),
               ["x", "w_lin", "b3"], True, True),
    "conv2d": (lambda F, L, x, w, b: F.conv2d(x, w, b, padding=1),
               ["img", "w_conv", "b5"], True, True),
    "conv1d": (lambda F, L, x, w: F.conv1d(x, w, padding=1),
               ["seq", "w_conv1d"], True, True),
    "max_pool2d": (lambda F, L, x: F.max_pool2d(x, 2), ["img"], True, True),
    "avg_pool2d": (lambda F, L, x: F.avg_pool2d(x, 2), ["img"], True, True),
    "adaptive_avg_pool2d": (lambda F, L, x: F.adaptive_avg_pool2d(x, 3),
                            ["img"], True, True),
    "adaptive_max_pool2d": (lambda F, L, x: F.adaptive_max_pool2d(x, 3),
                            ["img"], True, True),
    "max_pool1d": (lambda F, L, x: F.max_pool1d(x, 2), ["seq"], True, True),
    "avg_pool1d": (lambda F, L, x: F.avg_pool1d(x, 2), ["seq"], True, True),
    "adaptive_avg_pool1d": (lambda F, L, x: F.adaptive_avg_pool1d(x, 4),
                            ["seq"], True, True),
    "adaptive_max_pool1d": (lambda F, L, x: F.adaptive_max_pool1d(x, 4),
                            ["seq"], True, True),
    "adaptive_avg_pool3d": (lambda F, L, x: F.adaptive_avg_pool3d(x, 2),
                            ["vol"], True, True),
    "adaptive_max_pool3d": (lambda F, L, x: F.adaptive_max_pool3d(x, 2),
                            ["vol"], True, True),
    "embedding_fluid": (lambda F, L, i: L.reduce_sum(F.embedding_fluid(
        i, [7, 4], param_attr=_ParamAttr(L, A["emb_w"]))), ["ids"], False,
        False),
}


def _ParamAttr(L, value):
    """A parameter carried across as a value."""
    fluid = jfluid if L is JL else tfluid
    from importlib import import_module
    init = import_module(fluid.__name__ + ".initializer")
    return fluid.ParamAttr(initializer=init.NumpyArrayInitializer(value))


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [o for x in out for o in _flat(x)]
    return [out]


def _eager(F, L, dy, enter, name):
    fn, keys, _, grad = CASES[name]
    enter()
    try:
        ins = [dy.to_variable(A[k]) for k in keys]
        if grad:
            ins[0].stop_gradient = False
        outs = _flat(fn(F, L, *ins))
        vals = [np.asarray(o.numpy()) for o in outs]
        if grad:
            L.reduce_sum(outs[0]).backward()
            vals.append(np.asarray(ins[0].grad))
        return vals
    finally:
        dy.disable_dygraph()


def _static(F, L, fluid, executor, name):
    fn, keys, _, _ = CASES[name]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ins, feed = [], {}
        for i, k in enumerate(keys):
            n = f"in{i}"
            feed[n] = A[k]
            ins.append(fluid.data(n, list(A[k].shape),
                                  dtype=str(A[k].dtype)))
        outs = _flat(fn(F, L, *ins))
        exe = executor()
        exe.run(startup)
        return [np.asarray(v) for v in
                exe.run(main, feed=feed, fetch_list=outs)]


def _same(got, want, label):
    assert len(got) == len(want), label
    for g, w in zip(got, want):
        assert g.shape == w.shape, (label, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=label)
        else:
            np.testing.assert_array_equal(g, w, err_msg=label)


@pytest.mark.parametrize("name", sorted(CASES))
def test_functional_matches_reference(name):
    want = _eager(JF, JL, jdy, jdy.enable_dygraph, name)
    got = _eager(TF, TL, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()),
                 name)
    _same(got, want, f"{name} (dygraph, and the first input's gradient)")
    if CASES[name][2]:
        jdy.disable_dygraph()
        tdy.disable_dygraph()
        want = _static(JF, JL, jfluid, jfluid.Executor, name)
        got = _static(TF, TL, tfluid,
                      lambda: tfluid.Executor(tfluid.CPUPlace()), name)
        _same(got, want, f"{name} (static)")


# --- the dropout family: a contract -----------------------------------------
def _dropouts(F, dy, enter):
    enter()
    try:
        np.random.seed(7)
        x = dy.to_variable(_rnd(64, 128, seed=19) + 1.0)
        ones4 = dy.to_variable(np.ones((8, 16, 4, 4), "float32"))
        ones5 = dy.to_variable(np.ones((4, 8, 2, 2, 2), "float32"))
        sel = dy.to_variable(_rnd(256, 256, seed=27))
        return {
            "eval": (F.dropout(x, 0.5, training=False).numpy(), x.numpy()),
            "train": F.dropout(x, 0.5, training=True).numpy(),
            "downgrade": F.dropout(x, 0.5, training=False,
                                   mode="downscale_in_infer").numpy(),
            "2d": F.dropout2d(ones4, 0.5).numpy(),
            "3d": F.dropout3d(ones5, 0.5).numpy(),
            "alpha": (F.alpha_dropout(sel, 0.2).numpy(), sel.numpy()),
        }
    finally:
        dy.disable_dygraph()


def _dropout_contract(d):
    ev, x = d["eval"]
    assert np.allclose(ev, x)
    zeros = (d["train"] == 0).mean()
    assert 0.45 < zeros < 0.55
    kept = d["train"][d["train"] != 0]
    xk = x[d["train"] != 0]
    assert np.allclose(kept, 2 * xk, rtol=1e-6)          # upscale_in_train
    assert np.allclose(d["downgrade"], 0.5 * x, rtol=1e-6)
    for key in ("2d", "3d"):
        per = d[key].reshape(d[key].shape[0], d[key].shape[1], -1)
        whole = np.all((per == 0) | np.isclose(per, 2.0), axis=-1) \
            & np.all(per == per[..., :1], axis=-1)
        assert whole.all() and 0.3 < (per[..., 0] == 0).mean() < 0.7
    out, s = d["alpha"]
    assert abs(out.mean() - s.mean()) < 0.05
    assert abs(out.std() - s.std()) < 0.05


@pytest.mark.parametrize("package", ["reference", "port"])
def test_dropout_family_contract(package):
    """The training flag, upscale_in_train and downgrade_in_infer, whole
    channels for dropout2d and dropout3d, and alpha_dropout keeping the
    mean and standard deviation (to 0.05 over 65,536 values)."""
    if package == "reference":
        _dropout_contract(_dropouts(JF, jdy, jdy.enable_dygraph))
    else:
        _dropout_contract(_dropouts(
            TF, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace())))


# --- the functions that wait for an op ---------------------------------------
WAITING = {
    "conv3d": (5, lambda: TF.conv3d(None, None)),
    "conv2d_transpose": (5, lambda: TF.conv2d_transpose(None, None)),
    "conv1d_transpose": (5, lambda: TF.conv1d_transpose(None, None)),
    "conv3d_transpose": (5, lambda: TF.conv3d_transpose(None, None)),
    "max_pool3d": (5, lambda: TF.max_pool3d(None, 2)),
    "avg_pool3d": (5, lambda: TF.avg_pool3d(None, 2)),
    "interpolate": (5, lambda: TF.interpolate(None, scale_factor=2)),
    "upsample": (5, lambda: TF.upsample(None, scale_factor=2)),
    "instance_norm": (5, lambda: TF.instance_norm(None)),
    "row_conv": (7, lambda: TF.row_conv(None, None)),
    "pixel_shuffle": (8, lambda: TF.pixel_shuffle(None, 2)),
    "grid_sample": (8, lambda: TF.grid_sample(None, None)),
    "affine_grid": (8, lambda: TF.affine_grid(None, [1, 1, 2, 2])),
    "unfold": (8, lambda: TF.unfold(None, 2)),
    "bilinear": (8, lambda: TF.bilinear(None, None, None)),
    "diag_embed": (8, lambda: TF.diag_embed(None)),
    "hsigmoid_loss": (8, lambda: TF.hsigmoid_loss(None, None, 2, None)),
    "ctc_loss": (8, lambda: TF.ctc_loss(None, None, None, None)),
}


@pytest.mark.parametrize("name", sorted(WAITING))
def test_waiting_function_raises_naming_its_item(name):
    item, call = WAITING[name]
    with pytest.raises(NotImplementedError,
                       match=f"queue A item {item}"):
        call()


def test_every_functional_name_has_a_case():
    import types
    names = {n for n in dir(TF) if not n.startswith("_")
             and callable(getattr(TF, n))
             and not isinstance(getattr(TF, n), types.ModuleType)}
    dropout = {"dropout", "dropout2d", "dropout3d", "alpha_dropout"}
    missing = sorted(names - set(CASES) - set(WAITING) - dropout
                     - {"emit_op"})
    assert not missing, missing


NN_OPS = ("nll_loss prelu huber_loss log_loss bce_loss kldiv_loss "
          "label_smooth l2_normalize lrn maxout log_softmax").split()


def test_functional_ops_registered():
    assert [op for op in NN_OPS if not has_op(op)] == []


# --- nn's activation and loss classes ----------------------------------------
LAYER_CASES = {
    "Sigmoid": (lambda nn: nn.Sigmoid(), ["x"]),
    "SiLU": (lambda nn: nn.SiLU(), ["x"]),
    "Mish": (lambda nn: nn.Mish(), ["x"]),
    "Hardswish": (lambda nn: nn.Hardswish(), ["x"]),
    "ELU": (lambda nn: nn.ELU(), ["x"]),
    "SELU": (lambda nn: nn.SELU(), ["x"]),
    "Softplus": (lambda nn: nn.Softplus(), ["x"]),
    "Softsign": (lambda nn: nn.Softsign(), ["x"]),
    "Softshrink": (lambda nn: nn.Softshrink(), ["x"]),
    "Hardshrink": (lambda nn: nn.Hardshrink(), ["x"]),
    "Tanhshrink": (lambda nn: nn.Tanhshrink(), ["x"]),
    "Hardsigmoid": (lambda nn: nn.Hardsigmoid(), ["x"]),
    "Swish": (lambda nn: nn.Swish(), ["x"]),
    "LogSigmoid": (lambda nn: nn.LogSigmoid(), ["x"]),
    "LeakyReLU": (lambda nn: nn.LeakyReLU(0.2), ["x"]),
    "Hardtanh": (lambda nn: nn.Hardtanh(-0.5, 0.5), ["x"]),
    "PReLU": (lambda nn: nn.PReLU(1, 0.3), ["x"]),
    "GLU": (lambda nn: nn.GLU(), ["x"]),
    "Softmax": (lambda nn: nn.Softmax(0), ["x"]),
    "CrossEntropyLoss": (lambda nn: nn.CrossEntropyLoss(), ["x", "lbl_col"]),
    "CrossEntropyLoss_sum": (lambda nn: nn.CrossEntropyLoss(
        reduction="sum"), ["x", "lbl_col"]),
    "MSELoss": (lambda nn: nn.MSELoss(), ["x", "y"]),
    "L1Loss": (lambda nn: nn.L1Loss(reduction="none"), ["x", "y"]),
    "BCELoss": (lambda nn: nn.BCELoss(), ["prob", "bin"]),
    "NLLLoss": (lambda nn: nn.NLLLoss(), ["logp", "lbl"]),
    "KLDivLoss": (lambda nn: nn.KLDivLoss(), ["x", "soft"]),
    "SmoothL1Loss": (lambda nn: nn.SmoothL1Loss(delta=0.5), ["x", "y"]),
}


def _layer(nn, dy, enter, name):
    make, keys = LAYER_CASES[name]
    enter()
    try:
        ins = [dy.to_variable(A[k]) for k in keys]
        ins[0].stop_gradient = False
        layer = make(nn)
        out = layer(*ins)
        from importlib import import_module
        L = import_module(type(layer).__module__.split(".")[0]
                          + ".fluid.layers")
        L.reduce_sum(out).backward()
        return [np.asarray(out.numpy()), np.asarray(ins[0].grad)]
    finally:
        dy.disable_dygraph()


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_activation_and_loss_layer_matches_reference(name):
    want = _layer(jnn, jdy, jdy.enable_dygraph, name)
    got = _layer(tnn, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()),
                 name)
    _same(got, want, name)


# --- nn.initializer, nn.utils.weight_norm, nn.clip -------------------------
def _param(nn_mod, dy, enter, init, shape=(64, 48), attr_cls=None):
    enter()
    try:
        pkg = nn_mod.__name__.split(".")[0]
        from importlib import import_module
        ParamAttr = import_module(pkg + ".fluid").ParamAttr
        lin = nn_mod.Linear(shape[0], shape[1],
                            ParamAttr(initializer=init))
        return np.asarray(lin.weight.numpy())
    finally:
        dy.disable_dygraph()


INIT_CASES = {
    # name -> (make(initializer module), check(port draw, reference draw))
    "Assign": (lambda I: I.Assign(np.arange(64 * 48, dtype="float32")
                                  .reshape(64, 48)),
               lambda g, w: np.array_equal(g, w)),
    "Constant": (lambda I: I.Constant(0.25),
                 lambda g, w: np.array_equal(g, w)),
    "Uniform": (lambda I: I.Uniform(-0.5, 0.5),
                lambda g, w: g.min() >= -0.5 and g.max() <= 0.5
                and abs(g.std() - w.std()) < 0.02),
    "Normal": (lambda I: I.Normal(0.0, 0.3),
               lambda g, w: abs(g.std() - 0.3) < 0.02
               and abs(g.std() - w.std()) < 0.02),
    "TruncatedNormal": (lambda I: I.TruncatedNormal(0.0, 1.0),
                        lambda g, w: np.abs(g).max() <= 2.0
                        and abs(g.std() - w.std()) < 0.03),
    "XavierUniform": (lambda I: I.XavierUniform(),
                      lambda g, w: abs(g.std() - w.std()) < 0.01),
    "XavierNormal_fans": (lambda I: I.XavierNormal(fan_in=10, fan_out=20),
                          lambda g, w: abs(g.std() - (2 / 30) ** 0.5)
                          < 0.02 and abs(g.std() - w.std()) < 0.02),
    "KaimingUniform": (lambda I: I.KaimingUniform(),
                       lambda g, w: abs(g.std() - w.std()) < 0.01),
    "KaimingNormal_fan_in": (lambda I: I.KaimingNormal(fan_in=8),
                             lambda g, w: abs(g.std() - 0.5) < 0.03
                             and abs(g.std() - w.std()) < 0.03),
}


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_initializer_matches_reference(name):
    """Values where an initializer is exact; otherwise the range and the
    standard deviation (to 0.01 to 0.03 over 3,072 draws) of the same
    law (the packages draw different numbers from one seed)."""
    make, check = INIT_CASES[name]
    import paddle_tpu.nn.initializer as JI
    import paddle_tpu_torch.nn.initializer as TI
    want = _param(jnn, jdy, jdy.enable_dygraph, make(JI))
    got = _param(tnn, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()),
                 make(TI))
    assert got.shape == want.shape and check(got, want)


def test_global_initializer_and_static_startup():
    """set_global_initializer sets what a parameter with no initializer
    gets (its own still wins), in both modes; a static program's
    startup fills an Assign'd parameter with its values."""
    import paddle_tpu_torch.nn.initializer as TI
    TI.set_global_initializer(TI.Constant(0.5), TI.Constant(-1.0))
    try:
        tdy.enable_dygraph(tfluid.CPUPlace())
        lin = tnn.Linear(3, 2)
        own = tnn.Linear(3, 2, tfluid.ParamAttr(initializer=TI.Constant(2.)))
        tdy.disable_dygraph()
        assert (lin.weight.numpy() == 0.5).all()
        assert (lin.bias.numpy() == -1.0).all()
        assert (own.weight.numpy() == 2.0).all()
    finally:
        TI.set_global_initializer(None)
    main, startup = tfluid.Program(), tfluid.Program()
    value = np.arange(6, dtype="float32").reshape(3, 2)
    with tfluid.program_guard(main, startup):
        x = tfluid.data("x", [1, 3])
        out = TL.fc(x, 2, param_attr=tfluid.ParamAttr(
            initializer=TI.Assign(value)), bias_attr=False)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    got, = exe.run(main, feed={"x": np.ones((1, 3), "float32")},
                   fetch_list=[out])
    np.testing.assert_array_equal(got, value.sum(0, keepdims=True))


def test_weight_norm_matches_reference():
    """weight_norm: the same forward and the same g and v as the
    reference's, and remove_weight_norm folds them back."""
    import paddle_tpu.nn.utils as JU
    import paddle_tpu_torch.nn.utils as TU
    w0 = _rnd(6, 3, seed=30)
    out = []
    for nn_mod, U, dy, enter in (
            (jnn, JU, jdy, jdy.enable_dygraph),
            (tnn, TU, tdy, lambda: tdy.enable_dygraph(tfluid.CPUPlace()))):
        enter()
        try:
            lin = nn_mod.Linear(6, 3)
            lin.weight.set_value(w0)
            U.weight_norm(lin, dim=1)
            x = dy.to_variable(A["x"])
            y = lin(x).numpy()
            g = lin.weight_g.numpy()
            U.remove_weight_norm(lin)
            out.append((y, g, lin.weight.numpy(), lin(x).numpy()))
        finally:
            dy.disable_dygraph()
    for g, w in zip(out[1], out[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_clip_names_are_the_fluid_clips():
    from paddle_tpu_torch.fluid import clip as fclip
    assert tnn.ClipGradByGlobalNorm is fclip.GradientClipByGlobalNorm
    assert tnn.clip.clip_by_norm is TL.clip_by_norm
