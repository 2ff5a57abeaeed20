"""The sequence tier's builders in both packages: the 27 ``fluid.layers``
builders (the 16 ``sequence_*``, ``im2sequence`` and the CRF, CTC and
sampled-head ten), ``fluid.nets`` and the book's sentiment text CNN at
``tests/test_book_models.py``'s width; and one test for each of the
reference's quirks that the port copies (ROADMAP queue C).
``test_torch_sequence_dygraph.py`` runs the same builders under each
package's tracer, and the classes (the reference's eager ops compile at
each new shape, so the two files run on two workers, each within a
minute).

The builders run as one static program a family in each package from
the reference's startup values (``run_both``); outputs within rtol 1e-4
of their largest value, ids equal.  ``nce`` draws its negatives from its
seed, so only its contract is held (``test_torch_sequence_ops``).
"""
import numpy as np
import pytest

import jax

import paddle_tpu as jp
from paddle_tpu.dygraph import base as jdy

import paddle_tpu_torch as tp
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.dygraph import base as tdy

from test_torch_control_flow import run_both
from test_torch_op_sweep import assert_close
from test_torch_rnn_ops import _programs
from test_torch_sequence_ops import run_both as run_op

jax.config.update("jax_platforms", "cpu")

RTOL = 1e-4


def _r(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype("float32")


def _ints(hi, *shape, seed=0):
    return np.random.RandomState(seed).randint(0, hi, shape).astype("int64")


FEED = {"x": _r(3, 5, 4, seed=1), "x2": _r(3, 4, seed=2),
        "s": _r(3, 5, seed=3), "n": np.array([5, 3, 1], "int64"),
        "ids": _ints(6, 3, 7, seed=4),
        "off": np.array([[1], [0], [3]], "int64"),
        "ln": np.array([[3], [2], [2]], "int64"),
        "sidx": np.array([[0], [2], [2], [1]], "int64"),
        "upd": _r(4, 4, seed=5), "pv": np.array([0.5], "float32"),
        "em": _r(3, 5, 6, seed=6), "tag": _ints(6, 3, 5, seed=7),
        "logits": _r(3, 8, 5, seed=8),
        "lbl": np.array([[1, 2, 0], [3, 3, 1], [2, 0, 0]], "int64"),
        "lbl_n": np.array([2, 3, 1], "int64"),
        "hyp": _ints(4, 3, 5, seed=13),
        "img": _r(2, 3, 6, 4, seed=9), "feat": _r(6, 4, seed=10),
        "cls": _ints(7, 6, 1, seed=11), "cls3": _ints(3, 6, 1, seed=12)}


def _data(fluid, names):
    return {k: fluid.data(k, list(FEED[k].shape), str(FEED[k].dtype))
            for k in names}


# --- the builders, one family to a program -----------------------------------
def _chunks(L, v):
    path = L.crf_decoding(v["em"], param_attr="crfw_c", length=v["n"])
    return L.concat([L.cast(c, "float32") for c in L.chunk_eval(
        path, v["tag"], "IOB", 3, seq_length=v["n"])], 0)


FAMILIES = {
    "sequence": {
        "sequence_conv": lambda L, v: L.sequence_conv(
            v["x"], 6, 3, act="tanh", length=v["n"]),
        "sequence_expand": lambda L, v: L.sequence_expand(v["x2"], v["x"]),
        "sequence_mask": lambda L, v: L.sequence_mask(v["n"], maxlen=6),
        "sequence_pad": lambda L, v: L.sequence_pad(
            v["x"], v["pv"], maxlen=7, length=v["n"])[0],
        "sequence_unpad": lambda L, v: L.sequence_unpad(v["x"], v["n"]),
        "sequence_erase": lambda L, v: L.sequence_erase(v["ids"], [2, 4]),
        "sequence_concat": lambda L, v: L.sequence_concat([v["x"], v["x"]]),
        "sequence_first_step": lambda L, v: L.sequence_first_step(
            v["x"], v["n"]),
        "sequence_last_step": lambda L, v: L.sequence_last_step(
            v["x"], v["n"]),
        "sequence_slice": lambda L, v: L.sequence_slice(
            v["x"], v["off"], v["ln"]),
        "sequence_expand_as": lambda L, v: L.sequence_expand_as(
            v["x2"], v["x"]),
        "sequence_reshape": lambda L, v: L.sequence_reshape(v["x"], 10),
        "sequence_scatter": lambda L, v: L.sequence_scatter(
            v["x2"], v["sidx"], v["upd"]),
        "sequence_enumerate": lambda L, v: L.sequence_enumerate(
            v["ids"], 3, pad_value=9),
        "sequence_softmax": lambda L, v: L.sequence_softmax(v["s"], v["n"]),
        "sequence_reverse": lambda L, v: L.sequence_reverse(v["x"], v["n"]),
    },
    "crf_ctc": {
        "linear_chain_crf": lambda L, v: L.linear_chain_crf(
            v["em"], v["tag"], param_attr="crfw_t", length=v["n"]),
        "crf_decoding": lambda L, v: L.crf_decoding(
            v["em"], param_attr="crfw_d", length=v["n"]),
        "chunk_eval": _chunks,
        "warpctc": lambda L, v: L.warpctc(
            v["logits"], v["lbl"], blank=0, label_length=v["lbl_n"],
            norm_by_times=True),
        "ctc_greedy_decoder": lambda L, v: L.ctc_greedy_decoder(
            v["logits"], blank=0),
        "edit_distance": lambda L, v: L.edit_distance(
            v["hyp"], v["lbl"], input_length=v["n"],
            label_length=v["lbl_n"])[0],
        "im2sequence": lambda L, v: L.im2sequence(
            v["img"], [3, 2], stride=[1, 2], padding=[1, 0, 0, 1]),
        "hsigmoid": lambda L, v: L.hsigmoid(v["feat"], v["cls"], 7),
        "center_loss": lambda L, v: L.center_loss(v["feat"], v["cls3"], 3,
                                                  0.25),
        "sampled_softmax_with_cross_entropy":
            lambda L, v: L.sampled_softmax_with_cross_entropy(
                L.fc(v["feat"], 7), v["cls"], num_samples=3),
    },
}
BUILDER_CASES = [(f, name) for f, cases in FAMILIES.items()
                 for name in sorted(cases)]


def _family(L, v, family):
    return {k: FAMILIES[family][k](L, v) for k in sorted(FAMILIES[family])}


@pytest.fixture(scope="module")
def static_results():
    out = {}
    for family in FAMILIES:
        def build(fluid, family=family):
            return list(_family(fluid.layers, _data(fluid, FEED),
                                family).values())
        ref, port, _ = run_both(build, FEED)
        out[family] = {k: (p, r) for k, p, r in
                       zip(sorted(FAMILIES[family]), port[0], ref[0])}
    return out


@pytest.mark.parametrize("family,name", BUILDER_CASES)
def test_builder_static_matches_reference(family, name, static_results):
    got, want = static_results[family][name]
    assert_close(got, want, RTOL, name)


FEED.update({"gru_in": _r(3, 12, seed=14), "gru_h": _r(3, 4, seed=15),
             "nodes": _r(2, 5, 3, seed=16),
             "edges": np.array([[[0, 1], [0, 2], [1, 3], [1, 4]],
                                [[0, 1], [1, 2], [0, 0], [0, 0]]], "int64"),
             "logp": np.log(np.random.RandomState(17).dirichlet(
                 np.ones(5), (3, 8)).astype("float32")),
             "in_n": np.array([8, 6, 5], "int64")})

# --- fluid.nets and the sentiment text CNN -----------------------------------
def _nets(fluid):
    nets, L = fluid.nets, fluid.layers
    img = fluid.data("img", [2, 3, 6, 4])
    x = fluid.data("x", [3, 5, 4])
    outs = [nets.simple_img_conv_pool(img, 4, 3, 2, 2, act="relu"),
            nets.img_conv_group(img, [4, 5], 2, conv_act="relu",
                                conv_with_batchnorm=[False, True],
                                pool_stride=2),
            nets.sequence_conv_pool(x, 6, 3),
            nets.glu(x),
            nets.scaled_dot_product_attention(x, x, x),
            nets.scaled_dot_product_attention(x, x, x, num_heads=2)]
    loss = L.reduce_sum(L.concat([L.reshape(o, [-1]) for o in outs], 0))
    _, pg = fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return outs + [g for _, g in sorted(pg, key=lambda t: t[0].name)]


def test_nets_match_reference():
    """The five composites in one static program a package, forward and
    every parameter's gradient."""
    run = _programs(_nets)
    ref, port = run({"img": FEED["img"], "x": FEED["x"]})
    assert len(ref) == len(port) > 6
    for i, (g, w) in enumerate(zip(port, ref)):
        assert_close(g, w, RTOL, f"nets fetch {i}")


SENTIMENT = dict(vocab=50, dim=8, seq=12, batch=64)   # test_book_models.py


def _sentiment(fluid):
    """TestSentimentConv's text CNN: embedding, ``sequence_conv_pool``
    (16 filters of 3, sigmoid, max), an fc to 2, the mean softmax cross
    entropy, SGD at 0.5."""
    L, p = fluid.layers, SENTIMENT
    words = fluid.data("words", [p["batch"], p["seq"]], "int64")
    label = fluid.data("label", [p["batch"], 1], "int64")
    emb = L.embedding(words, size=[p["vocab"], p["dim"]])
    conv = fluid.nets.sequence_conv_pool(emb, num_filters=16, filter_size=3,
                                         act="sigmoid", pool_type="max")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(conv, 2), label))
    _, pg = fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss] + [g for _, g in sorted(pg, key=lambda t: t[0].name)]


def _sentiment_feeds():
    r = np.random.RandomState(1)
    xs = r.randint(0, SENTIMENT["vocab"], (256, SENTIMENT["seq"])) \
        .astype("int64")
    ys = (xs == 7).any(axis=1).astype("int64").reshape(-1, 1)
    return [{"words": xs[s:s + 64], "label": ys[s:s + 64]}
            for s in range(0, 256, 64)]


def test_sentiment_text_cnn_matches_reference():
    """Four SGD steps from the reference's initial values: each step's
    loss, and the first step's gradients, within rtol 1e-4; then both
    packages go on to the test's 60 steps and the port's loss falls as
    the reference test asks (below 0.6 of the first)."""
    run = _programs(_sentiment)
    feeds = _sentiment_feeds()
    losses = []
    for i, feed in enumerate(feeds):
        ref, port = run(feed)
        for j, (g, w) in enumerate(zip(port if i == 0 else port[:1],
                                       ref if i == 0 else ref[:1])):
            assert_close(g, w, RTOL, f"step {i} fetch {j}")
        losses.append(float(port[0]))
    for i in range(4, 60):
        losses.append(float(run(feeds[i % 4])[1][0]))
    assert losses[-1] < losses[0] * 0.6 and np.isfinite(losses[-1])


def test_nce_builder_contract():
    """``fluid.layers.nce`` in a static program of each package: the same
    parameters ([V, D] weight, [V] bias), and the port's cost [B, 1]
    finite (the negatives are the port's own draws)."""
    def build(fluid):
        x = fluid.data("feat", [6, 4])
        y = fluid.data("cls", [6, 1], "int64")
        return [fluid.layers.nce(x, y, 7, num_neg_samples=3, seed=2)]
    feed = {"feat": FEED["feat"], "cls": FEED["cls"]}
    _, port, progs = run_both(build, feed)
    shapes = {pkg: sorted(tuple(p.shape) for p in
                          prog.global_block().all_parameters())
              for pkg, prog in progs.items()}
    assert shapes["port"] == shapes["ref"] == [(7,), (7, 4)]
    cost = np.asarray(port[0][0])
    assert cost.shape == (6, 1) and np.isfinite(cost).all()


# --- the reference's quirks the port copies (ROADMAP queue C) ----------------
def test_quirk_chunk_eval_is_a_simplified_iob():
    """``chunk_eval`` reads neither ``chunk_scheme``, ``num_chunk_types``
    nor ``excluded_chunk_types``; a tag's type is ``tag // 2`` and any
    even tag opens a chunk, so SRL's ``O`` (58) is a chunk at every
    token: in both packages alike."""
    tags = np.full((2, 6), 58, "int64")
    ins = {"Inference": tags, "Label": tags,
           "SeqLength": np.array([6, 4], "int64")}
    outs = []
    for attrs in ({"chunk_scheme": "IOB", "num_chunk_types": 29},
                  {"chunk_scheme": "IOE", "num_chunk_types": 3,
                   "excluded_chunk_types": [29]}):
        ref, port = run_op("chunk_eval", ins, attrs)
        for k in ref:
            assert_close(port[k][0].numpy(), np.asarray(ref[k][0]), RTOL,
                         k)
        outs.append({k: port[k][0].numpy() for k in port})
    for k in outs[0]:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])
    assert outs[0]["NumLabelChunks"][0] == 10          # one a token


def test_quirk_crf_decoding_ignores_label():
    """Paddle's ``crf_decoding`` returns 0/1 correctness when given
    ``Label``; the reference's, and the port's, return the path."""
    em, tr = _r(2, 4, 3, seed=20), _r(5, 3, seed=21)
    base = {"Emission": em, "Transition": tr}
    ref, port = run_op("crf_decoding", dict(base, Label=_ints(3, 2, 4)), {})
    _, alone = run_op("crf_decoding", base, {})
    assert_close(port["ViterbiPath"][0].numpy(),
                 np.asarray(ref["ViterbiPath"][0]), RTOL, "path")
    assert_close(port["ViterbiPath"][0].numpy(),
                 alone["ViterbiPath"][0].numpy(), RTOL, "path without Label")


def test_quirk_gru_unit_never_applies_its_reset_gate():
    """``dygraph.GRUUnit``'s output does not move with the reset gate's
    third of the input, in both packages."""
    for pd, dy, enter in ((jp, jdy, jdy.enable_dygraph),
                          (tp, tdy,
                           lambda: tdy.enable_dygraph(tfluid.CPUPlace()))):
        enter()
        try:
            np.random.seed(0)
            layer = pd.dygraph.GRUUnit(12)
            x, h = FEED["gru_in"], FEED["gru_h"]
            moved = x.copy()
            moved[:, 4:8] += 3.0
            a = layer(dy.to_variable(x), dy.to_variable(h))[0].numpy()
            b = layer(dy.to_variable(moved), dy.to_variable(h))[0].numpy()
            np.testing.assert_array_equal(a, b)
        finally:
            dy.disable_dygraph()


def test_quirk_nce_reads_no_sampler_and_no_sample_weight():
    """``nce``'s ``sampler``, ``custom_dist`` and ``SampleWeight`` change
    nothing: one seed, one cost."""
    from test_torch_sequence_ops import NCE, _port
    ins, attrs = NCE
    ins = {k: v[:32] if k in ("Input", "Label") else v
           for k, v in ins.items()}
    base = _port("nce", ins, attrs)["Cost"][0].numpy()
    other = _port("nce", dict(ins, SampleWeight=_r(32, 1, seed=22)),
                  dict(attrs, sampler=2, custom_dist=[0.5] * 20))
    np.testing.assert_array_equal(other["Cost"][0].numpy(), base)


def test_quirk_sampled_softmax_is_the_full_softmax():
    """``sampled_softmax_with_cross_entropy`` is
    ``softmax_with_cross_entropy`` over every class, in both packages."""
    def build(fluid):
        L = fluid.layers
        x = fluid.data("x", [6, 7])
        y = fluid.data("y", [6, 1], "int64")
        return [L.sampled_softmax_with_cross_entropy(x, y, num_samples=2),
                L.softmax_with_cross_entropy(x, y)]
    ref, port, _ = run_both(build, {"x": _r(6, 7, seed=23),
                                    "y": FEED["cls"]})
    assert_close(port[0][0], ref[0][0], RTOL, "sampled")
    np.testing.assert_array_equal(port[0][0], port[0][1])


def test_quirk_hierarchical_sigmoid_pre_out_is_zeros():
    _, ins, attrs = __import__("test_torch_sequence_ops").OP_CASES[
        "hierarchical_sigmoid"]
    ref, port = run_op("hierarchical_sigmoid", ins, attrs)
    assert not port["PreOut"][0].numpy().any()
    assert not np.asarray(ref["PreOut"][0]).any()
    assert port["PreOut"][0].shape == (4, 3)


def test_quirk_tree_conv_padding_is_a_self_loop_on_node_0():
    """An EdgeSet padded with (0, 0) makes node 0 its own child; and the
    filter [D, 3, output_size, num_filters] is read as [D, H, depth,
    out]: the max runs over its second axis."""
    nodes, filt = _r(1, 3, 2, seed=24), _r(2, 3, 2, 4, seed=25)
    padded = {"NodesVector": nodes, "Filter": filt,
              "EdgeSet": np.array([[[0, 1], [0, 0]]], "int64")}
    looped = dict(padded, EdgeSet=np.array([[[0, 1], [0, 0], [0, 0]]],
                                           "int64"))
    plain = dict(padded, EdgeSet=np.array([[[0, 1]]], "int64"))
    ref, port = run_op("tree_conv", padded, {})
    assert_close(port["Out"][0].numpy(), np.asarray(ref["Out"][0]), RTOL,
                 "padded")
    _, port_loop = run_op("tree_conv", looped, {})
    _, port_plain = run_op("tree_conv", plain, {})
    np.testing.assert_array_equal(port["Out"][0].numpy(),
                                  port_loop["Out"][0].numpy())
    assert not np.allclose(port["Out"][0].numpy()[0, 0],
                           port_plain["Out"][0].numpy()[0, 0])
    assert port["Out"][0].shape == (1, 3, 4)


def test_quirk_ctc_loss_reads_axis_0_as_the_batch():
    """``F.ctc_loss`` and ``nn.CTCLoss`` read ``log_probs`` [B, T, C]
    (Paddle 2.0's is time-major [T, B, C]): the loss of each row is
    ``warpctc`` over that row, in both packages."""
    ins = {"Logits": FEED["logp"], "Label": FEED["lbl"],
           "LogitsLength": FEED["in_n"], "LabelLength": FEED["lbl_n"]}
    _, port = run_op("warpctc", ins, {"blank": 0})
    per_row = port["Loss"][0].numpy().reshape(-1)
    outs = []
    for pd, dy, enter in ((jp, jdy, jdy.enable_dygraph),
                          (tp, tdy,
                           lambda: tdy.enable_dygraph(tfluid.CPUPlace()))):
        enter()
        try:
            v = [dy.to_variable(FEED[k])
                 for k in ("logp", "lbl", "in_n", "lbl_n")]
            outs.append(pd.nn.functional.ctc_loss(*v, reduction="none")
                        .numpy().reshape(-1))
        finally:
            dy.disable_dygraph()
    assert_close(outs[1], outs[0], RTOL, "ctc_loss, reduction none")
    assert_close(outs[1], per_row, RTOL, "ctc_loss against warpctc by row")
