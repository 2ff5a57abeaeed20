"""NLP ops (counterpart of ``paddle_tpu/ops/nlp_ops.py``): the linear-
chain CRF and its Viterbi decode, CTC and its alignment, the edit
distance, chunk evaluation, beam search, the sampled heads (``nce``,
``hierarchical_sigmoid``, ``sample_logits``) and the text-matching
convolutions.

Sequences are padded ``[B, T, ...]`` with an explicit length, as in the
reference; every dynamic programme is a loop over the time axis, masked
with ``_NEG`` (never ``-inf``: ``logaddexp``'s gradient at two ``-inf``
is NaN).  A gather whose gradient would add into repeated positions (the
CRF's labels, CTC's extended label) is a product with a one-hot matrix
instead, so its gradient is a sum in a fixed order on the card too, not
an atomic add.  Beams are dense: a step's scores are [B · beam, V] and a
decoded history is [T, B, beam].  Ids are int64 (the reference narrows
them to int32 through ``wide_int``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .registry import register_op
from .sequence_extra import _compact, _mask

_NEG = -1e30


def _lengths(ins, slot, b, t, device):
    """The ``slot`` lengths as int64 [B], or ``t`` for every row."""
    if ins.get(slot):
        return ins[slot][0].reshape(-1).long()
    return torch.full((b,), t, dtype=torch.long, device=device)


def _onehot(ids, n, dtype):
    return F.one_hot(ids, n).to(dtype)


# --- linear-chain CRF --------------------------------------------------------
def _crf_norm(emission, transition, length):
    """The log-partition by the forward algorithm.  Transition rows 0 and
    1 are the start and stop weights, rows 2.. the [D, D] transitions
    (linear_chain_crf_op.h's layout)."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    valid = _mask(length - 1, emission.shape[1] - 1)
    alpha = start[None] + emission[:, 0]
    for k in range(1, emission.shape[1]):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None], dim=1) \
            + emission[:, k]
        alpha = torch.where(valid[:, k - 1, None], nxt, alpha)
    return torch.logsumexp(alpha + stop[None], dim=1)


def _crf_score(emission, transition, label, length):
    """The labelled path's score, each gather a one-hot product."""
    start, stop, trans = transition[0], transition[1], transition[2:]
    b, t, d = emission.shape
    m = _mask(length, t)
    oh = _onehot(label, d, emission.dtype)                 # [B, T, D]
    em_score = torch.where(m, (emission * oh).sum(-1), 0.0).sum(1)
    tr = ((oh[:, :-1] @ trans) * oh[:, 1:]).sum(-1)        # [B, T - 1]
    tr_score = torch.where(m[:, 1:], tr, 0.0).sum(1)
    last = torch.clamp(length - 1, min=0)
    last_lbl = torch.gather(label, 1, last[:, None]).squeeze(1)
    return ((oh[:, 0] * start).sum(-1) + em_score + tr_score
            + (_onehot(last_lbl, d, emission.dtype) * stop).sum(-1))


def _crf_ins(ins):
    emission = ins["Emission"][0]
    b, t = emission.shape[:2]
    return (emission, ins["Transition"][0],
            _lengths(ins, "Length", b, t, emission.device))


@register_op("linear_chain_crf", nondiff_inputs=("Label", "Length"))
def _linear_chain_crf(ins, attrs, ctx):
    """linear_chain_crf_op.h: the negative log-likelihood [B, 1] of each
    row's labels; ``EmissionExps``, ``TransitionExps`` and ``Alpha`` as
    the reference gives them (``Alpha`` is the emission)."""
    emission, transition, length = _crf_ins(ins)
    label = ins["Label"][0].long()
    if label.ndim == 3:
        label = label.squeeze(-1)
    ll = _crf_norm(emission, transition, length) \
        - _crf_score(emission, transition, label, length)
    return {"LogLikelihood": [ll.reshape(-1, 1)],
            "EmissionExps": [torch.exp(emission)],
            "TransitionExps": [torch.exp(transition)],
            "Alpha": [emission]}


@register_op("crf_decoding", nondiff_inputs=("Label", "Length"),
             differentiable=False)
def _crf_decoding(ins, attrs, ctx):
    """crf_decoding_op.h's Viterbi path [B, T]: max-plus forward with
    the first maximal predecessor (``argmax``), then the backtrace; a
    position past a row's length repeats its last label.  ``Label`` is
    not read (Paddle would return 0/1 correctness)."""
    emission, transition, length = _crf_ins(ins)
    start, stop, trans = transition[0], transition[1], transition[2:]
    t = emission.shape[1]
    valid = _mask(length - 1, t - 1)
    alpha = start[None] + emission[:, 0]
    back = []
    for k in range(1, t):
        scores = alpha[:, :, None] + trans[None]              # [B, D, D]
        back.append(torch.argmax(scores, dim=1))
        nxt = torch.amax(scores, dim=1) + emission[:, k]
        alpha = torch.where(valid[:, k - 1, None], nxt, alpha)
    cur = torch.argmax(alpha + stop[None], dim=1)
    path = [None] * t
    for k in range(t - 2, -1, -1):
        path[k + 1] = cur
        prev = torch.gather(back[k], 1, cur[:, None]).squeeze(1)
        cur = torch.where(valid[:, k], prev, cur)
    path[0] = cur
    return {"ViterbiPath": [torch.stack(path, dim=1)]}


# --- CTC ---------------------------------------------------------------------
@register_op("warpctc", nondiff_inputs=("Label", "LogitsLength",
                                        "LabelLength"))
def _warpctc(ins, attrs, ctx):
    """CTC loss [B, 1] (warpctc_op.cc) by the alpha recursion over
    ``Logits`` [B, T, C] (batch first, padded) and ``Label`` [B, L]
    padded; without ``LabelLength`` a label's length is its count of
    non-blanks.  An empty label's loss is the all-blank path's.  With
    ``norm_by_times`` the loss is divided by the row's length.
    ``WarpCTCGrad`` is zeros, as the reference's."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].long().reshape(logits.shape[0], -1)
    blank = attrs.get("blank", 0)
    b, t, c = logits.shape
    s = 2 * label.shape[1] + 1
    logits_len = _lengths(ins, "LogitsLength", b, t, logits.device)
    label_len = (ins["LabelLength"][0].reshape(-1).long()
                 if ins.get("LabelLength") else (label != blank).sum(1))
    logp = torch.log_softmax(logits, dim=-1)
    # blank a1 blank a2 ... aL blank; its emissions [B, T, S] by a one-hot
    # product (a gather's gradient would add into the repeated blanks)
    ext = torch.full((b, s), blank, dtype=torch.long, device=logits.device)
    ext[:, 1::2] = label
    em = logp @ _onehot(ext, c, logp.dtype).transpose(1, 2)
    pos = torch.arange(s, device=logits.device)[None, :]
    ext_valid = pos < (2 * label_len + 1)[:, None]
    skip_ok = torch.cat([torch.zeros_like(ext_valid[:, :2]),
                         (ext[:, 2:] != blank) & (ext[:, 2:] != ext[:, :-2])],
                        dim=1)[:, :s]
    neg = torch.full((b, 2), _NEG, dtype=logp.dtype, device=logits.device)
    alpha = torch.cat([em[:, 0, :2], torch.full(
        (b, max(s - 2, 0)), _NEG, dtype=logp.dtype, device=logits.device)], 1)
    alpha = torch.where(ext_valid, alpha, _NEG)
    t_valid = _mask(logits_len - 1, t - 1)
    for k in range(1, t):
        shift1 = torch.cat([neg[:, :1], alpha[:, :-1]], 1)
        shift2 = torch.cat([neg, alpha[:, :-2]], 1)[:, :s]
        cand = torch.logaddexp(alpha, shift1)
        cand = torch.where(skip_ok, torch.logaddexp(cand, shift2), cand)
        nxt = torch.where(ext_valid, cand + em[:, k], _NEG)
        alpha = torch.where(t_valid[:, k - 1, None], nxt, alpha)
    end = 2 * label_len - 1
    a_last = torch.gather(alpha, 1, (end + 1)[:, None]).squeeze(1)
    a_prev = torch.gather(alpha, 1, torch.clamp(end, min=0)[:, None]) \
        .squeeze(1)
    loss = -torch.logaddexp(a_last, a_prev)
    # an empty label's one path is all blank, alpha[:, 0]; the two gathers
    # above would both read it and add ln 2
    loss = torch.where(label_len == 0, -alpha[:, 0], loss)
    if attrs.get("norm_by_times", False):
        loss = loss / torch.clamp(logits_len.to(loss.dtype), min=1.0)
    return {"Loss": [loss.reshape(-1, 1)],
            "WarpCTCGrad": [torch.zeros_like(logits)]}


@register_op("ctc_align", differentiable=False)
def _ctc_align(ins, attrs, ctx):
    """ctc_align_op.cc: repeats merged, then blanks removed, each row
    compacted left and padded with ``padding_value`` at the input's
    width; ``OutputLength`` [B, 1].  ``InputLength`` is not read, as in
    the reference."""
    x = ins["Input"][0].long()
    blank = attrs.get("blank", 0)
    prev = torch.cat([torch.full_like(x[:, :1], -1), x[:, :-1]], dim=1)
    out, lens = _compact(x, (x != blank) & (x != prev),
                         attrs.get("padding_value", 0))
    return {"Output": [out], "OutputLength": [lens.reshape(-1, 1)]}


@register_op("edit_distance", differentiable=False)
def _edit_distance(ins, attrs, ctx):
    """edit_distance_op.cc: the Levenshtein distance of ``Hyps`` [B, M]
    against ``Refs`` [B, N] (padded, lengths by ``HypsLength`` and
    ``RefsLength``), divided by the reference's length when
    ``normalized``.  One row of the table a hypothesis token; within a
    row, with ``cand_j = min(up_j + 1, diag_j + sub_j)``, the left-to-
    right minimum ``left_j = min(cand_j, left_{j-1} + 1)`` is
    ``j + min(left_0, min_{k<=j} (cand_k - k))``: one ``cummin``.  The
    values are small integers, exact in float32."""
    hyp, ref = ins["Hyps"][0].long(), ins["Refs"][0].long()
    b, m = hyp.shape
    n = ref.shape[1]
    hyp_len = _lengths(ins, "HypsLength", b, m, hyp.device)
    ref_len = _lengths(ins, "RefsLength", b, n, hyp.device)
    cols = torch.arange(n + 1, dtype=torch.float32, device=hyp.device)
    row = cols[None].expand(b, n + 1)
    valid = _mask(hyp_len, m)
    for i in range(m):
        sub = (ref != hyp[:, i:i + 1]).to(torch.float32)
        cand = torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)
        lead = torch.cat([row[:, :1] + 1, cand - cols[None, 1:]], dim=1)
        nrow = cols[None] + torch.cummin(lead, dim=1).values
        row = torch.where(valid[:, i:i + 1], nrow, row)
    dist = torch.gather(row, 1, ref_len[:, None]).squeeze(1)
    if attrs.get("normalized", True):
        dist = dist / torch.clamp(ref_len.to(dist.dtype), min=1.0)
    return {"Out": [dist.reshape(-1, 1)],
            "SequenceNum": [torch.tensor([b], dtype=torch.long,
                                         device=hyp.device)]}


@register_op("chunk_eval", differentiable=False)
def _chunk_eval(ins, attrs, ctx):
    """chunk_eval_op.cc as the reference simplifies it: one IOB scheme
    whatever ``chunk_scheme``, ``num_chunk_types`` and
    ``excluded_chunk_types`` say; a tag's type is ``tag // 2`` and any
    even tag, or a change of type, opens a chunk; a chunk is correct
    when inference and label agree from its start to the label's next
    boundary.  Precision, recall, F1 and the three counts."""
    inf = ins["Inference"][0].long()
    lbl = ins["Label"][0].long()
    if inf.ndim == 3:
        inf, lbl = inf.squeeze(-1), lbl.squeeze(-1)
    b, t = inf.shape
    m = _mask(_lengths(ins, "SeqLength", b, t, inf.device), t)

    def starts(tags):
        prev = torch.cat([torch.full_like(tags[:, :1], -1), tags[:, :-1]], 1)
        return (tags % 2 == 0) | (torch.div(tags, 2, rounding_mode="floor")
                                  != torch.div(prev, 2, rounding_mode="floor"))

    lbl_starts = starts(lbl)
    same = inf == lbl
    first = lbl_starts & starts(inf) & same & m
    boundary = torch.cat([lbl_starts[:, 1:],
                          torch.ones_like(lbl_starts[:, :1])], 1)
    ok = torch.where(m, same, True)
    # whether every position from t to the label's next boundary agrees
    good = [None] * t
    carry = torch.ones_like(ok[:, 0])
    for k in range(t - 1, -1, -1):
        carry = ok[:, k] & (boundary[:, k] | carry)
        good[k] = carry
    correct = (first & torch.stack(good, 1)).sum()
    n_inf = (starts(inf) & m).sum()
    n_lbl = (lbl_starts & m).sum()
    p = correct / torch.clamp(n_inf, min=1)
    r = correct / torch.clamp(n_lbl, min=1)
    f1 = 2 * p * r / torch.clamp(p + r, min=1e-9)
    return {"Precision": [p.reshape(1).float()],
            "Recall": [r.reshape(1).float()],
            "F1-Score": [f1.reshape(1).float()],
            "NumInferChunks": [n_inf.reshape(1)],
            "NumLabelChunks": [n_lbl.reshape(1)],
            "NumCorrectChunks": [correct.reshape(1)]}


@register_op("beam_search", nondiff_inputs=("pre_ids", "pre_scores", "ids",
                                            "scores"), differentiable=False)
def _beam_search(ins, attrs, ctx):
    """One step of beam_search_op.cc: ``scores`` [B · beam, V] of this
    step (with ``is_accumulated``, the default, already the prefix's sum;
    otherwise probabilities, whose logs are added to ``pre_scores``); a
    beam whose last id is ``end_id`` keeps only ``end_id`` at its own
    score.  The top ``beam_size`` (id, score) of each source sentence,
    and each one's parent row."""
    pre_ids = ins["pre_ids"][0].reshape(-1)
    pre_scores = ins["pre_scores"][0].reshape(-1, 1)
    scores = ins["scores"][0]
    beam = attrs.get("beam_size", 4)
    end_id = attrs.get("end_id", 1)
    nb, v = scores.shape
    src = nb // beam
    cand = scores if attrs.get("is_accumulated", True) \
        else torch.log(scores.clamp(min=1e-20)) + pre_scores
    is_end = torch.arange(v, device=scores.device)[None] == end_id
    kept = torch.where(is_end, pre_scores, torch.full_like(cand, _NEG))
    cand = torch.where((pre_ids == end_id)[:, None], kept, cand)
    top_scores, top_idx = torch.topk(cand.reshape(src, beam * v), beam)
    parent = top_idx // v + torch.arange(src, device=scores.device)[:, None] \
        * beam
    return {"selected_ids": [(top_idx % v).reshape(-1, 1)],
            "selected_scores": [top_scores.reshape(-1, 1)],
            "parent_idx": [parent.reshape(-1)]}


def _backtrace(ids, parents):
    """gather_tree_op.cc over ``ids`` and ``parents`` [T, B, beam]: from
    the last step back, each beam's token and then its parent's beam."""
    beam_idx = torch.arange(ids.shape[2], device=ids.device) \
        .expand(ids.shape[1:])
    toks = [None] * ids.shape[0]
    for t in range(ids.shape[0] - 1, -1, -1):
        toks[t] = torch.gather(ids[t], 1, beam_idx)
        beam_idx = torch.gather(parents[t].long(), 1, beam_idx)
    return torch.stack(toks)


@register_op("gather_tree", differentiable=False)
def _gather_tree(ins, attrs, ctx):
    """The full sequences [T, B, beam] that end at each last-step beam."""
    return {"Out": [_backtrace(ins["Ids"][0].long(), ins["Parents"][0])]}


@register_op("beam_search_decode", differentiable=False)
def _beam_search_decode(ins, attrs, ctx):
    """beam_search_decode_op.cc made dense: ``Ids`` and ``ParentIdx``
    stacked [T, B, beam], backtraced as ``gather_tree`` does;
    ``SentenceScores`` is ``Scores`` where given."""
    res = {"SentenceIds": [_backtrace(ins["Ids"][0].long(),
                                      ins["ParentIdx"][0])]}
    if ins.get("Scores"):
        res["SentenceScores"] = [ins["Scores"][0]]
    return res


# --- sampled heads -----------------------------------------------------------
def _uniform_ids(ctx, attrs, shape, high, device):
    """Uniform ids in [0, high) from the op's seed (``op_seed``, else
    ``seed``): Philox on the card, torch's CPU generator on the host;
    nothing compares these draws with the reference's."""
    seed = attrs.get("op_seed", attrs.get("seed", 0) or 0)
    return torch.randint(0, high, shape, generator=ctx.key_for(seed),
                         device=device)


@register_op("nce", nondiff_inputs=("Label", "SampleWeight",
                                    "CustomDistProbs", "CustomDistAlias",
                                    "CustomDistAliasProbs"),
             stateful_rng=True)
def _nce(ins, attrs, ctx):
    """nce_op.h with uniform negatives (``sampler``, ``custom_dist`` and
    ``SampleWeight`` are not read, as in the reference): ``Input`` [B, D],
    ``Weight`` [V, D], ``Label`` [B, num_true]; the true and sampled
    logits shifted by log(k / V), log-sigmoid costs summed a row."""
    x, w = ins["Input"][0], ins["Weight"][0]
    label = ins["Label"][0].long()
    if label.ndim == 1:
        label = label[:, None]
    num_neg = attrs.get("num_neg_samples", 10)
    num_total = attrs.get("num_total_classes", w.shape[0])
    bsz, num_true = label.shape
    neg = _uniform_ids(ctx, attrs, (bsz, num_neg), num_total, x.device)
    samples = torch.cat([label, neg], dim=1)              # [B, true + neg]
    logits = torch.einsum("bd,bsd->bs", x, w[samples])
    if ins.get("Bias"):
        logits = logits + ins["Bias"][0].reshape(-1)[samples]
    shifted = logits - math.log(num_neg / num_total)
    lbl = (torch.arange(samples.shape[1], device=x.device) < num_true) \
        .to(x.dtype)[None]
    loss = -(lbl * F.logsigmoid(shifted) + (1 - lbl) * F.logsigmoid(-shifted))
    return {"Cost": [loss.sum(1, keepdim=True)], "SampleLogits": [logits],
            "SampleLabels": [samples]}


@register_op("hierarchical_sigmoid", nondiff_inputs=("Label", "PathTable",
                                                     "PathCode"))
def _hierarchical_sigmoid(ins, attrs, ctx):
    """hierarchical_sigmoid_op.cc over the default complete binary tree
    of ``num_classes`` leaves: a label's path is its code's bits, one
    sigmoid cost a bit.  ``PreOut`` is zeros, as the reference's."""
    x, w = ins["X"][0], ins["W"][0]                   # W [classes - 1, D]
    label = ins["Label"][0].long().reshape(-1)
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    num_classes = attrs.get("num_classes", w.shape[0] + 1)
    code_len = max(1, (int(num_classes) - 1).bit_length())
    code = label + num_classes
    losses = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for _ in range(code_len):
        parent = torch.div(code, 2, rounding_mode="floor")
        bit = (code % 2).to(x.dtype)
        idx = torch.clamp(parent - 1, 0, w.shape[0] - 1)
        valid = (parent >= 1) & (parent - 1 < w.shape[0])
        logit = (x * w[idx]).sum(-1)
        if bias is not None:
            logit = logit + bias[torch.clamp(idx, 0, bias.shape[0] - 1)]
        cost = -(bit * F.logsigmoid(logit) + (1 - bit) * F.logsigmoid(-logit))
        losses = losses + torch.where(valid, cost, 0.0)
        code = parent
    return {"Out": [losses.reshape(-1, 1)],
            "PreOut": [torch.zeros((x.shape[0], code_len), dtype=x.dtype,
                                   device=x.device)]}


@register_op("sample_logits", nondiff_inputs=("Labels", "CustomizedSamples",
                                              "CustomizedProbabilities"),
             stateful_rng=True)
def _sample_logits(ins, attrs, ctx):
    """sample_logits_op.cc with uniform samples: the logits of the true
    classes, then of ``num_samples`` drawn ones, less log(expected
    count) under ``uniq`` (the default)."""
    logits = ins["Logits"][0]
    label = ins["Labels"][0].long()
    num_samples = attrs.get("num_samples", 1)
    b, v = logits.shape
    neg = _uniform_ids(ctx, attrs, (b, num_samples), v, logits.device)
    samples = torch.cat([label, neg], dim=1)
    sampled = torch.gather(logits, 1, samples)
    prob = torch.full(samples.shape, 1.0 / v, dtype=logits.dtype,
                      device=logits.device)
    if attrs.get("uniq", True):
        sampled = sampled - torch.log(prob * num_samples + 1e-20)
    dev = logits.device
    return {"SampledLogits": [sampled],
            "SampledLabels": [torch.zeros((b, label.shape[1]),
                                          dtype=torch.long, device=dev)],
            "Samples": [samples], "Probabilities": [prob],
            "LogitsDim": [torch.tensor([b, v], device=dev)],
            "LabelsDim": [torch.tensor(list(label.shape), device=dev)]}


# --- text-matching convolutions ----------------------------------------------
@register_op("im2sequence")
def _im2sequence(ins, attrs, ctx):
    """im2sequence_op.cc: image [B, C, H, W] to patch rows
    [B · out_h · out_w, C · kh · kw], the features channel-major
    (C, kh, kw) as XLA's patches and ``F.unfold`` order them."""
    x = ins["X"][0]
    kh, kw = attrs.get("kernels", [1, 1])
    sh, sw = attrs.get("strides", [1, 1])
    ph0, pw0, ph1, pw1 = attrs.get("paddings", [0, 0, 0, 0])
    x = F.pad(x, (pw0, pw1, ph0, ph1))
    b, c = x.shape[:2]
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))  # [B, C·kh·kw, L]
    return {"Out": [patches.transpose(1, 2).reshape(-1, c * kh * kw)]}


@register_op("match_matrix_tensor", nondiff_inputs=("LengthX", "LengthY"))
def _match_matrix_tensor(ins, attrs, ctx):
    """match_matrix_tensor_op.cc, padded: X [B, Tx, D], Y [B, Ty, D] and
    W [D, dim_t, D] give the bilinear planes Out [B, dim_t, Tx, Ty]."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["W"][0]
    xw = torch.einsum("bxd,dte->bxte", x, w)
    return {"Out": [torch.einsum("bxte,bye->btxy", xw, y)], "Tmp": [xw]}


def _same_pads(size, k, s):
    """XLA's "SAME" split of one side's padding: (low, high)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


@register_op("var_conv_2d", nondiff_inputs=("ROW", "COLUMN"))
def _var_conv_2d(ins, attrs, ctx):
    """var_conv_2d_op.cc on a padded batch: one convolution with XLA's
    "SAME" padding (torch's ``padding="same"`` refuses a stride)."""
    x, w = ins["X"][0], ins["W"][0]
    oc = attrs.get("output_channel", w.shape[0])
    ic = attrs.get("input_channel", x.shape[1])
    kh, kw = attrs.get("kernel_h", 3), attrs.get("kernel_w", 3)
    sh, sw = attrs.get("stride_h", 1), attrs.get("stride_w", 1)
    h_lo, h_hi = _same_pads(x.shape[2], kh, sh)
    w_lo, w_hi = _same_pads(x.shape[3], kw, sw)
    out = F.conv2d(F.pad(x, (w_lo, w_hi, h_lo, h_hi)),
                   w.reshape(oc, ic, kh, kw), stride=(sh, sw))
    return {"Out": [out], "Col": [x]}


@register_op("tree_conv", nondiff_inputs=("EdgeSet",))
def _tree_conv(ins, attrs, ctx):
    """tree_conv_op.cc as the reference simplifies it: ``NodesVector``
    [B, N, D], ``EdgeSet`` [B, E, 2] of (parent, child), ``Filter`` read
    as [D, H, depth, out]; each node's own term and the mean of its
    children's, the maximum over H, then tanh.  An edge padded as (0, 0)
    makes node 0 its own child."""
    nodes = ins["NodesVector"][0]
    edges = ins["EdgeSet"][0].long()
    filt = ins["Filter"][0]
    d_in, h, depth, out_c = filt.shape
    b, n, _ = nodes.shape
    adj = torch.zeros((b, n, n), dtype=nodes.dtype, device=nodes.device)
    rows = torch.arange(b, device=nodes.device)[:, None] \
        .expand(edges.shape[:2])
    adj = adj.index_put((rows, edges[..., 0], edges[..., 1]),
                        torch.ones((), dtype=nodes.dtype, device=nodes.device))
    deg = torch.clamp(adj.sum(-1, keepdim=True), min=1.0)
    child_mean = (adj / deg) @ nodes
    w_self = filt[:, :, 0, :].reshape(d_in, h * out_c)
    w_child = filt[:, :, min(1, depth - 1), :].reshape(d_in, h * out_c)
    out = (nodes @ w_self + child_mean @ w_child).reshape(b, n, h, out_c)
    return {"Out": [torch.tanh(torch.amax(out, dim=2))]}
