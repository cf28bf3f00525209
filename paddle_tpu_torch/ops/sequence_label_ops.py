"""Sequence-labelling ops: the CTC loss and alignment, the linear-chain
CRF, its Viterbi decoding and chunk evaluation.

≙ paddle_tpu/ops/sequence_label_ops.py (reference operators/warpctc_op.*,
ctc_align_op.*, linear_chain_crf_op.*, crf_decoding_op.*,
chunk_eval_op.*). A batch is
dense-padded [B, T, ...] with a length vector [B], as everywhere in the
port. The dynamic programs are Python loops over the static T on torch
ops, masked past each row's length on the device, so no length is read
on the host; autograd differentiates the CTC and CRF forward algorithms, as jax
autodiff does in the JAX package (the reference ships hand-derived
backwards).

Indexing follows the JAX package's modes: a label read through
`take_along_axis` outside [0, D) gives NaN (jax's fill mode), and a label
indexing the transition or start / end rows is clamped into range (jax's
gather clamps), negative labels counting from the end first.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .tensor_ops import index_in_range, take_along

# log-space zero of the CTC forward algorithm: an alignment the label
# cannot have (a label longer than the input allows) gives a loss of about
# 1e30 with finite gradients, not inf or NaN (torch's ctc_loss gives inf)
_NEG_INF = -1e30


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    dead = m <= _NEG_INF / 2
    m_safe = torch.where(dead, 0.0, m)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe)
    # double where: the dead branch must never take log(0), whose gradient
    # inf * 0 = NaN would reach the inputs though `where` drops the value
    out = m_safe + torch.log(torch.where(dead, 1.0, s))
    return torch.where(dead, _NEG_INF, out)


def _shift(a, k):
    """a [B, S] moved k states right, the first k filled with _NEG_INF."""
    return torch.cat([torch.full_like(a[:, :k], _NEG_INF), a[:, :-k]], 1)


@register_op("warpctc")
def _warpctc(ctx, ins, attrs):
    """CTC loss (≙ warpctc_op.cc, which wraps libwarpctc). Logits [B, T, C]
    unnormalized, Label [B, L], LogitsLength [B], LabelLength [B]; attrs
    `blank` (default 0) and `norm_by_times`. Loss [B, 1] = -log p(label |
    logits) by the log-space forward algorithm over the extended label
    (blank, l1, blank, ..., lL, blank), a loop over T on the device (a row
    past its length keeps its state); autograd gives the soft-alignment
    gradient warpctc computes by hand."""
    logits = ins["Logits"][0]
    label = ins["Label"][0].to(torch.long)
    logit_len = ins["LogitsLength"][0].reshape(-1).to(torch.long)
    label_len = ins["LabelLength"][0].reshape(-1).to(torch.long)
    blank = attrs.get("blank", 0)
    b, t, _ = logits.shape
    s = 2 * label.shape[1] + 1
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)
    ext = torch.full((b, s), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = label
    ext_m2 = torch.cat([torch.full_like(ext[:, :2], blank), ext[:, :-2]], 1)
    allow_skip = (torch.arange(s, device=dev)[None] >= 2) & \
        (ext != blank) & (ext != ext_m2)
    # every step's emissions in one gather (NaN where a label is out of
    # range, as take_along_axis fills)
    emit = take_along(logp, ext[:, None, :].expand(b, t, s), 2)
    neg = torch.full((b, 1), _NEG_INF, dtype=logp.dtype, device=dev)
    first = [emit[:, 0, :1]]
    if s > 1:
        first.append(torch.where(label_len[:, None] > 0, emit[:, 0, 1:2],
                                 neg))
    alpha = torch.cat(first + [neg.expand(b, s - len(first))], 1)
    for step in range(1, t):
        a2 = torch.where(allow_skip, _shift(alpha, 2), _NEG_INF)
        new = _logsumexp2(_logsumexp2(alpha, _shift(alpha, 1)), a2) \
            + emit[:, step]
        alpha = torch.where((step < logit_len)[:, None], new, alpha)
    s_end = 2 * label_len                         # the final blank
    last_blank = take_along(alpha, s_end[:, None], 1)[:, 0]
    last_label = torch.where(
        label_len > 0,
        take_along(alpha, torch.clamp_min(s_end - 1, 0)[:, None], 1)[:, 0],
        _NEG_INF)
    loss = -_logsumexp2(last_blank, last_label)
    if attrs.get("norm_by_times"):
        loss = loss / torch.clamp_min(logit_len.to(loss.dtype), 1)
    return {"Loss": [loss.reshape(-1, 1)]}


@register_op("ctc_align")
def _ctc_align(ctx, ins, attrs):
    """≙ ctc_align_op.cc: repeated tokens merged, then blanks dropped.
    Input [B, T] + InputLength [B]; Output [B, T] left-packed and padded
    with `padding_value`, OutputLength [B, 1]."""
    x = ins["Input"][0]
    xl = x.to(torch.long)
    xlen = ins["InputLength"][0].reshape(-1).to(torch.long)
    blank = attrs.get("blank", 0)
    b, t = x.shape
    dev = x.device
    t_idx = torch.arange(t, device=dev)[None]
    prev = torch.cat([torch.full_like(xl[:, :1], -1), xl[:, :-1]], 1)
    keep = (t_idx < xlen[:, None]) & (xl != blank) & (xl != prev)
    pos = torch.cumsum(keep.to(torch.long), 1) - 1
    out_len = torch.where(keep, pos + 1, 0).amax(1)
    # each kept token to its packed slot, the dropped ones to slot t
    out = torch.zeros((b, t + 1), dtype=torch.long, device=dev).scatter(
        1, torch.where(keep, pos, t), xl)[:, :t]
    out = torch.where(t_idx < out_len[:, None], out,
                      attrs.get("padding_value", 0))
    return {"Output": [out.to(x.dtype)],
            "OutputLength": [out_len.reshape(-1, 1)]}


def _crf_unpack(transition):
    """Reference layout (linear_chain_crf_op.h): row 0 the start weights,
    row 1 the end weights, rows 2..D+1 the [D, D] transition matrix."""
    return transition[0], transition[1], transition[2:]


def _labels(ins, slot):
    label = ins[slot][0]
    if label.dim() == 3:
        label = label[..., 0]
    return label.to(torch.long)


def _clamped(idx, n):
    return index_in_range(idx, n)[0]


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    """≙ linear_chain_crf_op.cc. Emission [B, T, D], Transition [D+2, D],
    Label [B, T], Length [B]. LogLikelihood [B, 1] = logZ - score, the
    negative log-likelihood the reference minimizes; Alpha [B, D] the
    forward algorithm's last log-space column; EmissionExps /
    TransitionExps exp of the inputs (made only when read)."""
    emission = ins["Emission"][0]                        # [B, T, D]
    transition = ins["Transition"][0]                    # [D+2, D]
    label = _labels(ins, "Label")                        # [B, T]
    length = ins["Length"][0].reshape(-1).to(torch.long)
    b, t, d = emission.shape
    start_w, end_w, trans = _crf_unpack(transition)
    dev = emission.device

    # the partition function: the forward algorithm over time
    alpha = start_w[None, :] + emission[:, 0, :]         # [B, D]
    for step in range(1, t):
        new = torch.logsumexp(alpha[:, :, None] + trans[None, :, :], dim=1) \
            + emission[:, step, :]
        alpha = torch.where((step < length)[:, None], new, alpha)
    logz = torch.logsumexp(alpha + end_w[None, :], dim=1)   # [B]

    # the gold path's score
    t_idx = torch.arange(t, device=dev)[None, :]
    in_seq = t_idx < length[:, None]                     # [B, T]
    lab, filled = index_in_range(label, d)
    emit = emission.gather(2, lab[:, :, None])[:, :, 0].masked_fill(
        filled, float("nan"))
    emit_sum = torch.where(in_seq, emit, 0.0).sum(1)
    lab_c = _clamped(label, d)
    trans_scores = trans[lab_c[:, :-1], lab_c[:, 1:]]     # [B, T-1]
    trans_sum = torch.where(t_idx[:, 1:] < length[:, None], trans_scores,
                            0.0).sum(1)
    last_idx, last_filled = index_in_range(
        (length - 1).clamp(min=0)[:, None], t)
    last = label.gather(1, last_idx)[:, 0]
    # a length past T reads jax's fill for int32, the least value, which
    # the clamp below sends to row 0
    last = torch.where(last_filled[:, 0], torch.iinfo(torch.int32).min, last)
    score = start_w[_clamped(label[:, 0], d)] + emit_sum + trans_sum \
        + end_w[_clamped(last, d)]
    out = {"LogLikelihood": [(logz - score).reshape(-1, 1)],
           "Alpha": [alpha]}
    names = ctx.op.outputs if ctx.op is not None else {}
    for slot, x in (("EmissionExps", emission),
                    ("TransitionExps", transition)):
        if ctx.op is None or any(ctx.needed(n) for n in names.get(slot, ())):
            out[slot] = [torch.exp(x)]
    return out


@register_op("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    """≙ crf_decoding_op.cc: Viterbi decoding, the first tag among equal
    scores (argmax's rule in both libraries). With Label given, the output
    marks the positions whose decoded tag equals the label (1/0), as the
    reference kernel (crf_decoding_op.h); past each length it is 0."""
    emission = ins["Emission"][0]                        # [B, T, D]
    transition = ins["Transition"][0]
    length = ins["Length"][0].reshape(-1).to(torch.long)
    b, t, d = emission.shape
    start_w, end_w, trans = _crf_unpack(transition)
    dev = emission.device
    ident = torch.arange(d, device=dev)[None, :].expand(b, d)

    v = start_w[None, :] + emission[:, 0, :]             # [B, D]
    bps = []
    for step in range(1, t):
        scores = v[:, :, None] + trans[None, :, :]       # [B, D, D]
        best, best_prev = scores.max(dim=1)
        active = (step < length)[:, None]
        v = torch.where(active, best + emission[:, step, :], v)
        # an inactive step records identity back-pointers
        bps.append(torch.where(active, best_prev, ident))
    tag = torch.argmax(v + end_w[None, :], dim=1)        # [B]
    path = [tag]
    for bp in reversed(bps):
        tag = bp.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], 1)                     # [B, T]
    in_seq = torch.arange(t, device=dev)[None, :] < length[:, None]
    path = torch.where(in_seq, path, 0)
    if ins.get("Label"):
        ok = (path == _labels(ins, "Label")) & in_seq
        return {"ViterbiPath": [ok.to(torch.int64)]}
    return {"ViterbiPath": [path.to(torch.int64)]}


# scheme: (num_tag_types, begin, inside, end, single); -1 = absent
_SCHEMES = {
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, 0),
}


def _shift_prev(a, fill):
    return torch.cat([torch.full_like(a[:, :1], fill), a[:, :-1]], 1)


def _shift_next(a, fill):
    return torch.cat([a[:, 1:], torch.full_like(a[:, :1], fill)], 1)


def _chunk_bounds(tag, typ, is_other, scheme):
    """is_begin[b, t] / is_end[b, t] by the reference's ChunkBegin /
    ChunkEnd (chunk_eval_op.h); positions outside the sequence are
    'other'."""
    _, t_begin, _, t_end, t_single = _SCHEMES[scheme]
    prev_tag, prev_typ = _shift_prev(tag, -1), _shift_prev(typ, -1)
    prev_other = _shift_prev(is_other, True)
    next_tag, next_typ = _shift_next(tag, -1), _shift_next(typ, -1)
    next_other = _shift_next(is_other, True)
    # ChunkBegin(prev, cur): cur not other AND (prev other, or a type
    # change, or cur is B/S, or prev was E/S)
    begin = ~is_other & (
        prev_other | (typ != prev_typ)
        | (tag == t_begin) | (tag == t_single)
        | ((prev_tag == t_end) & ~prev_other)
        | ((prev_tag == t_single) & ~prev_other))
    # ChunkEnd(cur, next): cur not other AND (next other, or a type
    # change, or cur is E/S, or next is B/S)
    end = ~is_other & (
        next_other | (typ != next_typ)
        | (tag == t_end) | (tag == t_single)
        | ((next_tag == t_begin) & ~next_other)
        | ((next_tag == t_single) & ~next_other))
    return begin, end


def _next_end_index(is_end, t):
    """next_end[b, t] = the least t' >= t with is_end[b, t'], else T."""
    idx = torch.where(is_end, torch.arange(t, device=is_end.device)[None, :],
                      t)
    return idx.flip(1).cummin(1).values.flip(1)


@register_op("chunk_eval")
def _chunk_eval(ctx, ins, attrs):
    """≙ chunk_eval_op.cc: precision, recall and F1 of chunk detection.
    Inference [B, T], Label [B, T], Length [B]; attrs num_chunk_types,
    chunk_scheme (IOB / IOE / IOBES / plain), excluded_chunk_types. A tag
    is chunk_type * num_tag_types + tag_type; anything outside
    [0, num_chunk_types * num_tag_types), an excluded type or a position
    past the length is 'other' (O)."""
    inference = _labels(ins, "Inference")
    label = _labels(ins, "Label")
    length = ins["Length"][0].reshape(-1).to(torch.long)
    scheme = attrs.get("chunk_scheme", "IOB")
    num_chunk_types = attrs["num_chunk_types"]
    excluded = tuple(attrs.get("excluded_chunk_types", ()) or ())
    num_tag = _SCHEMES[scheme][0]
    t = label.shape[1]
    in_seq = torch.arange(t, device=label.device)[None, :] < length[:, None]

    def analyze(tags):
        typ = tags // num_tag
        other = ~in_seq | (tags < 0) | (typ >= num_chunk_types)
        for ex in excluded:
            other = other | (typ == ex)
        begin, end = _chunk_bounds(
            torch.where(other, -1, tags % num_tag),
            torch.where(other, -1, typ), other, scheme)
        return typ, begin & in_seq, end & in_seq

    i_typ, i_beg, i_end = analyze(inference)
    l_typ, l_beg, l_end = analyze(label)
    num_infer = i_beg.sum()
    num_label = l_beg.sum()
    correct = (i_beg & l_beg & (i_typ == l_typ)
               & (_next_end_index(i_end, t) == _next_end_index(l_end, t)))
    num_correct = correct.sum()
    ni, nl, nc = (n.to(torch.float32) for n in (num_infer, num_label,
                                                num_correct))
    precision = torch.where(ni > 0, nc / ni.clamp(min=1), 0.0)
    recall = torch.where(nl > 0, nc / nl.clamp(min=1), 0.0)
    f1 = torch.where(nc > 0, 2 * precision * recall
                     / (precision + recall).clamp(min=1e-12), 0.0)
    return {"Precision": [precision.reshape(1)],
            "Recall": [recall.reshape(1)],
            "F1-Score": [f1.reshape(1)],
            "NumInferChunks": [num_infer.to(torch.int64).reshape(1)],
            "NumLabelChunks": [num_label.to(torch.int64).reshape(1)],
            "NumCorrectChunks": [num_correct.to(torch.int64).reshape(1)]}
