"""Sequence op lowerings.

≙ paddle_tpu/ops/sequence_ops.py: `sequence_mask`, `sequence_pool`,
`sequence_last_step`, the unfused recurrent cells `dynamic_lstm` /
`dynamic_gru` / `dynamic_lstmp`, the single-step cells `lstm_unit` /
`gru_unit`, and the rest of the sequence library (`sequence_softmax`,
`_first_step`, `_reverse`, `_expand`, `_concat`, `_slice`, `_pad`,
`_erase`, `_reshape`, `edit_distance`, `sequence_conv`, `row_conv`).
A padded sequence travels as a dense [B, T, ...] tensor with
a companion length vector [B] (the static-shape translation of the
reference's LoD).

The unfused cells are Python loops over time on torch ops, differentiated
by autograd. They run what `fuse_recurrent_cell_pass` does not rewrite:
non-default activations (fusion/recurrent.py holds the fused cells and
their kernels), and every recurrent op when the `fuse_recurrent_cells` flag
is off on the CPU.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .tensor_ops import fill_value, index_in_range


@register_op("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    seqlen = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen")
    m = torch.arange(maxlen, device=seqlen.device)[None, :] < seqlen[:, None]
    return {"Y": [m.to(torch.float32)]}


def _mask(x, seqlen):
    """[B, T] validity mask broadcastable to x: [B, T, ...]."""
    b, t = x.shape[0], x.shape[1]
    m = torch.arange(t, device=x.device)[None, :] < seqlen[:, None]
    return m.reshape((b, t) + (1,) * (x.dim() - 2))


def _per_row(v, x):
    """[B] → [B, 1, ...] broadcastable against a pooled [B, ...] value."""
    return v.reshape((-1,) + (1,) * (x.dim() - 2))


def _last_step(x, seqlen):
    """≙ jnp.take_along_axis(x, max(seqlen - 1, 0), axis=1): a length past
    T yields a filled row, as jax's "fill" mode gives (ops/tensor_ops.py)."""
    idx, filled = index_in_range((seqlen - 1).clamp(min=0), x.shape[1])
    tail = (1,) * (x.dim() - 2)
    idx = idx.reshape((-1, 1) + tail).expand(
        (x.shape[0], 1) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx).squeeze(1).masked_fill(
        filled.reshape((-1,) + tail), fill_value(x.dtype))


@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    x = ins["X"][0]            # [B, T, D]
    seqlen = ins["SeqLen"][0]  # [B]
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    m = _mask(x, seqlen)
    if ptype == "SUM":
        out = (x * m.to(x.dtype)).sum(1)
    elif ptype == "AVERAGE":
        out = (x * m.to(x.dtype)).sum(1) / _per_row(
            seqlen.to(x.dtype).clamp(min=1), x)
    elif ptype == "SQRT":
        out = (x * m.to(x.dtype)).sum(1) / _per_row(
            seqlen.to(x.dtype).clamp(min=1).sqrt(), x)
    elif ptype == "MAX":
        # padded steps (and every step of an empty row) hold the dtype's
        # least value; amax splits the gradient among ties, as jnp.max
        neg = torch.finfo(x.dtype).min
        out = torch.where(m, x, torch.full_like(x, neg)).amax(1)
    elif ptype == "LAST":
        out = _last_step(x, seqlen)
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return {"Out": [out]}


@register_op("sequence_last_step")
def _sequence_last_step(ctx, ins, attrs):
    return {"Out": [_last_step(ins["X"][0], ins["SeqLen"][0])]}


# ---- recurrent cells over time (≙ lstm_op.cc / gru_op.cc) ----

ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
        "identity": lambda x: x}


def lstm_scan(x_proj, h0, c0, w_h, seqlen, gate_act, cell_act, cand_act,
              reverse=False):
    """x_proj: [B, T, 4H] input projections (i, f, c, o gate order as the
    reference's lstm_compute), w_h: [H, 4H]. Rows whose step lies beyond
    their length keep their state (≙ shrink_rnn_memory). Returns the
    hidden and cell sequences [B, T, H]."""
    t = x_proj.shape[1]
    hd = w_h.shape[0]
    if reverse:
        x_proj = torch.flip(x_proj, (1,))
    h, c = h0, c0
    hs, cs = [], []
    for it in range(t):
        gates = x_proj[:, it] + h @ w_h
        i, f, c_hat, o = gates.split(hd, dim=-1)
        i, f, o = gate_act(i), gate_act(f), gate_act(o)
        c_new = f * c + i * cand_act(c_hat)
        h_new = o * cell_act(c_new)
        tpos = t - 1 - it if reverse else it
        valid = (tpos < seqlen)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        hs.append(h)
        cs.append(c)
    hs, cs = torch.stack(hs, 1), torch.stack(cs, 1)
    if reverse:
        hs, cs = torch.flip(hs, (1,)), torch.flip(cs, (1,))
    return hs, cs


@register_op("dynamic_lstm")
def _dynamic_lstm(ctx, ins, attrs):
    """≙ lstm_op.cc: Input is the pre-projected [B, T, 4H] sequence (the fc
    is done by the layer). Weight: [H, 4H] hidden-to-hidden; Bias: [4H], or
    [7H] with use_peepholes, of which only the first 4H enter the gates, as
    in the JAX package (its other 3H get a zero gradient)."""
    x = ins["Input"][0]
    w = ins["Weight"][0]
    seqlen = ins["SeqLen"][0]
    h = w.shape[0]
    b = x.shape[0]
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(1, 1, -1)[:, :, :4 * h]
    h0 = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, h))
    c0 = ins["C0"][0] if ins.get("C0") else x.new_zeros((b, h))
    hs, cs = lstm_scan(x, h0, c0, w, seqlen,
                       ACTS[attrs.get("gate_activation", "sigmoid")],
                       ACTS[attrs.get("cell_activation", "tanh")],
                       ACTS[attrs.get("candidate_activation", "tanh")],
                       reverse=attrs.get("is_reverse", False))
    return {"Hidden": [hs], "Cell": [cs]}


@register_op("dynamic_gru")
def _dynamic_gru(ctx, ins, attrs):
    """≙ gru_op.cc: Input [B, T, 3H] pre-projected; Weight packs [H, 2H]
    reset/update and [H, H] candidate."""
    x = ins["Input"][0]
    w = ins["Weight"][0]  # [H, 3H]
    seqlen = ins["SeqLen"][0]
    h = w.shape[0]
    b = x.shape[0]
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(1, 1, -1)
    w_rz, w_c = w[:, :2 * h], w[:, 2 * h:]
    gate_act = ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = ACTS[attrs.get("activation", "tanh")]
    reverse = attrs.get("is_reverse", False)
    if reverse:
        x = torch.flip(x, (1,))
    t = x.shape[1]
    hp = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, h))
    hs = []
    for it in range(t):
        xt = x[:, it]
        rz = gate_act(xt[:, :2 * h] + hp @ w_rz)
        r, z = rz.split(h, dim=-1)
        c = cand_act(xt[:, 2 * h:] + (r * hp) @ w_c)
        h_new = z * hp + (1 - z) * c
        tpos = t - 1 - it if reverse else it
        hp = torch.where((tpos < seqlen)[:, None], h_new, hp)
        hs.append(hp)
    hs = torch.stack(hs, 1)
    if reverse:
        hs = torch.flip(hs, (1,))
    return {"Hidden": [hs]}


@register_op("dynamic_lstmp")
def _dynamic_lstmp(ctx, ins, attrs):
    """≙ lstmp_op.cc: the LSTM with a recurrent projection layer (unfused,
    as in the JAX package). Input [B, T, 4H] pre-projected; Weight [P, 4H]
    acts on the PROJECTED state; ProjWeight [H, P]. Emits Projection
    [B, T, P] and Cell [B, T, H]. With use_peepholes and a [7H] bias, the
    peephole weights w_ic / w_fc (on c_{t-1}) and w_oc (on c_t) enter the
    gates as in the reference. H0 is the hidden state [B, H]; it enters
    through the projection like every other step's."""
    x = ins["Input"][0]
    w = ins["Weight"][0]             # [P, 4H]
    w_proj = ins["ProjWeight"][0]    # [H, P]
    seqlen = ins["SeqLen"][0]
    h = w_proj.shape[0]
    b, t, _ = x.shape
    w_ic = w_fc = w_oc = None
    if ins.get("Bias"):
        flat = ins["Bias"][0].reshape(-1)
        x = x + flat[:4 * h].reshape(1, 1, -1)
        if attrs.get("use_peepholes", True) and flat.shape[0] == 7 * h:
            w_ic, w_fc, w_oc = flat[4 * h:5 * h], flat[5 * h:6 * h], \
                flat[6 * h:7 * h]
    gate_act = ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = ACTS[attrs.get("candidate_activation", "tanh")]
    proj_act = ACTS[attrs.get("proj_activation", "identity")]
    reverse = attrs.get("is_reverse", False)
    if reverse:
        x = torch.flip(x, (1,))
    r = (proj_act(ins["H0"][0] @ w_proj) if ins.get("H0")
         else x.new_zeros((b, w_proj.shape[1])))
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros((b, h))
    rs, cs = [], []
    for it in range(t):
        i, f, c_hat, o = (x[:, it] + r @ w).split(h, dim=-1)
        if w_ic is not None:
            i = i + w_ic * c
            f = f + w_fc * c
        c_new = gate_act(f) * c + gate_act(i) * cand_act(c_hat)
        if w_oc is not None:
            o = o + w_oc * c_new
        r_new = proj_act((gate_act(o) * cell_act(c_new)) @ w_proj)
        tpos = t - 1 - it if reverse else it
        valid = (tpos < seqlen)[:, None]
        r = torch.where(valid, r_new, r)
        c = torch.where(valid, c_new, c)
        rs.append(r)
        cs.append(c)
    rs, cs = torch.stack(rs, 1), torch.stack(cs, 1)
    if reverse:
        rs, cs = torch.flip(rs, (1,)), torch.flip(cs, (1,))
    return {"Projection": [rs], "Cell": [cs]}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """≙ lstm_unit_op.h:63-66: one LSTM cell step from pre-projected gates
    X [B, 4H] in the reference's (i, f, o, g) order, forget_bias added to
    f."""
    x = ins["X"][0]
    c_prev = ins["C_prev"][0]
    h = c_prev.shape[-1]
    i = torch.sigmoid(x[:, :h])
    f = torch.sigmoid(x[:, h:2 * h] + attrs.get("forget_bias", 0.0))
    o = torch.sigmoid(x[:, 2 * h:3 * h])
    new_c = c_prev * f + i * torch.tanh(x[:, 3 * h:])
    return {"C": [new_c], "H": [torch.tanh(new_c) * o]}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """≙ gru_unit_op.h: one GRU cell step. Input [B, 3H] (the update,
    reset and candidate input contributions), HiddenPrev [B, H], Weight
    [H, 3H], Bias [3H] optional; h = u·c + (1-u)·h_prev
    (gru_unit_op.h:116). Gate is (u, r, c) [B, 3H]."""
    x = ins["Input"][0]
    h_prev = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    h = h_prev.shape[-1]
    bias = ins["Bias"][0] if ins.get("Bias") else x.new_zeros((3 * h,))
    u = torch.sigmoid(x[:, :h] + h_prev @ w[:, :h] + bias[:h])
    r = torch.sigmoid(x[:, h:2 * h] + h_prev @ w[:, h:2 * h]
                      + bias[h:2 * h])
    c = torch.tanh(x[:, 2 * h:] + (r * h_prev) @ w[:, 2 * h:] + bias[2 * h:])
    return {"Hidden": [u * c + (1 - u) * h_prev],
            "Gate": [torch.cat([u, r, c], dim=-1)],
            "ResetHiddenPrev": [r * h_prev]}


# ---- the rest of the sequence library (≙ the JAX package's sequence_*,
# edit_distance, sequence_conv and row_conv over the padded layout)


@register_op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over each row's first length positions of X [B, T]; the
    rest are 0."""
    x = ins["X"][0]
    m = _mask(x, ins["SeqLen"][0])
    out = torch.softmax(torch.where(m, x, torch.finfo(x.dtype).min), dim=1)
    return {"Out": [out * m.to(x.dtype)]}


@register_op("sequence_first_step")
def _sequence_first_step(ctx, ins, attrs):
    return {"Out": [ins["X"][0][:, 0]]}


@register_op("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    """Each row's first length positions reversed; the padding stays."""
    x = ins["X"][0]
    seqlen = ins["SeqLen"][0].to(torch.long)
    t = x.shape[1]
    ar = torch.arange(t, device=x.device)[None, :]
    idx = torch.where(ar < seqlen[:, None], seqlen[:, None] - 1 - ar, ar)
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return {"Y": [x.gather(1, idx)]}


@register_op("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """X [B, ...] repeated over Y's T steps: [B, T, ...] (the JAX
    package's simplified reference semantics)."""
    x = ins["X"][0]
    t = ins["Y"][0].shape[1]
    return {"Out": [x.unsqueeze(1).repeat((1, t) + (1,) * (x.dim() - 1))]}


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    return {"Out": [torch.cat(ins["X"], dim=-1)]}


@register_op("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """`length` positions of each row from its Offset; a position outside
    [0, T) gives jax's fill (NaN for floats)."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1).to(torch.long)
    length = attrs.get("length", None)
    t = int(length) if length is not None else x.shape[1]
    idx, filled = index_in_range(
        offset[:, None] + torch.arange(t, device=x.device)[None, :],
        x.shape[1])
    tail = (1,) * (x.dim() - 2)
    idx = idx.reshape(idx.shape + tail).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))
    return {"Out": [x.gather(1, idx).masked_fill(
        filled.reshape(filled.shape + tail), fill_value(x.dtype))]}


@register_op("sequence_pad")
def _sequence_pad(ctx, ins, attrs):
    # already padded: X itself and its lengths
    return {"Out": [ins["X"][0]], "Length": [ins["SeqLen"][0]]}


@register_op("sequence_erase")
def _sequence_erase(ctx, ins, attrs):
    """The listed tokens set to 0 and masked out (Mask 0), not compacted:
    the shape stays static."""
    x = ins["X"][0]
    tokens = torch.as_tensor(list(attrs["tokens"]), dtype=x.dtype)
    keep = (x.unsqueeze(-1) != tokens.to(x.device)).all(-1)
    return {"Out": [torch.where(keep, x, 0)],
            "Mask": [keep.to(torch.int32)]}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    """≙ sequence_reshape_op.cc: [B, T, D] -> [B, T·D/new_dim, new_dim],
    each length scaled by D/new_dim (its divisibility is the caller's
    contract, as in the JAX package)."""
    from ..core.enforce import InvalidArgumentError, enforce
    x = ins["X"][0]
    new_dim = attrs["new_dim"]
    b, t, d = x.shape
    enforce((t * d) % new_dim == 0,
            f"sequence_reshape: T*D={t * d} not divisible by "
            f"new_dim={new_dim}", exc=InvalidArgumentError)
    return {"Out": [x.reshape(b, (t * d) // new_dim, new_dim)],
            "SeqLenOut": [ins["SeqLen"][0] * d // new_dim]}


@register_op("edit_distance")
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance of each (Hyps, Refs) pair over their lengths
    (≙ edit_distance_op.cc), optionally divided by the reference length.
    The DP runs one hypothesis position at a time for the whole batch;
    within a row, the insertion chain is a running minimum (cummin), so
    no loop runs over the reference positions."""
    hyp, ref = ins["Hyps"][0], ins["Refs"][0]
    hyp_len = ins["HypsLen"][0].reshape(-1).to(torch.long)
    ref_len = ins["RefsLen"][0].reshape(-1).to(torch.long)
    b, th = hyp.shape
    tr = ref.shape[1]
    j = torch.arange(tr, device=hyp.device, dtype=torch.float32)
    row = torch.arange(tr + 1, device=hyp.device,
                       dtype=torch.float32).expand(b, tr + 1)
    for i in range(th):
        sub = (ref != hyp[:, i:i + 1]).to(torch.float32)
        first = row[:, :1] + 1
        # deletion or substitution, then the insertion chain from the left
        a = torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)
        rest = torch.minimum(first + 1 + j, (a - j).cummin(1).values + j)
        new = torch.cat([first, rest], 1)
        row = torch.where((i < hyp_len)[:, None], new, row)
    dist = row.gather(1, ref_len.clamp(0, tr)[:, None])[:, 0]
    if attrs.get("normalized", False):
        dist = dist / ref_len.to(torch.float32).clamp(min=1)
    return {"Out": [dist[:, None]],
            "SequenceNum": [torch.full((), b, dtype=torch.int64,
                                       device=hyp.device)]}


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time (≙ sequence_conv_op.cc,
    math/context_project.h): each step's [contextLength] window of
    features, zero outside the sequence, flattened and multiplied by the
    filter [contextLength·D, M] (float32 accumulation)."""
    x = ins["X"][0]                 # [B, T, D]
    w = ins["Filter"][0]            # [ctx_len * D, M]
    t = x.shape[1]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -(ctx_len // 2)))
    m = _mask(x, ins["SeqLen"][0]).to(x.dtype)
    xm = x * m
    ar = torch.arange(t, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        valid = ((ar + off >= 0) & (ar + off < t))[None, :, None]
        cols.append(torch.where(valid, torch.roll(xm, -off, 1), 0))
    out = torch.matmul(torch.cat(cols, -1).float(), w.float())
    return {"Out": [out.to(x.dtype) * m]}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """≙ row_conv_op.cc (DeepSpeech2's lookahead convolution): out[t] =
    Σ_i w[i] · x[t+i], zero past T. X [B, T, D], Filter [k, D]."""
    x = ins["X"][0]
    w = ins["Filter"][0]
    t = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(w.shape[0]):
        shifted = torch.nn.functional.pad(x, (0, 0, 0, i))[:, i:i + t]
        out = out + shifted * w[i][None, None, :]
    return {"Out": [out]}
