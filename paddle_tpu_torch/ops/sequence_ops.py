"""Sequence op lowerings.

≙ paddle_tpu/ops/sequence_ops.py, trimmed to the ops the padded LM batch
and the recurrent models run: `sequence_mask`, `sequence_pool`,
`sequence_last_step` and the unfused recurrent cells `dynamic_lstm` /
`dynamic_gru`. A padded sequence travels as a dense [B, T, ...] tensor with
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
