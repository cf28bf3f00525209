"""Fused recurrent cells: the whole LSTM / GRU recurrence in one kernel.

≙ paddle_tpu/fusion/recurrent.py. `fuse_recurrent_cell_pass`
(framework/passes.py) rewrites `dynamic_lstm` / `dynamic_gru` with the
default activations into `fused_lstm` / `fused_gru`, which lower here. The
[B, T, G·H] input projections are computed outside (one large matmul, the
layer's fc); what the kernel fuses is everything the unfused loop runs per
step: the recurrent matmul, the gate activations, the state update and the
sequence-length freeze.

The pieces, as for every kernel of the port:

- `lstm_seq_cuda` / `gru_seq_cuda` — wrappers of the hand-written CUDA
  kernels (csrc/recurrent.cu, replacing the Pallas kernels
  `paddle_tpu/fusion/recurrent.py:_lstm_seq_kernel` and `_gru_seq_kernel`).
  They check devices, types and shapes, launch on the current stream and
  count the launch in `kernels.LAUNCHES["lstm_seq"]` / `["gru_seq"]`. Any
  H: the kernel's plan (`recurrent_plan`) says how many units a block owns
  and whether its gate columns of w fit shared memory; where they do not,
  the wrapper passes a copy of w laid out block by block (`relay_w`),
  which the kernel reads through L2.
- `lstm_seq_plain` / `gru_seq_plain` — the same functions in plain
  PyTorch, a loop over time (≙ `_xla_lstm_seq`, `_xla_gru_seq`), stash
  included.
- `_FusedLSTM` / `_FusedGRU` — autograd functions whose backward is the
  JAX package's manual reverse-time scan against the stashed gate
  activations (`_fused_lstm_bwd`, `_fused_gru_bwd`). That backward was
  never a Pallas kernel, so it is plain PyTorch here too.
- `fused_lstm_sequence` / `fused_gru_sequence` — pick by device (the plain
  version for CPU tensors only; CUDA tensors launch the kernel or raise)
  and by whether a gradient is wanted: the stash is written only then.

Gate orders match ops/sequence_ops.py: LSTM (i, f, c^, o) on a [H, 4H]
recurrent weight, GRU (r, z | c) on [H, 3H]. A row freezes its state at
steps at or beyond its length; a row of length 0 keeps h0 (and c0)
throughout. `reverse` flips x outside and computes `tpos = T-1-t` inside,
as the JAX package does.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..framework.registry import register_op

#: the element types the kernels take, by their type code
#: (csrc/recurrent.cu kF32 / kBF16): x, w, the states and the outputs share
#: one
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain PyTorch versions (≙ _xla_lstm_seq / _xla_gru_seq)
# ---------------------------------------------------------------------------


def lstm_cell(xt, h, c, w):
    """One LSTM step in the operands' type, every op rounding to it as the
    composite's scan body does: xt [..., 4H], h/c [..., H], w [H, 4H] →
    (i, f, c^, o, c_new, h_new). Any leading dims: `lstm_step_check`
    evaluates every step at once from given states."""
    hd = w.shape[0]
    gates = xt + h @ w
    i, f, g, o = gates.split(hd, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c + i * g
    return i, f, g, o, c_new, o * torch.tanh(c_new)


def gru_cell(xt, h, w):
    """One GRU step as `lstm_cell`: xt [..., 3H], h [..., H], w [H, 3H] →
    (r, z, c, h_new)."""
    hd = w.shape[0]
    rz = torch.sigmoid(xt[..., :2 * hd] + h @ w[:, :2 * hd])
    r, z = rz.split(hd, dim=-1)
    c = torch.tanh(xt[..., 2 * hd:] + (r * h) @ w[:, 2 * hd:])
    return r, z, c, z * h + (1 - z) * c


def lstm_seq_plain(x, h0, c0, w, seqlen, reverse, with_stash):
    """x [B, T, 4H] (already flipped when `reverse`), h0/c0 [B, H], w
    [H, 4H], seqlen [B] → (hs, cs[, stash]): [B, T, H] each, stash
    [B, T, 4H] of the gate activations (i, f, c^, o)."""
    t = x.shape[1]
    h, c = h0, c0
    hs, cs, stash = [], [], []
    for it in range(t):
        i, f, g, o, c_new, h_new = lstm_cell(x[:, it], h, c, w)
        tpos = t - 1 - it if reverse else it
        valid = (tpos < seqlen)[:, None]
        h = torch.where(valid, h_new, h)
        c = torch.where(valid, c_new, c)
        hs.append(h)
        cs.append(c)
        if with_stash:
            stash.append(torch.cat([i, f, g, o], dim=-1))
    out = (torch.stack(hs, 1), torch.stack(cs, 1))
    if with_stash:
        out = out + (torch.stack(stash, 1),)
    return out


def gru_seq_plain(x, h0, w, seqlen, reverse, with_stash):
    """x [B, T, 3H] (already flipped when `reverse`), h0 [B, H], w
    [H, 3H] → (hs[, stash]): hs [B, T, H], stash [B, T, 3H] of (r, z, c)."""
    t = x.shape[1]
    h = h0
    hs, stash = [], []
    for it in range(t):
        r, z, c, h_new = gru_cell(x[:, it], h, w)
        tpos = t - 1 - it if reverse else it
        h = torch.where((tpos < seqlen)[:, None], h_new, h)
        hs.append(h)
        if with_stash:
            stash.append(torch.cat([r, z, c], dim=-1))
    out = (torch.stack(hs, 1),)
    if with_stash:
        out = out + (torch.stack(stash, 1),)
    return out


# ---------------------------------------------------------------------------
# bfloat16: one step against the plain version, a slack per rounded term
# ---------------------------------------------------------------------------

#: bfloat16's unit roundoff: rounding to nearest moves a value by at most
#: this much of its size
BF16_U = 2.0 ** -8
_F32_ULP = 2.0 ** -23


def _prev_states(hs, init):
    """[B, T, H] outputs → the state each step started from."""
    return torch.cat([init[:, None], hs[:, :-1]], 1)


def _step_valid(seqlen, t, reverse):
    return _valid_mask(seqlen, t, reverse)[:, :, None]


def lstm_step_slack(x, hprev, cprev, w, kernel=True):
    """(slack_h, slack_c, slack_stash), float32 like h, c and the stash:
    how far one bfloat16 step of `lstm_cell` from (hprev, cprev) may be from
    the exact step (each rounded term of the plain version's step moves its
    value by at most BF16_U of its size, carried through the derivatives
    that follow: sigmoid' <= 1/4, tanh' <= 1, and the products' other
    factors), plus, with `kernel`, what K5 adds (it keeps float32 inside a
    step and rounds the new c and h: BF16_U of each, and tanh's slope on
    c's rounding) and both products' float32 sums over H in another order
    (H·2⁻²³ of Σ|h||w|). Two per-op rounded versions (the plain one and
    the JAX composite) differ by twice the plain version's terms:
    `kernel=False` gives one of them."""
    f = torch.float32
    u = BF16_U
    hd = w.shape[0]
    xf, hp, cp, wf = (a.to(f) for a in (x, hprev, cprev, w))
    d = hp @ wf
    a = xf + d
    acc = hd * _F32_ULP * (hp.abs() @ wf.abs())
    da = u * (d.abs() + a.abs()) + acc          # the dot's and the add's
    ai, af, ag, ao = a.split(hd, -1)
    dai, daf, dag, dao = da.split(hd, -1)
    i, f_, o = torch.sigmoid(ai), torch.sigmoid(af), torch.sigmoid(ao)
    g = torch.tanh(ag)
    di, df, do = (u * s.abs() + e / 4 for s, e in ((i, dai), (f_, daf),
                                                   (o, dao)))
    dg = u * g.abs() + dag
    fc, ig = f_ * cp, i * g
    c = fc + ig
    dc = (u * (fc.abs() + ig.abs() + c.abs()) + df * cp.abs()
          + di * g.abs() + dg * i.abs())
    tc = torch.tanh(c)
    h = o * tc
    dtc = u * tc.abs() + dc
    dh = u * h.abs() + do * tc.abs() + o.abs() * dtc
    dst = torch.cat([di, df, dg, do], -1)
    if kernel:
        dc = dc + u * c.abs()
        dh = dh + u * h.abs() + o.abs() * u * c.abs()
        dst = dst + u * torch.cat([i, f_, g, o], -1).abs()
    return dh, dc, dst


def gru_step_slack(x, hprev, w, kernel=True):
    """(slack_h, slack_stash) of one bfloat16 `gru_cell` step from hprev,
    as `lstm_step_slack` says. K6 rounds only the new h (and writes the
    stash's gates rounded once); r h stays float32 in it."""
    f = torch.float32
    u = BF16_U
    hd = w.shape[0]
    xf, hp, wf = (a.to(f) for a in (x, hprev, w))
    w_rz, w_c = wf[:, :2 * hd], wf[:, 2 * hd:]
    d_rz = hp @ w_rz
    a_rz = xf[..., :2 * hd] + d_rz
    da_rz = (u * (d_rz.abs() + a_rz.abs())
             + hd * _F32_ULP * (hp.abs() @ w_rz.abs()))
    rz = torch.sigmoid(a_rz)
    drz = u * rz.abs() + da_rz / 4
    r, z = rz.split(hd, -1)
    dr, dz = drz.split(hd, -1)
    rh = r * hp
    drh = u * rh.abs() + dr * hp.abs()
    d_c = rh @ w_c
    a_c = xf[..., 2 * hd:] + d_c
    da_c = (u * (d_c.abs() + a_c.abs()) + drh @ w_c.abs()
            + hd * _F32_ULP * (rh.abs() @ w_c.abs()))
    c = torch.tanh(a_c)
    dc = u * c.abs() + da_c
    zh, omz = z * hp, 1 - z
    h = zh + omz * c
    dh = (u * (zh.abs() + omz.abs() + (omz * c).abs() + h.abs())
          + dz * (hp.abs() + c.abs()) + omz.abs() * dc)
    dst = torch.cat([dr, dz, dc], -1)
    if kernel:
        dh = dh + u * h.abs()
        dst = dst + u * torch.cat([r, z, c], -1).abs()
    return dh, dst


def recurrent_step_check(kind, x, h0, c0, w, seqlen, reverse, outs,
                         kernel=True):
    """Hold bfloat16 outputs (hs, cs[, stash]) or (hs[, stash]) of K5 / K6
    (or, `kernel=False`, of another per-op rounded version) step by step
    against the plain version: every step of the plain cell is evaluated
    at once from the states `outs` carried into it (so an error neither
    hides in nor grows with T), and each output must lie within the
    step's per-term slack of it (`lstm_step_slack` / `gru_step_slack`);
    frozen steps must keep the carried state exactly. Returns (ok, max
    abs error, largest error / slack)."""
    t = x.shape[1]
    valid = _step_valid(seqlen, t, reverse)
    worst, ratio, ok = 0.0, 0.0, True
    if kind == "lstm":
        hp, cp = _prev_states(outs[0], h0), _prev_states(outs[1], c0)
        i, f_, g, o, c_new, h_new = lstm_cell(x, hp, cp, w)
        refs = [torch.where(valid, h_new, hp), torch.where(valid, c_new, cp),
                torch.cat([i, f_, g, o], -1)]
        slacks = lstm_step_slack(x, hp, cp, w, kernel)
    else:
        hp = _prev_states(outs[0], h0)
        r, z, c, h_new = gru_cell(x, hp, w)
        refs = [torch.where(valid, h_new, hp), torch.cat([r, z, c], -1)]
        slacks = gru_step_slack(x, hp, w, kernel)
    for n, (out, ref, slack) in enumerate(zip(outs, refs, slacks)):
        err = (out.float() - ref.float()).abs()
        if n < (2 if kind == "lstm" else 1):
            # a frozen step keeps the state it was given, exactly
            slack = torch.where(valid, slack, torch.zeros_like(slack))
        worst = max(worst, float(err.max()))
        ratio = max(ratio, float((err / slack.clamp_min(1e-30)).max()))
        ok = ok and bool((err <= slack).all())
    return ok, worst, ratio


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _bind(lib):
    if getattr(lib, "_ptt_bound", False):
        return
    c_int, c_vp = ctypes.c_int, ctypes.c_void_p
    lib.ptt_lstm_seq.argtypes = [c_vp] * 6 + [c_int] * 5 + [c_vp] * 6
    lib.ptt_lstm_seq.restype = c_int
    lib.ptt_gru_seq.argtypes = [c_vp] * 5 + [c_int] * 5 + [c_vp] * 5
    lib.ptt_gru_seq.restype = c_int
    lib.ptt_recurrent_plan.argtypes = [c_int] * 3 + [c_vp]
    lib.ptt_recurrent_plan.restype = c_int
    lib._ptt_bound = True


_PLANS = {}


def recurrent_plan(kind, b, hd, device):
    """How the "lstm" or "gru" kernel covers `hd` hidden units for `b` rows
    on `device` (csrc/recurrent.cu ptt_recurrent_plan): {"ug": units a
    column group, "groups": column groups a block, "blocks", "stream_w":
    w read from `relay_w`'s copy, "smem": dynamic shared memory bytes,
    "hp": row stride of the h buffer}."""
    key = (kind, b, hd, torch.device(device).index)
    plan = _PLANS.get(key)
    if plan is None:
        lib = kernels.load("recurrent")
        _bind(lib)
        out = (ctypes.c_int * 6)()
        with torch.cuda.device(device):
            err = lib.ptt_recurrent_plan(int(kind == "gru"), b, hd, out)
        kernels.check(lib, f"{kind}_seq plan", err)
        plan = dict(zip(("ug", "groups", "blocks", "stream_w", "smem", "hp"),
                        out))
        _PLANS[key] = plan
    return plan


def relay_w(w, n_gates, ug, groups, blocks, hp):
    """w [H, G·H] laid out for the kernels' blocks: [blocks, groups, hp,
    G·ug], where block g's column group c holds at [k, gate·ug + u] the
    weight w[k, gate·H + j] of unit j = (g·groups + c)·ug + u, and zeros for
    k or j at or past H (hp >= H rounds the rows up)."""
    hd = w.shape[0]
    wp = w.new_zeros((hp, n_gates, blocks * groups * ug))
    wp[:hd, :, :hd] = w.reshape(hd, n_gates, hd)
    return wp.reshape(hp, n_gates, blocks, groups, ug).permute(
        2, 3, 0, 1, 4).reshape(blocks, groups, hp, n_gates * ug).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _w_rel(plan, w, n_gates):
    """The float32 relaid copy of w where the plan streams w (the kernels
    read it as float32 in either type), else None."""
    if not plan["stream_w"]:
        return None
    return relay_w(w.float(), n_gates, plan["ug"], plan["groups"], plan["blocks"],
                   plan["hp"])


def _check_args(name, n_gates, x, states, w, seqlen):
    """Shapes, devices and types the kernels take; returns (B, T, H)."""
    b, t, gh = x.shape
    hd = w.shape[0]
    dev = x.device
    if dev.type != "cuda" or any(a.device != dev
                                 for a in (w, seqlen, *states)):
        raise ValueError(f"{name}: every tensor must be on the same CUDA "
                         f"device")
    if x.dtype not in _TYPE_CODES or any(a.dtype != x.dtype
                                         for a in (w, *states)):
        raise TypeError(f"{name}: x, w and the states must share one type "
                        f"of float32 or bfloat16, not "
                        f"{[str(a.dtype) for a in (x, w, *states)]}")
    if tuple(w.shape) != (hd, n_gates * hd) or gh != n_gates * hd or \
            any(tuple(s.shape) != (b, hd) for s in states) or \
            tuple(seqlen.shape) != (b,):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)} w "
                         f"{tuple(w.shape)} states "
                         f"{[tuple(s.shape) for s in states]} seqlen "
                         f"{tuple(seqlen.shape)} do not agree")
    if seqlen.is_floating_point():
        raise TypeError(f"{name}: seqlen must be an integer tensor")
    if min(b, t, hd) < 1:
        raise ValueError(f"{name}: empty shape {tuple(x.shape)}")
    return b, t, hd


def lstm_seq_cuda(x, h0, c0, w, seqlen, reverse, with_stash):
    """Launch the LSTM kernel: x [B, T, 4H] (already flipped when
    `reverse`), h0/c0 [B, H], w [H, 4H], all float32 or all bfloat16,
    seqlen [B] of any integer type. Returns (hs, cs[, stash]) in x's type
    as `lstm_seq_plain`; in bfloat16 h and c are rounded at every step, as
    the composite's carry is. Raises on another type and on shapes that
    disagree."""
    b, t, hd = _check_args("lstm_seq_cuda", 4, x, (h0, c0), w, seqlen)
    lib = kernels.load("recurrent")
    _bind(lib)
    dev = x.device
    plan = recurrent_plan("lstm", b, hd, dev)
    with torch.cuda.device(dev):
        x, h0, c0, w = (a.contiguous() for a in (x, h0, c0, w))
        w_rel = _w_rel(plan, w, 4)
        sl = seqlen.to(torch.int32).contiguous()
        hs = torch.empty((b, t, hd), dtype=x.dtype, device=dev)
        cs = torch.empty_like(hs)
        stash = (torch.empty((b, t, 4 * hd), dtype=x.dtype,
                             device=dev) if with_stash else None)
        # columns hd..hp-1 of each row stay zero: the kernel reads them
        hbuf = torch.zeros((2, b, plan["hp"]), dtype=torch.float32,
                           device=dev)
        arrived = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.ptt_lstm_seq(
            x.data_ptr(), w.data_ptr(), _ptr(w_rel), h0.data_ptr(),
            c0.data_ptr(), sl.data_ptr(), b, t, hd, int(bool(reverse)),
            _TYPE_CODES[x.dtype], hs.data_ptr(), cs.data_ptr(), _ptr(stash), hbuf.data_ptr(),
            arrived.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(lib, "lstm_seq", err)
    kernels.count_launch("lstm_seq")
    return (hs, cs, stash) if with_stash else (hs, cs)


def gru_seq_cuda(x, h0, w, seqlen, reverse, with_stash):
    """Launch the GRU kernel: x [B, T, 3H] (already flipped when
    `reverse`), h0 [B, H], w [H, 3H], all float32 or all bfloat16, seqlen
    [B] of any integer type. Returns (hs[, stash]) in x's type as
    `gru_seq_plain`."""
    b, t, hd = _check_args("gru_seq_cuda", 3, x, (h0,), w, seqlen)
    lib = kernels.load("recurrent")
    _bind(lib)
    dev = x.device
    plan = recurrent_plan("gru", b, hd, dev)
    with torch.cuda.device(dev):
        x, h0, w = (a.contiguous() for a in (x, h0, w))
        w_rel = _w_rel(plan, w, 3)
        sl = seqlen.to(torch.int32).contiguous()
        hs = torch.empty((b, t, hd), dtype=x.dtype, device=dev)
        stash = (torch.empty((b, t, 3 * hd), dtype=x.dtype,
                             device=dev) if with_stash else None)
        # h, r·h and z; columns hd..hp-1 of each row stay zero: the kernel
        # reads them
        buf = torch.zeros((3, b, plan["hp"]), dtype=torch.float32,
                          device=dev)
        arrived = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.ptt_gru_seq(
            x.data_ptr(), w.data_ptr(), _ptr(w_rel), h0.data_ptr(),
            sl.data_ptr(), b, t, hd, int(bool(reverse)),
            _TYPE_CODES[x.dtype], hs.data_ptr(),
            _ptr(stash), buf.data_ptr(), arrived.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(lib, "gru_seq", err)
    kernels.count_launch("gru_seq")
    return (hs, stash) if with_stash else (hs,)


def _lstm_seq(x, h0, c0, w, seqlen, reverse, with_stash):
    fn = lstm_seq_cuda if x.is_cuda else lstm_seq_plain
    return fn(x, h0, c0, w, seqlen, reverse, with_stash)


def _gru_seq(x, h0, w, seqlen, reverse, with_stash):
    fn = gru_seq_cuda if x.is_cuda else gru_seq_plain
    return fn(x, h0, w, seqlen, reverse, with_stash)


# ---------------------------------------------------------------------------
# autograd: the manual reverse-time backward against the stash
# ---------------------------------------------------------------------------


def _valid_mask(seqlen, t, reverse):
    pos = torch.arange(t, device=seqlen.device)
    if reverse:
        pos = t - 1 - pos
    return pos[None, :] < seqlen[:, None]                   # [B, T]


class _FusedLSTM(torch.autograd.Function):
    """≙ `_fused_lstm` with `_fused_lstm_fwd` / `_fused_lstm_bwd`."""

    @staticmethod
    def forward(ctx, x, h0, c0, w, seqlen, reverse):
        hs, cs, stash = _lstm_seq(x, h0, c0, w, seqlen, reverse, True)
        ctx.reverse = reverse
        ctx.save_for_backward(hs, cs, stash, h0, c0, w, seqlen)
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        hs, cs, stash, h0, c0, w, seqlen = ctx.saved_tensors
        b, t, hd = hs.shape
        f32 = torch.float32
        hprev = torch.cat([h0[:, None], hs[:, :-1]], 1)
        cprev = torch.cat([c0[:, None], cs[:, :-1]], 1).to(f32)
        valid = _valid_mask(seqlen, t, ctx.reverse)[:, :, None]
        tc = torch.tanh(cs.to(f32))
        stash = stash.to(f32)
        dhs, dcs = dhs.to(f32), dcs.to(f32)
        wt = w.to(f32).t()
        dh_c = hs.new_zeros((b, hd), dtype=f32)
        dc_c = hs.new_zeros((b, hd), dtype=f32)
        dx = hs.new_empty((b, t, 4 * hd), dtype=f32)
        for it in range(t - 1, -1, -1):
            i, f, g, o = stash[:, it].split(hd, dim=-1)
            vd = valid[:, it]
            dh = dh_c + dhs[:, it]
            dc = dc_c + dcs[:, it]
            dh_v = torch.where(vd, dh, 0.0)
            dc_v = torch.where(vd, dc, 0.0)
            tct = tc[:, it]
            do = dh_v * tct
            dc_v = dc_v + dh_v * o * (1.0 - tct * tct)
            di = dc_v * g
            dg = dc_v * i
            df = dc_v * cprev[:, it]
            dgates = torch.cat([di * i * (1 - i), df * f * (1 - f),
                                dg * (1 - g * g), do * o * (1 - o)], -1)
            dx[:, it] = dgates
            dh_c = dgates @ wt + torch.where(vd, 0.0, dh)
            dc_c = dc_v * f + torch.where(vd, 0.0, dc)
        # the JAX scan adds hp^T @ dgates step by step; one product over
        # every (row, step) pair sums the same terms
        dw = hprev.reshape(-1, hd).to(f32).t() @ dx.reshape(-1, 4 * hd)
        return (dx.to(hs.dtype), dh_c.to(h0.dtype), dc_c.to(c0.dtype),
                dw.to(w.dtype), None, None)


class _FusedGRU(torch.autograd.Function):
    """≙ `_fused_gru` with `_fused_gru_fwd` / `_fused_gru_bwd`."""

    @staticmethod
    def forward(ctx, x, h0, w, seqlen, reverse):
        hs, stash = _gru_seq(x, h0, w, seqlen, reverse, True)
        ctx.reverse = reverse
        ctx.save_for_backward(hs, stash, h0, w, seqlen)
        return hs

    @staticmethod
    def backward(ctx, dhs):
        hs, stash, h0, w, seqlen = ctx.saved_tensors
        b, t, hd = hs.shape
        f32 = torch.float32
        wf = w.to(f32)
        w_rz_t, w_c_t = wf[:, :2 * hd].t(), wf[:, 2 * hd:].t()
        hprev = torch.cat([h0[:, None], hs[:, :-1]], 1).to(f32)
        valid = _valid_mask(seqlen, t, ctx.reverse)[:, :, None]
        stash = stash.to(f32)
        dhs = dhs.to(f32)
        dh_c = hs.new_zeros((b, hd), dtype=f32)
        dx = hs.new_empty((b, t, 3 * hd), dtype=f32)
        for it in range(t - 1, -1, -1):
            r, z, c = stash[:, it].split(hd, dim=-1)
            hp = hprev[:, it]
            vd = valid[:, it]
            dh = dh_c + dhs[:, it]
            dh_v = torch.where(vd, dh, 0.0)
            dz = dh_v * (hp - c)
            dpre_c = dh_v * (1.0 - z) * (1.0 - c * c)
            drh = dpre_c @ w_c_t
            dpre_rz = torch.cat([drh * hp * r * (1 - r), dz * z * (1 - z)],
                                -1)
            dx[:, it, :2 * hd] = dpre_rz
            dx[:, it, 2 * hd:] = dpre_c
            dh_c = (drh * r + dpre_rz @ w_rz_t + dh_v * z
                    + torch.where(vd, 0.0, dh))
        rhp = stash[..., :hd] * hprev
        dw = torch.cat(
            [hprev.reshape(-1, hd).t() @ dx[..., :2 * hd].reshape(-1, 2 * hd),
             rhp.reshape(-1, hd).t() @ dx[..., 2 * hd:].reshape(-1, hd)], -1)
        return (dx.to(hs.dtype), dh_c.to(h0.dtype), dw.to(w.dtype), None,
                None)


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


# ---------------------------------------------------------------------------
# public entry points + op registrations
# ---------------------------------------------------------------------------


def _check_backend(backend):
    """`backend` is kept for the JAX package's signature and takes None
    only: the kernel for a CUDA tensor, the plain version for a CPU one.
    The JAX package's TPU backends ("pallas", "pallas_interpret", "xla")
    and any other value raise; none picks the plain version for a CUDA
    tensor."""
    if backend is not None:
        from ..core.enforce import InvalidArgumentError
        raise InvalidArgumentError(
            f"backend {backend!r}: the port picks K5 / K6 or the plain "
            f"version by the tensors' device (backend=None); the JAX "
            f"package's TPU backends do not exist here")


def fused_lstm_sequence(x, h0, c0, w, seqlen, reverse=False, backend=None):
    """Whole-sequence fused LSTM. x [B, T, 4H] pre-projected (+bias), w
    [H, 4H] recurrent, seqlen [B] int; returns (hidden, cell) [B, T, H].
    The same function as the `dynamic_lstm` loop with the default
    activations, forward and gradient. K5 on CUDA tensors (float32 or
    bfloat16), the plain version on CPU tensors; `backend` as
    `_check_backend` says."""
    _check_backend(backend)
    if reverse:
        x = torch.flip(x, (1,))
    if _wants_grad(x, h0, c0, w):
        hs, cs = _FusedLSTM.apply(x, h0, c0, w, seqlen, bool(reverse))
    else:
        hs, cs = _lstm_seq(x, h0, c0, w, seqlen, bool(reverse), False)
    if reverse:
        hs, cs = torch.flip(hs, (1,)), torch.flip(cs, (1,))
    return hs, cs


def fused_gru_sequence(x, h0, w, seqlen, reverse=False, backend=None):
    """Whole-sequence fused GRU. x [B, T, 3H] pre-projected (+bias), w
    [H, 3H] (reset/update | candidate); returns hidden [B, T, H]. K6 on
    CUDA tensors, the plain version on CPU tensors, as
    fused_lstm_sequence."""
    _check_backend(backend)
    if reverse:
        x = torch.flip(x, (1,))
    if _wants_grad(x, h0, w):
        hs = _FusedGRU.apply(x, h0, w, seqlen, bool(reverse))
    else:
        hs, = _gru_seq(x, h0, w, seqlen, bool(reverse), False)
    if reverse:
        hs = torch.flip(hs, (1,))
    return hs


_DEFAULT_LSTM_ACTS = {"gate_activation": "sigmoid",
                      "cell_activation": "tanh",
                      "candidate_activation": "tanh"}
_DEFAULT_GRU_ACTS = {"gate_activation": "sigmoid", "activation": "tanh"}


def lstm_attrs_fusable(attrs) -> bool:
    return all(attrs.get(k, v) == v for k, v in _DEFAULT_LSTM_ACTS.items())


def gru_attrs_fusable(attrs) -> bool:
    return all(attrs.get(k, v) == v for k, v in _DEFAULT_GRU_ACTS.items())


@register_op("fused_lstm")
def _fused_lstm_op(ctx, ins, attrs):
    """Drop-in for `dynamic_lstm` (same slots and attrs, default activations
    only: `fuse_recurrent_cell_pass` rewrites only those). Of a [7H]
    peephole bias only the first 4H enter the gates, as in the JAX
    package."""
    from ..core.enforce import InvalidArgumentError, enforce
    enforce(lstm_attrs_fusable(attrs),
            "fused_lstm supports only the default sigmoid/tanh activations",
            exc=InvalidArgumentError)
    x = ins["Input"][0]
    w = ins["Weight"][0]
    h = w.shape[0]
    b = x.shape[0]
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(1, 1, -1)[:, :, :4 * h]
    h0 = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, h))
    c0 = ins["C0"][0] if ins.get("C0") else x.new_zeros((b, h))
    hs, cs = fused_lstm_sequence(x, h0, c0, w, ins["SeqLen"][0],
                                 reverse=attrs.get("is_reverse", False))
    return {"Hidden": [hs], "Cell": [cs]}


@register_op("fused_gru")
def _fused_gru_op(ctx, ins, attrs):
    """Drop-in for `dynamic_gru` (same slots and attrs, default
    activations)."""
    from ..core.enforce import InvalidArgumentError, enforce
    enforce(gru_attrs_fusable(attrs),
            "fused_gru supports only the default sigmoid/tanh activations",
            exc=InvalidArgumentError)
    x = ins["Input"][0]
    w = ins["Weight"][0]
    h = w.shape[0]
    b = x.shape[0]
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(1, 1, -1)
    h0 = ins["H0"][0] if ins.get("H0") else x.new_zeros((b, h))
    hs = fused_gru_sequence(x, h0, w, ins["SeqLen"][0],
                            reverse=attrs.get("is_reverse", False))
    return {"Hidden": [hs]}
