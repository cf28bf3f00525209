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

_BF16_CELLS = ("recurrent cells in another type than float32 are not "
               "ported: ROADMAP.md port queue item 3 (bf16 recurrent "
               "cells)")


# ---------------------------------------------------------------------------
# plain PyTorch versions (≙ _xla_lstm_seq / _xla_gru_seq)
# ---------------------------------------------------------------------------


def lstm_seq_plain(x, h0, c0, w, seqlen, reverse, with_stash):
    """x [B, T, 4H] (already flipped when `reverse`), h0/c0 [B, H], w
    [H, 4H], seqlen [B] → (hs, cs[, stash]): [B, T, H] each, stash
    [B, T, 4H] of the gate activations (i, f, c^, o)."""
    t = x.shape[1]
    hd = w.shape[0]
    h, c = h0, c0
    hs, cs, stash = [], [], []
    for it in range(t):
        gates = x[:, it] + h @ w
        i, f, g, o = gates.split(hd, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
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
    hd = w.shape[0]
    w_rz, w_c = w[:, :2 * hd], w[:, 2 * hd:]
    h = h0
    hs, stash = [], []
    for it in range(t):
        xt = x[:, it]
        rz = torch.sigmoid(xt[:, :2 * hd] + h @ w_rz)
        r, z = rz.split(hd, dim=-1)
        c = torch.tanh(xt[:, 2 * hd:] + (r * h) @ w_c)
        h_new = z * h + (1 - z) * c
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
# CUDA wrappers
# ---------------------------------------------------------------------------


def _bind(lib):
    if getattr(lib, "_ptt_bound", False):
        return
    c_int, c_vp = ctypes.c_int, ctypes.c_void_p
    lib.ptt_lstm_seq.argtypes = [c_vp] * 6 + [c_int] * 4 + [c_vp] * 6
    lib.ptt_lstm_seq.restype = c_int
    lib.ptt_gru_seq.argtypes = [c_vp] * 5 + [c_int] * 4 + [c_vp] * 5
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
    if not plan["stream_w"]:
        return None
    return relay_w(w, n_gates, plan["ug"], plan["groups"], plan["blocks"],
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
    if any(a.dtype != torch.float32 for a in (x, w, *states)):
        raise NotImplementedError(f"{name}: " + _BF16_CELLS)
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
    `reverse`), h0/c0 [B, H], w [H, 4H] float32, seqlen [B] of any integer
    type. Returns (hs, cs[, stash]) as `lstm_seq_plain`. Raises on another
    type and on shapes that disagree."""
    b, t, hd = _check_args("lstm_seq_cuda", 4, x, (h0, c0), w, seqlen)
    lib = kernels.load("recurrent")
    _bind(lib)
    dev = x.device
    plan = recurrent_plan("lstm", b, hd, dev)
    with torch.cuda.device(dev):
        x, h0, c0, w = (a.contiguous() for a in (x, h0, c0, w))
        w_rel = _w_rel(plan, w, 4)
        sl = seqlen.to(torch.int32).contiguous()
        hs = torch.empty((b, t, hd), dtype=torch.float32, device=dev)
        cs = torch.empty_like(hs)
        stash = (torch.empty((b, t, 4 * hd), dtype=torch.float32,
                             device=dev) if with_stash else None)
        # columns hd..hp-1 of each row stay zero: the kernel reads them
        hbuf = torch.zeros((2, b, plan["hp"]), dtype=torch.float32,
                           device=dev)
        arrived = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.ptt_lstm_seq(
            x.data_ptr(), w.data_ptr(), _ptr(w_rel), h0.data_ptr(),
            c0.data_ptr(), sl.data_ptr(), b, t, hd, int(bool(reverse)),
            hs.data_ptr(), cs.data_ptr(), _ptr(stash), hbuf.data_ptr(),
            arrived.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(lib, "lstm_seq", err)
    kernels.count_launch("lstm_seq")
    return (hs, cs, stash) if with_stash else (hs, cs)


def gru_seq_cuda(x, h0, w, seqlen, reverse, with_stash):
    """Launch the GRU kernel: x [B, T, 3H] (already flipped when
    `reverse`), h0 [B, H], w [H, 3H] float32, seqlen [B] of any integer
    type. Returns (hs[, stash]) as `gru_seq_plain`."""
    b, t, hd = _check_args("gru_seq_cuda", 3, x, (h0,), w, seqlen)
    lib = kernels.load("recurrent")
    _bind(lib)
    dev = x.device
    plan = recurrent_plan("gru", b, hd, dev)
    with torch.cuda.device(dev):
        x, h0, w = (a.contiguous() for a in (x, h0, w))
        w_rel = _w_rel(plan, w, 3)
        sl = seqlen.to(torch.int32).contiguous()
        hs = torch.empty((b, t, hd), dtype=torch.float32, device=dev)
        stash = (torch.empty((b, t, 3 * hd), dtype=torch.float32,
                             device=dev) if with_stash else None)
        # h, r·h and z; columns hd..hp-1 of each row stay zero: the kernel
        # reads them
        buf = torch.zeros((3, b, plan["hp"]), dtype=torch.float32,
                          device=dev)
        arrived = torch.zeros(1, dtype=torch.int32, device=dev)
        err = lib.ptt_gru_seq(
            x.data_ptr(), w.data_ptr(), _ptr(w_rel), h0.data_ptr(),
            sl.data_ptr(), b, t, hd, int(bool(reverse)), hs.data_ptr(),
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
    activations, forward and gradient. K5 on CUDA tensors (float32 only:
    another type raises naming ROADMAP.md item 3), the plain version on
    CPU tensors; `backend` as `_check_backend` says."""
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
