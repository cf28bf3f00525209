"""Fused attention: flash attention forward and backward as three CUDA
kernels, and the `fused_attention` op.

≙ paddle_tpu/ops/pallas_kernels.py, the counterpart of its Pallas TPU
kernels `_flash_kernel` (K1, forward), `_flash_bwd_dq_kernel` (K2, dQ) and
`_flash_bwd_dkv_kernel` (K3, dK and dV). The CUDA kernels are in
csrc/flash_attention.cu. Three pieces, as for every kernel of the port:

- `flash_fwd_cuda`, `flash_bwd_dq_cuda`, `flash_bwd_dkv_cuda` — wrappers of
  the hand-written kernels. Each checks device, type, shape and layout,
  launches on the current stream, and adds one to its count in
  `kernels.LAUNCHES` ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv").
- `flash_fwd_plain` → (o, lse) and `flash_bwd_plain` → (dq, dk, dv) — the
  same functions in plain PyTorch with the kernels' semantics: scores in
  float32, masked scores -1e30, an online softmax over tiles of 64 keys,
  p zeroed where s <= -1e30/2, P cast to v's type before P·V,
  o = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30));
  in the backward P = exp(s - lse) where valid, dS = P·(dP - delta)·scale,
  P cast to dO's type and dS to k's (q's) type before the second products.
  A query row with no visible key gives zeros, as `_attention_reference`
  does. (SDPA differs on such rows, so it is no stand-in.)
- `FlashAttention`, a `torch.autograd.Function` that picks by device: CPU
  tensors run the plain forward and backward; CUDA tensors launch K1, then
  K2 and K3, or raise. There is no flag and no fallback.

Masks: causal aligned bottom-right (query i sees keys up to i + Tk - Tq)
and segment ids (a query sees a key iff their ids are equal; the packed
batches of data/packing.py). Tensors are [B, H, T, D]; the kernels take
head dims 32, 64 and 128 in float32 or bfloat16.

`delta` = Σ dO·O in float32 is a plain torch op, as in the JAX package;
the backward kernels also take it from the caller, and K1's lse output is
the other residual a ring-attention caller needs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..framework.registry import register_op

_NEG_INF = -1e30

#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (32, 64, 128)

#: keys per tile of K1's online softmax (kBK in csrc/flash_attention.cu)
KEY_TILE = 64


def _segment_ids(segment_ids, q, k):
    """A [B, Tq] tensor (self-attention) or a (q_ids, kv_ids) pair →
    (q_ids [B, Tq], kv_ids [B, Tk]) int32, or (None, None)."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        q_ids, kv_ids = segment_ids
    else:
        q_ids = kv_ids = segment_ids
    q_ids = q_ids.to(torch.int32)
    kv_ids = kv_ids.to(torch.int32)
    b, _, tq, _ = q.shape
    tk = k.shape[2]
    if tuple(q_ids.shape) != (b, tq) or tuple(kv_ids.shape) != (b, tk):
        raise ValueError(
            f"segment_ids shapes {tuple(q_ids.shape)}/{tuple(kv_ids.shape)} "
            f"do not match q [B={b}, Tq={tq}] / k [B={b}, Tk={tk}]")
    return q_ids, kv_ids


def _valid_mask(q, k, causal, q_ids, kv_ids):
    """[B or 1, 1, Tq, Tk] bool: which (query, key) pairs are visible, or
    None when every pair is."""
    tq, tk = q.shape[2], k.shape[2]
    mask = None
    if causal:
        mask = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril(
            tk - tq)[None, None]
    if q_ids is not None:
        seg = (q_ids[:, :, None] == kv_ids[:, None, :])[:, None]
        mask = seg if mask is None else mask & seg
    return mask


def _acc(t):
    """The plain versions' arithmetic type: float32, or float64 for float64
    inputs (gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def flash_fwd_plain(q, k, v, scale, causal, q_ids=None, kv_ids=None):
    """K1's function in plain PyTorch: (o [B,H,Tq,D] in q's dtype,
    lse [B,H,Tq] float32). Like the kernel, an online softmax over tiles of
    KEY_TILE keys: P is rounded to v's dtype against the running max of the
    tiles so far, which matters in bfloat16."""
    f = _acc(q)
    qf = q.to(f)
    mask = _valid_mask(q, k, causal, q_ids, kv_ids)
    zero = torch.zeros((), dtype=f, device=q.device)
    m = torch.full(q.shape[:-1] + (1,), _NEG_INF, dtype=f, device=q.device)
    lsum = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=f, device=q.device)
    for k0 in range(0, k.shape[2], KEY_TILE):
        kt, vt = k[:, :, k0:k0 + KEY_TILE], v[:, :, k0:k0 + KEY_TILE]
        s = torch.matmul(qf, kt.to(f).transpose(-1, -2)) * scale
        if mask is not None:
            s = s.masked_fill(~mask[..., k0:k0 + KEY_TILE], _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        # a row with nothing visible so far has m == s == -1e30: its dead
        # entries must not count as exp(0) = 1
        p = torch.where(s > _NEG_INF / 2, p, zero)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).to(f), vt.to(f))
        m = m_new
    lsum = lsum.clamp_min(1e-30)
    o = (acc / lsum).to(q.dtype)
    lse = (m + torch.log(lsum)).squeeze(-1)
    return o, lse


def flash_delta(o, do):
    """delta = Σ_d dO·O in float32 (float64 for float64), [B, H, Tq]."""
    f = _acc(o)
    return (do.to(f) * o.to(f)).sum(-1)


def flash_bwd_plain(q, k, v, o, lse, do, scale, causal, q_ids=None,
                    kv_ids=None, delta=None):
    """K2 and K3's function in plain PyTorch: (dq, dk, dv) in q's, k's and
    v's dtypes. `delta` defaults to Σ dO·O; `o` may then be None."""
    if delta is None:
        delta = flash_delta(o, do)
    f = _acc(q)
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(f).unsqueeze(-1))
    mask = _valid_mask(q, k, causal, q_ids, kv_ids)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), dtype=f, device=p.device))
    dp = torch.matmul(do.to(f), v.to(f).transpose(-1, -2))
    ds = p * (dp - delta.to(f).unsqueeze(-1)) * scale
    dv = torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), do.to(f))
    dq = torch.matmul(ds.to(k.dtype).to(f), k.to(f))
    dk = torch.matmul(ds.to(q.dtype).to(f).transpose(-1, -2), q.to(f))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- the CUDA kernels -------------------------------------------------------

def _bind(lib):
    if getattr(lib, "_ptt_bound", False):
        return
    c_int, c_vp, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    tail = [c_int, c_int, c_int, c_int, c_f, c_int, c_vp]
    lib.ptt_flash_fwd.argtypes = [c_int, c_int] + [c_vp] * 7 + tail
    lib.ptt_flash_bwd_dq.argtypes = [c_int, c_int] + [c_vp] * 9 + tail
    lib.ptt_flash_bwd_dkv.argtypes = [c_int, c_int] + [c_vp] * 10 + tail
    for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq,
               lib.ptt_flash_bwd_dkv):
        fn.restype = c_int
    lib._ptt_bound = True


def _check(name, tensors, q, k, q_ids, kv_ids):
    """Raise unless every tensor is a contiguous CUDA tensor on q's device,
    q/k/v-like tensors share q's dtype (float32 or bfloat16) and shapes
    agree with q [B,H,Tq,D] / k [B,H,Tk,D]."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q/k/v must be float32 or bfloat16, got "
                        f"{q.dtype}")
    b, h, _, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} is not one the kernels are "
                         f"built for {KERNEL_HEAD_DIMS}")
    if k.dim() != 4 or k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not agree")
    for t, want_dtype, want_shape in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device")
        if t.dtype != want_dtype or tuple(t.shape) != tuple(want_shape):
            raise ValueError(f"{name}: got {t.dtype} {tuple(t.shape)}, "
                             f"expected {want_dtype} {tuple(want_shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    for ids, t in ((q_ids, q.shape[2]), (kv_ids, k.shape[2])):
        if ids is not None and (ids.device != dev or ids.dtype != torch.int32
                                or tuple(ids.shape) != (b, t)
                                or not ids.is_contiguous()):
            raise ValueError(f"{name}: segment ids must be contiguous int32 "
                             f"[{b}, {t}] on q's device")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, fn, *args):
    lib = kernels.load("flash_attention")
    _bind(lib)
    err = getattr(lib, fn)(*args)
    kernels.check(lib, name, err)
    kernels.count_launch(name)


def flash_fwd_cuda(q, k, v, scale, causal, q_ids=None, kv_ids=None,
                   with_lse=True):
    """Launch K1. q [B,H,Tq,D], k/v [B,H,Tk,D]: contiguous CUDA tensors of
    one dtype. Returns (o, lse or None)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _check("flash_fwd_cuda", [(k, q.dtype, (b, h, tk, d)),
                              (v, q.dtype, (b, h, tk, d)),
                              (q, q.dtype, (b, h, tq, d))], q, k, q_ids,
           kv_ids)
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
               if with_lse else None)
        _launch("flash_fwd", "ptt_flash_fwd", int(q.dtype == torch.bfloat16),
                d, q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_ids),
                _ptr(kv_ids), o.data_ptr(), _ptr(lse), b * h, h, tq, tk,
                float(scale), int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def _bwd_check(name, q, k, v, do, lse, delta, q_ids, kv_ids):
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _check(name, [(q, q.dtype, (b, h, tq, d)), (k, q.dtype, (b, h, tk, d)),
                  (v, q.dtype, (b, h, tk, d)), (do, q.dtype, (b, h, tq, d)),
                  (lse, torch.float32, (b, h, tq)),
                  (delta, torch.float32, (b, h, tq))], q, k, q_ids, kv_ids)
    return b, h, tq, tk, d


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, q_ids=None,
                      kv_ids=None):
    """Launch K2: dq in q's dtype."""
    b, h, tq, tk, d = _bwd_check("flash_bwd_dq_cuda", q, k, v, do, lse,
                                 delta, q_ids, kv_ids)
    with torch.cuda.device(q.device):
        dq = torch.empty_like(q)
        _launch("flash_bwd_dq", "ptt_flash_bwd_dq",
                int(q.dtype == torch.bfloat16), d, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(q_ids), _ptr(kv_ids), dq.data_ptr(),
                b * h, h, tq, tk, float(scale), int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal, q_ids=None,
                       kv_ids=None):
    """Launch K3: (dk, dv) in k's and v's dtype."""
    b, h, tq, tk, d = _bwd_check("flash_bwd_dkv_cuda", q, k, v, do, lse,
                                 delta, q_ids, kv_ids)
    with torch.cuda.device(q.device):
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        _launch("flash_bwd_dkv", "ptt_flash_bwd_dkv",
                int(q.dtype == torch.bfloat16), d, q.data_ptr(),
                k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(q_ids), _ptr(kv_ids), dk.data_ptr(),
                dv.data_ptr(), b * h, h, tq, tk, float(scale),
                int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


def flash_bwd_cuda(q, k, v, o, lse, do, scale, causal, q_ids=None,
                   kv_ids=None, delta=None):
    """K2 then K3: (dq, dk, dv). `delta` defaults to Σ dO·O."""
    if delta is None:
        delta = flash_delta(o, do)
    dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, q_ids,
                           kv_ids)
    dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal,
                                q_ids, kv_ids)
    return dq, dk, dv


# --- autograd ----------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the flash kernels' semantics. CPU
    tensors take the plain versions; CUDA tensors launch K1 forward and K2,
    K3 backward, or raise."""

    @staticmethod
    def forward(ctx, q, k, v, q_ids, kv_ids, scale, causal):
        if q.is_cuda:
            o, lse = flash_fwd_cuda(q, k, v, scale, causal, q_ids, kv_ids)
        else:
            o, lse = flash_fwd_plain(q, k, v, scale, causal, q_ids, kv_ids)
        ctx.save_for_backward(q, k, v, o, lse, q_ids, kv_ids)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, q_ids, kv_ids = ctx.saved_tensors
        do = do.contiguous()
        bwd = flash_bwd_cuda if do.is_cuda else flash_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do, ctx.scale, ctx.causal, q_ids,
                         kv_ids)
        return dq, dk, dv, None, None, None, None


def fused_attention(q, k, v, scale=None, causal=False, segment_ids=None):
    """Fused multi-head attention over [B, H, T, D] tensors, differentiable.
    segment_ids: a [B, T] integer tensor (self-attention) or a
    (q_ids, kv_ids) pair for packed batches."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    q_ids, kv_ids = _segment_ids(segment_ids, q, k)
    if q_ids is not None:
        q_ids, kv_ids = q_ids.contiguous(), kv_ids.contiguous()
    return FlashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), q_ids, kv_ids, float(scale),
                                bool(causal))


@register_op("fused_attention")
def _fused_attention_op(ctx, ins, attrs):
    """Fused scaled-dot-product attention (≙ pallas_kernels.py's
    `fused_attention` op). The JAX op's `backend` attribute picks a TPU
    backend and is ignored here: CPU tensors run the plain version, CUDA
    tensors the kernels."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    seg = None
    if ins.get("QSeg"):
        q_ids = ins["QSeg"][0]
        seg = (q_ids, ins["KVSeg"][0] if ins.get("KVSeg") else q_ids)
    out = fused_attention(q, k, v, scale=attrs.get("scale"),
                          causal=attrs.get("causal", False),
                          segment_ids=seg)
    return {"Out": [out]}
