"""Fused decode-attention step: one KV-cache tick's Q·K^T·softmax·V in one
kernel.

≙ paddle_tpu/fusion/decode_attention.py. `fuse_decode_attention_pass`
(framework/passes.py) rewrites each layer's cached-decode chain
matmul(q, K^T, alpha=scale) → +bias → softmax → matmul(·, V) into one
`fused_decode_attention` op, which lowers here. The cache WRITE stays on the
`cache_write` op; this kernel fuses the read side.

Three pieces, as for every kernel of the port:

- `decode_attention_cuda` — the wrapper of the hand-written CUDA kernel
  (csrc/decode_attention.cu, replacing the Pallas kernel
  `paddle_tpu/fusion/decode_attention.py:_decode_step_kernel`). It checks
  shapes, types and layout, allocates the scratch for the partials of the
  cache's chunks, launches on the current stream (the split kernel, then
  the merge: one call) and counts the call once in
  `kernels.LAUNCHES["decode_attention"]`.
- `decode_attention_plain` — the same function in plain PyTorch, the
  arithmetic of the TPU kernel written out: scores, max and sum in float32,
  the output cast to q's dtype. (The JAX package's XLA composite instead
  rounds the scores to q's dtype before scaling; the port follows the
  kernel.)
- `fused_decode_attention` — normalizes shapes and runs `_DecodeAttention`,
  an autograd function whose forward picks by device (the plain version for
  CPU tensors only; CUDA tensors launch the kernel or raise; there is no
  fallback between the two) and whose backward differentiates the plain
  version, as the JAX package's `_decode_attention_bwd` differentiates its
  composite. The NMT decoder's attention runs it inside a `vjp_region`.

Not on this slice (they raise NotImplementedError): int8 KV caches
(`k_scale`/`v_scale`) and multi-position queries (G > 1, the speculative
verify window) — both belong to the paged/quantized/speculative serving
slice, ROADMAP.md port queue item 2.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..framework.registry import register_op

#: the largest head dim the kernel takes (csrc/decode_attention.cu
#: kMaxHeadDim): 16 values a lane; the NMT decoder attends at dh = 512
MAX_HEAD_DIM = 512

_SPEC_QUANT_SLICE = ("belongs to the paged/quantized/speculative serving "
                     "slice, ROADMAP.md port queue item 2")


def decode_attention_plain(q3, k4, v4, bias3, scale):
    """q3 [R, nh, dh], k4/v4 [R, nh, T, dh], bias3 [R, nh, T] → [R, nh, dh]
    in q3's dtype; every step in float32."""
    q = q3.float()
    s = (q.unsqueeze(2) * k4.float()).sum(-1) * scale + bias3.float()
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    w = p / p.sum(-1, keepdim=True)
    out = (w.unsqueeze(-1) * v4.float()).sum(2)
    return out.to(q3.dtype)


def _bind(lib):
    if getattr(lib, "_ptt_bound", False):
        return
    c_ll, c_int, c_vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.ptt_decode_attention.argtypes = [
        c_int, c_vp, c_vp, c_vp, c_vp, c_vp, c_vp, c_int, c_int, c_int,
        c_int, c_int, c_ll, c_ll, ctypes.c_float, c_vp]
    lib.ptt_decode_attention.restype = c_int
    lib.ptt_decode_attention_chunk.argtypes = [c_int] * 4
    lib.ptt_decode_attention_chunk.restype = c_int
    lib._ptt_bound = True


def decode_attention_chunk(r, nh, t, dh, device=None):
    """Positions per block a call at this shape takes on `device` (default:
    the current CUDA device): the kernel splits the cache of each row and
    head into ceil(t / chunk) chunks, one block each, and merges their
    partials (csrc/decode_attention.cu `chunk_len` chooses). Raises for a
    shape the kernel does not take."""
    lib = kernels.load("decode_attention")
    _bind(lib)
    with torch.cuda.device(device if device is not None else
                           torch.cuda.current_device()):
        chunk = lib.ptt_decode_attention_chunk(r, nh, t, dh)
    if chunk < 1:
        raise ValueError(f"decode_attention_cuda: the kernel does not take "
                         f"R={r} nh={nh} T={t} dh={dh} (head dims 1-"
                         f"{MAX_HEAD_DIM}, at most 65535 chunks of the "
                         f"cache)")
    return chunk


def decode_attention_cuda(q3, k4, v4, bias3, scale):
    """Launch the CUDA kernel: q3 [R, nh, dh] float32 or bfloat16,
    k4/v4 [R, nh, T, dh] float32 contiguous, bias3 [R, nh, T] float32 with
    unit stride along T (any row and head strides, 0 included). Returns
    [R, nh, dh] in q3's dtype, for head dims up to 512 and T up to 65535
    chunks of the cache (`decode_attention_chunk`; a chunk is 16 to 256
    positions, so T reaches about 1M at dh 512 and 16M at dh 32). Raises
    on anything else."""
    r, nh, dh = q3.shape
    t = k4.shape[2]
    dev = q3.device
    if dev.type != "cuda" or any(x.device != dev for x in (k4, v4, bias3)):
        raise ValueError("decode_attention_cuda: every tensor must be on "
                         "the same CUDA device")
    if q3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention_cuda: q must be float32 or "
                        f"bfloat16, got {q3.dtype}")
    if k4.dtype != torch.float32 or v4.dtype != torch.float32 or \
            bias3.dtype != torch.float32:
        raise TypeError("decode_attention_cuda: K, V and bias must be "
                        "float32 (the slot caches' type)")
    if tuple(k4.shape) != (r, nh, t, dh) or tuple(v4.shape) != (r, nh, t, dh) \
            or tuple(bias3.shape) != (r, nh, t):
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q3.shape)}"
                         f" k {tuple(k4.shape)} v {tuple(v4.shape)} bias "
                         f"{tuple(bias3.shape)} do not agree")
    if not (q3.is_contiguous() and k4.is_contiguous()
            and v4.is_contiguous()) or bias3.stride(2) != 1:
        raise ValueError("decode_attention_cuda: q, K, V must be contiguous "
                         "and bias unit-stride along T")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention_cuda: head dim {dh} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    n_split = -(-t // decode_attention_chunk(r, nh, t, dh, dev))
    lib = kernels.load("decode_attention")
    with torch.cuda.device(dev):
        out = torch.empty((r, nh, dh), dtype=q3.dtype, device=dev)
        # each chunk's partial: its context sum, max and sum of exp
        part = torch.empty((r * nh, n_split, dh + 2), dtype=torch.float32,
                           device=dev)
        err = lib.ptt_decode_attention(
            int(q3.dtype == torch.bfloat16), q3.data_ptr(), k4.data_ptr(),
            v4.data_ptr(), bias3.data_ptr(), out.data_ptr(), part.data_ptr(),
            n_split, r, nh, t, dh, bias3.stride(0), bias3.stride(1),
            float(scale), torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(lib, "decode_attention", err)
    kernels.count_launch("decode_attention")
    return out


def fused_decode_attention(q, k, v, bias, scale=1.0, k_scale=None,
                           v_scale=None):
    """One decode tick of cached attention.

    q [..., nh, 1, dh], k/v [..., nh, T, dh] (the KV cache, broadcastable
    over the leading dims), bias broadcastable to [..., nh, 1, T] (additive
    mask hiding cache positions beyond each slot's tick). Returns
    [..., nh, 1, dh] in q's dtype: softmax(q·K^T·scale + bias)·V."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "fused_decode_attention over int8 KV caches (k_scale/v_scale) "
            + _SPEC_QUANT_SLICE)
    lead = tuple(q.shape[:-3])
    nh, g, dh = q.shape[-3:]
    if g != 1:
        raise NotImplementedError(
            f"fused_decode_attention with a {g}-position query (speculative "
            f"verify window) " + _SPEC_QUANT_SLICE)
    t = k.shape[-2]
    r = 1
    for d in lead:
        r *= d
    q3 = q.reshape(r, nh, dh)
    k4 = k.expand(lead + tuple(k.shape[-3:])).reshape(r, nh, t, dh)
    v4 = v.expand(lead + tuple(v.shape[-3:])).reshape(r, nh, t, dh)
    # the mask is usually one row per slot shared by every head: keep the
    # head stride 0 instead of materializing the broadcast
    bias3 = bias.to(torch.float32).expand(lead + (nh, 1, t)).reshape(
        r, nh, t)
    out = _DecodeAttention.apply(q3, k4, v4, bias3, scale)
    return out.reshape(lead + (nh, 1, dh))


class _DecodeAttention(torch.autograd.Function):
    """The kernel (CUDA tensors) or the plain version (CPU tensors)
    forward; the backward differentiates the plain version on the saved
    inputs (≙ `_decode_attention_bwd`). Under `no_grad`, as on the serving
    tick, `apply` records no graph."""

    @staticmethod
    def forward(ctx, q3, k4, v4, bias3, scale):
        ctx.scale = scale
        ctx.save_for_backward(q3, k4, v4, bias3)
        if q3.is_cuda:
            return decode_attention_cuda(q3.contiguous(), k4.contiguous(),
                                         v4.contiguous(), bias3, scale)
        return decode_attention_plain(q3, k4, v4, bias3, scale)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(n) for a, n in zip(saved,
                                                                   need)]
            out = decode_attention_plain(*leaves, ctx.scale)
            wrt = [a for a, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, dout)) if wrt \
                else iter(())
        return tuple(next(grads) if n else None for n in need) + (None,)


@register_op("fused_decode_attention")
def _fused_decode_attention_op(ctx, ins, attrs):
    """Fused Q·K^T+bias→softmax→·V over a KV cache for a single-position
    query (emitted by `fuse_decode_attention_pass` from the 4-op decode
    chain)."""
    ks, vs = ins.get("KScale"), ins.get("VScale")
    out = fused_decode_attention(ins["Q"][0], ins["K"][0], ins["V"][0],
                                 ins["Bias"][0],
                                 scale=attrs.get("scale", 1.0),
                                 k_scale=ks[0] if ks else None,
                                 v_scale=vs[0] if vs else None)
    return {"Out": [out]}
