"""Fused decode-attention step: one KV-cache tick's Q·K^T·softmax·V in one
kernel, for one query position or a speculative verify window, over a
float32, a bfloat16 or an int8 cache.

≙ paddle_tpu/fusion/decode_attention.py. `fuse_decode_attention_pass`
(framework/passes.py) rewrites each layer's cached-decode chain
matmul(q, K^T, alpha=scale) → +bias → softmax → matmul(·, V) into one
`fused_decode_attention` op, which lowers here: the decode tick's
single-position query (G = 1) and the speculative verify forward's window
of G = γ+1 positions (1 < G < T). The cache WRITE stays on the
`cache_write` / `paged_cache_write` ops; this kernel fuses the read side.

Three pieces, as for every kernel of the port:

- `decode_attention_cuda` — the wrapper of the hand-written CUDA kernel,
  called through the registered op `ptpu::decode_attention`
  (kernel_ops.py; csrc/decode_attention.cu, replacing the Pallas kernel
  `paddle_tpu/fusion/decode_attention.py:_decode_step_kernel`, and the
  XLA composite the JAX package sends G > 1 windows and int8 caches
  through). It checks shapes, types and layout, allocates the scratch for
  the partials of the cache's chunks, launches on the current stream (the
  split kernel, then the merge: one call) and counts the call once in
  `kernels.LAUNCHES["decode_attention"]`, and also under
  `decode_attention_multi` for G > 1 and `decode_attention_int8` for an
  int8 cache. A bfloat16 cache (the encoder-decoder generator's
  cross-attention keys and values come from bfloat16 fc layers) is read
  as the Pallas kernel reads any cache: widened to float32.
- `decode_attention_plain` — the same function in plain PyTorch, the
  arithmetic of the TPU kernel written out: an int8 cache dequantized to
  q's dtype (`dequantize_kv_time_blocks`), then scores, max and sum in
  float32 and the output cast to q's dtype. (The JAX package's XLA
  composite instead rounds the scores to q's dtype before scaling; the
  port follows the kernel.)
- `fused_decode_attention` — normalizes shapes and runs `_DecodeAttention`,
  an autograd function whose forward picks by device (the plain version for
  CPU tensors only; CUDA tensors launch the kernel or raise; there is no
  fallback between the two) and whose backward differentiates the plain
  version, as the JAX package's `_decode_attention_bwd` differentiates its
  composite: q, bias and the scales take gradients, int8 payloads none.
  The NMT decoder's attention runs it inside a `vjp_region`.

`quantize_kv_time_blocks` / `dequantize_kv_time_blocks` make and undo the
int8 caches (one float32 scale per time block of at most 8 positions);
their payloads and scales equal the JAX package's byte for byte.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernel_ops, kernels
from ..core.enforce import InvalidArgumentError, enforce
from ..framework.registry import register_op

#: the largest head dim the kernel takes (csrc/decode_attention.cu
#: kMaxHeadDim): 16 values a lane; the NMT decoder attends at dh = 512
MAX_HEAD_DIM = 512

#: time-axis tile of an int8 cache: one f32 scale per <= 8 cache steps
QUANT_KV_BLOCK_T = 8

#: the caches' types, by the kernel's type code
_CACHE_TYPES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}


def _fit_time_block(t, block):
    b = min(block, t)
    while t % b:
        b -= 1
    return b


def quantize_kv_time_blocks(kv, block=QUANT_KV_BLOCK_T):
    """Symmetric int8 quantization of a KV cache along the time axis
    (≙ the JAX package's function of the same name).

    kv [..., T, dh] → (payload int8 [..., T, dh], scales f32 [..., T//bt])
    where bt is the largest divisor of T that is <= block, so the payload
    keeps the cache's shape. One scale covers a [bt, dh] tile per leading
    index: amax / 127, 1.0 for an all-zero tile."""
    t, dh = kv.shape[-2], kv.shape[-1]
    bt = _fit_time_block(t, block)
    lead = tuple(kv.shape[:-2])
    tiles = kv.to(torch.float32).reshape(lead + (t // bt, bt, dh))
    amax = tiles.abs().amax(dim=(-1, -2), keepdim=True)
    sc = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(tiles / sc), -127, 127).to(torch.int8)
    return q.reshape(kv.shape), sc.reshape(lead + (t // bt,))


def dequantize_kv_time_blocks(q, scales, dtype=torch.float32):
    """Inverse of `quantize_kv_time_blocks`: payload int8 [..., T, dh] +
    scales [..., T//bt] → dequantized [..., T, dh] in `dtype`."""
    t, dh = q.shape[-2], q.shape[-1]
    nb = scales.shape[-1]
    lead = tuple(q.shape[:-2])
    tiles = q.to(torch.float32).reshape(lead + (nb, t // nb, dh))
    out = tiles * scales.to(torch.float32)[..., :, None, None]
    return out.reshape(q.shape).to(dtype)


def _rows4(q, bias):
    """q [R,nh,dh] / bias [R,nh,T] (one query position) as the G = 1 case
    of q [R,nh,G,dh] / bias [R,nh,G,T]; returns (q4, bias4, squeezed)."""
    if q.dim() == 3:
        return q.unsqueeze(2), bias.unsqueeze(2), True
    return q, bias, False


def decode_attention_plain(q, k, v, bias, scale, k_scale=None, v_scale=None):
    """q [R, nh, G, dh] (or [R, nh, dh]: one position), k/v [R, nh, T, dh]
    float32, or int8 with their scales [R, nh, T//bt], bias [R, nh, G, T]
    (or [R, nh, T]) → q's shape in q's dtype; every step in float32 after
    an int8 cache is dequantized to q's dtype."""
    q4, b4, squeezed = _rows4(q, bias)
    kf = (dequantize_kv_time_blocks(k, k_scale, q.dtype) if k_scale
          is not None else k).float()
    vf = (dequantize_kv_time_blocks(v, v_scale, q.dtype) if v_scale
          is not None else v).float()
    s = (q4.float().unsqueeze(3) * kf.unsqueeze(2)).sum(-1) * scale \
        + b4.float()
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    w = p / p.sum(-1, keepdim=True)
    out = (w.unsqueeze(-1) * vf.unsqueeze(2)).sum(3).to(q.dtype)
    return out.squeeze(2) if squeezed else out


def _bind(lib):
    if getattr(lib, "_ptt_bound", False):
        return
    c_ll, c_int, c_vp = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    lib.ptt_decode_attention.argtypes = [
        c_int, c_int, c_int, c_vp, c_vp, c_vp, c_vp, c_vp, c_int, c_int,
        c_vp, c_vp, c_vp, c_int, c_int, c_int, c_int, c_int, c_int, c_ll,
        c_ll, c_ll, ctypes.c_float, c_vp]
    lib.ptt_decode_attention.restype = c_int
    lib.ptt_decode_attention_chunk.argtypes = [c_int] * 4
    lib.ptt_decode_attention_chunk.restype = c_int
    lib._ptt_bound = True


def decode_attention_chunk(r, nh, t, dh, device=None):
    """Positions per block a call at this shape takes on `device` (default:
    the current CUDA device): the kernel splits the cache of each row and
    head into ceil(t / chunk) chunks, one block each, and merges their
    partials (csrc/decode_attention.cu `chunk_len` chooses; neither the
    query width nor the cache type enters). Raises for a shape the kernel
    does not take."""
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


def _check_scales(name, sc, cache, r, nh, t, dev):
    if cache.dtype == torch.int8:
        if sc is None:
            raise ValueError(f"decode_attention_cuda: an int8 {name} needs "
                             f"its scales ({name}_scale)")
        if sc.device != dev or sc.dtype != torch.float32 or sc.dim() != 3 \
                or tuple(sc.shape[:2]) != (r, nh) or sc.shape[2] < 1 \
                or t % sc.shape[2] or not sc.is_contiguous():
            raise ValueError(
                f"decode_attention_cuda: {name}_scale must be float32 "
                f"[R, nh, T//bt] contiguous on {dev} with bt dividing "
                f"T={t}, got {tuple(sc.shape)} {sc.dtype} on {sc.device}")
        return sc
    if sc is not None:
        raise ValueError(f"decode_attention_cuda: {name}_scale given for a "
                         f"{cache.dtype} cache")
    return None


def _decode_attention_launch(q4, k, v, b4, scale, k_scale, v_scale):
    """`ptpu::decode_attention` on CUDA tensors: q [R, nh, G, dh], bias
    [R, nh, G, T]. Checks, allocates the output and the partials, launches
    the split kernel and the merge (one call), counts it."""
    r, nh, g, dh = q4.shape
    t = k.shape[2]
    dev = q4.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, b4)):
        raise ValueError("decode_attention_cuda: every tensor must be on "
                         "the same CUDA device")
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention_cuda: q must be float32 or "
                        f"bfloat16, got {q4.dtype}")
    if k.dtype not in _CACHE_TYPES or v.dtype not in _CACHE_TYPES \
            or b4.dtype != torch.float32:
        raise TypeError(f"decode_attention_cuda: K and V must be float32, "
                        f"bfloat16 or int8 (the caches' types) and bias "
                        f"float32, got {k.dtype}, {v.dtype}, {b4.dtype}")
    if tuple(k.shape) != (r, nh, t, dh) or tuple(v.shape) != (r, nh, t, dh) \
            or tuple(b4.shape) != (r, nh, g, t):
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q4.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} bias "
                         f"{tuple(b4.shape)} do not agree")
    if not (q4.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()) or b4.stride(3) != 1:
        raise ValueError("decode_attention_cuda: q, K, V must be contiguous "
                         "and bias unit-stride along T")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention_cuda: head dim {dh} outside "
                         f"[1, {MAX_HEAD_DIM}]")
    ks = _check_scales("k", k_scale, k, r, nh, t, dev)
    vs = _check_scales("v", v_scale, v, r, nh, t, dev)
    n_split = -(-t // decode_attention_chunk(r, nh, t, dh, dev))
    lib = kernels.load("decode_attention")
    with torch.cuda.device(dev):
        out = torch.empty((r, nh, g, dh), dtype=q4.dtype, device=dev)
        # each chunk's partial per query row: its context sum, max and sum
        # of exp
        part = torch.empty((r * nh, n_split, g, dh + 2),
                           dtype=torch.float32, device=dev)
        err = lib.ptt_decode_attention(
            int(q4.dtype == torch.bfloat16), _CACHE_TYPES[k.dtype],
            _CACHE_TYPES[v.dtype], q4.data_ptr(), k.data_ptr(), v.data_ptr(),
            ks.data_ptr() if ks is not None else None,
            vs.data_ptr() if vs is not None else None,
            ks.shape[2] if ks is not None else 1,
            vs.shape[2] if vs is not None else 1, b4.data_ptr(),
            out.data_ptr(), part.data_ptr(), n_split, r, nh, g, t, dh,
            b4.stride(0), b4.stride(1), b4.stride(2), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
        kernels.check(lib, "decode_attention", err)
    kernels.count_launch("decode_attention")
    if g > 1:
        kernels.count_launch("decode_attention_multi")
    if ks is not None or vs is not None:
        kernels.count_launch("decode_attention_int8")
    return out


kernel_ops.impl("decode_attention", _decode_attention_launch)


def decode_attention_cuda(q, k, v, bias, scale, k_scale=None, v_scale=None):
    """Launch the CUDA kernel (`ptpu::decode_attention`): q [R, nh, G, dh]
    (or [R, nh, dh], one position) float32 or bfloat16 contiguous; k/v
    [R, nh, T, dh] contiguous, each float32, bfloat16, or int8 with its
    scales float32 [R, nh, T//bt] from `quantize_kv_time_blocks`; bias
    [R, nh, G, T] (or [R, nh, T]) float32 with unit stride along T (any
    other strides, 0 included). Returns q's shape in q's dtype, for head
    dims up to 512, T up to 65535 chunks of the cache
    (`decode_attention_chunk`; a chunk is 16 to 256 positions, so T
    reaches about 1M at dh 512 and 16M at dh 32) and any G >= 1. Raises on
    anything else."""
    q4, b4, squeezed = _rows4(q, bias)
    kernel_ops.require_cuda("decode_attention_cuda", q4, k, v, b4)
    out = torch.ops.ptpu.decode_attention(q4, k, v, b4, float(scale),
                                          k_scale, v_scale)
    return out.squeeze(2) if squeezed else out


#: the JAX package's `backend=` names (its decode_attention.py): "pallas"
#: is the kernel; "xla" and "pallas_interpret" name its plain versions
BACKENDS = ("xla", "pallas", "pallas_interpret")


def fused_decode_attention(q, k, v, bias, scale=1.0, backend=None,
                           k_scale=None, v_scale=None):
    """One decode tick (or verify window) of cached attention.

    q [..., nh, G, dh] (G query positions: 1 for the plain decode tick,
    γ+1 for a speculative verify forward), k/v [..., nh, T, dh] (the KV
    cache, broadcastable over the leading dims), bias broadcastable to
    [..., nh, G, T] (additive mask hiding cache positions beyond each
    query's position — causal within the verify window). Returns
    [..., nh, G, dh] in q's dtype: softmax(q·K^T·scale + bias)·V.

    int8 caches: pass the payloads with `k_scale` / `v_scale` from
    `quantize_kv_time_blocks` ([..., nh, T//bt] float32); the kernel reads
    the int8 payload and dequantizes it to q's dtype where it is used.

    `backend` takes the JAX package's names: None and "pallas" run the
    kernel on a CUDA tensor and the plain version on a CPU tensor; "xla"
    and "pallas_interpret" ask for the plain version, which a CPU tensor
    takes and a CUDA tensor refuses (it launches the kernel or raises)."""
    enforce(backend is None or backend in BACKENDS,
            f"fused_decode_attention: unknown backend {backend!r}; the "
            f"names are {list(BACKENDS)} (or None)",
            exc=InvalidArgumentError)
    enforce(backend in (None, "pallas") or not q.is_cuda,
            f"fused_decode_attention: backend {backend!r} asks for the "
            f"plain version, but q is a CUDA tensor, which runs the "
            f"kernel: pass backend=None or 'pallas'",
            exc=InvalidArgumentError)
    lead = tuple(q.shape[:-3])
    nh, g, dh = q.shape[-3:]
    t = k.shape[-2]
    r = 1
    for d in lead:
        r *= d

    def rows(x, tail):
        return None if x is None else \
            x.expand(lead + tuple(x.shape[-tail:])).reshape(
                (r,) + tuple(x.shape[-tail:]))

    q4 = q.reshape(r, nh, g, dh)
    k4, v4 = rows(k, 3), rows(v, 3)
    ks, vs = rows(k_scale, 2), rows(v_scale, 2)
    # the mask is usually one row per slot shared by every head: keep the
    # head stride 0 instead of materializing the broadcast
    bias4 = bias.to(torch.float32).expand(lead + (nh, g, t)).reshape(
        r, nh, g, t)
    out = _DecodeAttention.apply(q4, k4, v4, bias4, scale, ks, vs)
    return out.reshape(lead + (nh, g, dh))


class _DecodeAttention(torch.autograd.Function):
    """The kernel (CUDA tensors) or the plain version (CPU tensors)
    forward; the backward differentiates the plain version on the saved
    inputs (≙ `_decode_attention_bwd`): q, K, V (float32 caches), bias and
    the int8 caches' scales; an int8 payload takes none. Under `no_grad`,
    as on the serving tick, `apply` records no graph."""

    @staticmethod
    def forward(ctx, q4, k4, v4, bias4, scale, ks, vs):
        ctx.scale = scale
        ctx.save_for_backward(q4, k4, v4, bias4, ks, vs)
        if q4.is_cuda:
            return decode_attention_cuda(
                q4.contiguous(), k4.contiguous(), v4.contiguous(), bias4,
                scale, None if ks is None else ks.contiguous(),
                None if vs is None else vs.contiguous())
        return decode_attention_plain(q4, k4, v4, bias4, scale, ks, vs)

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        need = list(ctx.needs_input_grad[:4]) + \
            list(ctx.needs_input_grad[5:7])
        args = list(saved[:4]) + list(saved[4:6])
        with torch.enable_grad():
            leaves = [None if a is None else
                      a.detach().requires_grad_(n and a.is_floating_point())
                      for a, n in zip(args, need)]
            out = decode_attention_plain(*leaves[:4], ctx.scale, *leaves[4:])
            wrt = [a for a in leaves if a is not None and a.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, dout)) if wrt \
                else iter(())
        got = [next(grads) if a is not None and a.requires_grad else None
               for a in leaves]
        return tuple(got[:4]) + (None,) + tuple(got[4:])


@register_op("fused_decode_attention")
def _fused_decode_attention_op(ctx, ins, attrs):
    """Fused Q·K^T+bias→softmax→·V over a KV cache for a query of G
    positions (emitted by `fuse_decode_attention_pass` from the 4-op decode
    chain: G = 1 on the decode tick, γ+1 on a verify forward)."""
    ks, vs = ins.get("KScale"), ins.get("VScale")
    out = fused_decode_attention(ins["Q"][0], ins["K"][0], ins["V"][0],
                                 ins["Bias"][0],
                                 scale=attrs.get("scale", 1.0),
                                 k_scale=ks[0] if ks else None,
                                 v_scale=vs[0] if vs else None)
    return {"Out": [out]}
