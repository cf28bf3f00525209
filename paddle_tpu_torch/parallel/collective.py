"""2-D block quantization for weights at rest (weight-only serving).

≙ paddle_tpu/parallel/collective.py:156-240, in torch. Weights want
per-tile scales so a single outlier row does not flatten a whole matrix:
tiles are (br, bc) sub-blocks of the 2-D weight, each with one float32
scale. int4 halves the payload again by packing two nibbles per int8 byte
along the column axis (the column count must be even). Payloads and scales
equal the JAX package's byte for byte on the same weight: both divide (not
multiply by a reciprocal) and both round half to even.

The gradient collectives of the JAX module wait for the multi-GPU item
(ROADMAP.md §1 item 4).
"""

from __future__ import annotations

import torch

from ..core.enforce import InvalidArgumentError

QUANT_BLOCK_2D = 64         # default tile edge: one f32 scale per <=64x64 tile


def block_dims_2d(shape, block: int = QUANT_BLOCK_2D):
    """Largest tile dims <= `block` that divide each axis of `shape` exactly
    (falls back toward 1, which always divides), so payloads keep the exact
    declared weight shape — no padding bytes."""
    def fit(n):
        b = min(block, n)
        while n % b:
            b -= 1
        return b
    return fit(shape[0]), fit(shape[1])


def quantize_blocks_2d(w, bits: int = 8, block: int = QUANT_BLOCK_2D):
    """Tile-scaled symmetric quantization of a 2-D float32 matrix.

    Returns (payload int8 [R, C] — or [R, C//2] nibble-packed when bits=4 —
    and scales float32 [R//br, C//bc]). Zero tiles get scale 1 so they stay
    exact; int4 clips to [-7, 7] before packing. `w` may be a tensor or a
    numpy array; the results lie where `w` does (the CPU for numpy)."""
    w = torch.as_tensor(w)
    if w.dim() != 2:
        raise InvalidArgumentError(
            f"quantize_blocks_2d wants a 2-D matrix, got shape "
            f"{tuple(w.shape)}")
    if bits not in (8, 4):
        raise InvalidArgumentError(
            f"quantize_blocks_2d supports bits in (8, 4), got {bits}")
    r, c = w.shape
    if bits == 4 and c % 2 != 0:
        raise InvalidArgumentError(
            f"int4 packing needs an even column count, got shape "
            f"{tuple(w.shape)}")
    br, bc = block_dims_2d(w.shape, block)
    t = w.to(torch.float32).reshape(r // br, br, c // bc, bc)
    amax = t.abs().amax(dim=(1, 3), keepdim=True)
    qmax = 127.0 if bits == 8 else 7.0
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(t / scale), -qmax, qmax).to(torch.int8)
    q = q.reshape(r, c)
    if bits == 4:
        q = pack_int4(q)
    return q, scale.reshape(r // br, c // bc)


def dequantize_blocks_2d(q, scales, bits: int = 8):
    """Inverse of quantize_blocks_2d: float32 matrix [R, C]. `scales` carries
    the tile grid [R//br, C//bc]; the payload is nibble-unpacked when
    bits=4."""
    if bits == 4:
        q = unpack_int4(q)
    r, c = q.shape
    nr, nc = scales.shape
    t = q.to(torch.float32).reshape(nr, r // nr, nc, c // nc)
    return (t * scales[:, None, :, None]).reshape(r, c)


def pack_int4(q):
    """Pack an int8 matrix with values in [-7, 7] into nibbles: columns
    (2k, 2k+1) share byte k as (low, high). Returns int8 [R, C//2]."""
    q = q.to(torch.int16)
    lo, hi = q[:, 0::2] & 0x0F, q[:, 1::2] & 0x0F
    # the byte's bit pattern, read back as two's complement
    return ((hi << 4) | lo).to(torch.uint8).view(torch.int8)


def unpack_int4(p):
    """Inverse of pack_int4: int8 [R, C2] -> int8 [R, 2*C2], each nibble
    sign-extended (two's complement)."""
    p = p.to(torch.int16)
    lo = ((p & 0x0F) ^ 0x08) - 0x08
    hi = p >> 4                   # arithmetic: the high nibble, signed
    return torch.stack([lo, hi], dim=-1).reshape(p.shape[0], -1).to(
        torch.int8)
