"""Collective primitives over mesh axes, and block-quantized transfers.

≙ paddle_tpu/parallel/collective.py. The JAX package's collectives are
lax primitives compiled into one SPMD program (they must run inside
shard_map); the port's run among the processes of the current mesh's
axis group (`mesh.current_mesh()`: a `with mesh:` block, or the mesh a
ParallelExecutor step runs over) through torch.distributed — NCCL on the
cards, gloo on the CPU. Without a joined world each is the identity over
an axis of size 1 and raises over a larger one (`DeviceMesh.group`).

The differentiable ones carry the JAX transpose as a
torch.autograd.Function: all_reduce ↔ all_reduce (psum's transpose),
all_gather ↔ reduce_scatter, all_to_all ↔ the reverse all_to_all,
ppermute ↔ the inverse permutation. No collective failure is caught:
a rank that cannot reach its peers fails at the group's timeout.

Quantized transfers (≙ EQuARX, PAPERS.md): a gradient crosses the wire
as int8 plus one float32 scale per block (or as bfloat16); the sum is a
reduce-scatter phase (all_to_all of the compressed per-destination chunks,
dequantize-summed in float32 by their owner) and an all-gather phase of
the re-compressed owned chunk. Payloads and scales equal the JAX
package's byte for byte on the same input: both divide by the scale and
round half to even.

2-D block quantization for weights at rest (weight-only serving): weights
want per-tile scales so a single outlier row does not flatten a whole
matrix: tiles are (br, bc) sub-blocks of the 2-D weight, each with one
float32 scale. int4 halves the payload again by packing two nibbles per
int8 byte along the column axis (the column count must be even).
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

import torch

from ..core.enforce import InvalidArgumentError
from .mesh import DeviceMesh, current_mesh, shard_map  # noqa: F401


def _dist():
    import torch.distributed as dist
    return dist


def axis_size(axis_name: str) -> int:
    """The size of a named axis of the current mesh (1 when absent)."""
    return current_mesh().axis_size(axis_name)


def axis_index(axis_name: str) -> int:
    """This rank's coordinate on a named axis of the current mesh."""
    return current_mesh().axis_index(axis_name)


def _group(axis_name: str):
    return current_mesh().group(axis_name)


def _ar(x, group, op=None):
    out = x.contiguous().clone()
    dist = _dist()
    dist.all_reduce(out, op=op or dist.ReduceOp.SUM, group=group)
    return out


def _ag(x, group, n, dim):
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist = _dist()
    (getattr(dist, "all_gather_single", None)
     or dist.all_gather_into_tensor)(out, xm, group=group)
    return out.movedim(0, dim)


def _rs(x, group, n, dim):
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist = _dist()
    (getattr(dist, "reduce_scatter_single", None)
     or dist.reduce_scatter_tensor)(out, xm, group=group)
    return out.movedim(0, dim)


def _a2a(x, group, n, split_dim, concat_dim):
    xm = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xm)
    _dist().all_to_all_single(out, xm, group=group)
    chunks = out.chunk(n, dim=0)
    return torch.cat([c.movedim(0, split_dim) for c in chunks],
                     dim=concat_dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ar(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _ag(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _rs(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return _rs(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_dim, concat_dim):
        ctx.args = (group, n, split_dim, concat_dim)
        return _a2a(x, group, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, n, split_dim, concat_dim = ctx.args
        return _a2a(g, group, n, concat_dim, split_dim), None, None, None, \
            None


def all_reduce(x, axis_name: str):
    """Sum across an axis (≙ ncclAllReduce, all_reduce_op_handle.cc); its
    gradient is the all-reduce of the cotangent."""
    group = _group(axis_name)
    if group is None:
        return x
    return _AllReduce.apply(x, group)


def all_reduce_mean(x, axis_name: str):
    return all_reduce(x, axis_name) / axis_size(axis_name)


def reduce_scatter(x, axis_name: str, scatter_dim: int = 0):
    """≙ the Reduce-to-owner half of ReduceOpHandle (reduce_op_handle.h:34),
    generalized: every rank owns an equal slice of the reduction (tiled on
    `scatter_dim`)."""
    n = axis_size(axis_name)
    if not 0 <= scatter_dim < x.dim():
        raise InvalidArgumentError(
            f"reduce_scatter: scatter_dim {scatter_dim} out of range for "
            f"rank-{x.dim()} input")
    if x.shape[scatter_dim] % n != 0:
        raise InvalidArgumentError(
            f"reduce_scatter: dim {scatter_dim} of shape {tuple(x.shape)} is "
            f"not divisible by the {axis_name!r} axis size {n}; pad the "
            f"scattered dimension to a multiple of {n} (each shard owns an "
            f"equal slice of the reduction) or scatter a different dim")
    group = _group(axis_name)
    if group is None:
        return x
    return _ReduceScatter.apply(x, group, n, scatter_dim)


def all_gather(x, axis_name: str, gather_dim: int = 0):
    """The blocks of every rank of the axis, concatenated on `gather_dim`
    in coordinate order (≙ BroadcastOpHandle, broadcast_op_handle.h:35)."""
    group = _group(axis_name)
    if group is None:
        return x
    return _AllGather.apply(x, group, axis_size(axis_name),
                            gather_dim % max(x.dim(), 1))


def all_to_all(x, axis_name: str, split_dim: int, concat_dim: int):
    """Block j of `split_dim` goes to coordinate j; what arrives is
    concatenated on `concat_dim` in source order (jax's tiled
    all_to_all)."""
    group = _group(axis_name)
    if group is None:
        return x
    n = axis_size(axis_name)
    if x.shape[split_dim] % n != 0:
        raise InvalidArgumentError(
            f"all_to_all: dim {split_dim} of shape {tuple(x.shape)} is not "
            f"divisible by the {axis_name!r} axis size {n}")
    return _AllToAll.apply(x, group, n, split_dim, concat_dim)


def _ppermute(x, axis_name, perm):
    """x moves from coordinate src to dst for each (src, dst) in `perm`;
    a coordinate no pair sends to receives zeros (jax's ppermute)."""
    mesh = current_mesh()
    group = mesh.group(axis_name)
    me = mesh.axis_index(axis_name)
    peers = mesh.axis_ranks(axis_name)
    x = x.contiguous()
    out = torch.zeros_like(x)
    dist = _dist()
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, peers[dst], group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, peers[src], group))
    batch_p2p(ops)
    return out


def batch_p2p(ops):
    """Run a list of `dist.P2POp`s as one `batch_isend_irecv` and wait for
    them. The call runs inside a profiler range naming its sends' bytes
    (`costs.P2P_SEND_RANGE`): on the cards the group is coalesced, and the
    profiler records its sends with no tensor shapes, so the measured
    census reads their sizes there."""
    if not ops:
        return
    from torch.autograd.profiler import record_function

    from ..framework.costs import P2P_SEND_RANGE
    dist = _dist()
    sizes = ",".join(str(op.tensor.numel() * op.tensor.element_size())
                     for op in ops if op.op is dist.isend)
    with record_function(P2P_SEND_RANGE + sizes):
        works = dist.batch_isend_irecv(ops)
    for w in works:
        w.wait()


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, perm):
        # the backward may run after the caller left its `with mesh:`
        ctx.mesh, ctx.axis_name, ctx.perm = current_mesh(), axis_name, perm
        return _ppermute(x, axis_name, perm)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        with ctx.mesh:
            return _ppermute(g, ctx.axis_name, inv), None, None


def ppermute(x, axis_name: str, perm: Sequence[tuple]):
    if _group(axis_name) is None:
        return x if any(s == d for s, d in perm) else torch.zeros_like(x)
    return _PPermute.apply(x, axis_name, tuple(tuple(p) for p in perm))


def ring_perm(axis_size: int) -> list:
    """The forward ring permutation shard i -> (i+1) % n — the one schedule
    shared by ring attention and the pipeline."""
    return [(i, (i + 1) % axis_size) for i in range(axis_size)]


def shift_right(x, axis_name: str, axis_size: int):
    """Ring shift: shard i -> shard (i+1) % n."""
    return ppermute(x, axis_name, ring_perm(axis_size))


def shift_left(x, axis_name: str, axis_size: int):
    perm = [((i + 1) % axis_size, i) for i in range(axis_size)]
    return ppermute(x, axis_name, perm)


def sharded(mesh: DeviceMesh, in_specs, out_specs,
            check_rep: bool = False) -> Callable:
    """Decorator: run fn as per-rank code over `mesh` (`mesh.shard_map`):
    its arguments arrive as this rank's blocks, its outputs are gathered
    back over the axes `out_specs` names."""
    def deco(fn):
        smapped = shard_map(fn, mesh=mesh, in_specs=in_specs,
                            out_specs=out_specs, check_rep=check_rep)
        return functools.wraps(fn)(smapped)
    return deco


# ---------------------------------------------------------------------------
# Quantized collectives (block-scaled compress -> collective -> decompress)
# ---------------------------------------------------------------------------

QUANT_BLOCK = 256           # default block: one f32 scale per 256 values
_QUANT_WIRE_DTYPES = ("int8", "bf16")


def quantize_blocks(flat, block: int = QUANT_BLOCK):
    """Block-scaled symmetric int8 quantization of a flat float32 vector
    whose length is a multiple of `block`. Returns (q int8 [n//block,
    block], scales float32 [n//block, 1]); zero blocks get scale 1 so they
    stay exact."""
    if flat.dim() != 1 or flat.shape[0] % block != 0:
        raise InvalidArgumentError(
            f"quantize_blocks wants a flat block-multiple vector, got shape "
            f"{tuple(flat.shape)} for block {block}")
    xb = flat.to(torch.float32).reshape(-1, block)
    amax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_blocks(q, scale):
    """Inverse of quantize_blocks: flat float32 vector."""
    return (q.to(torch.float32) * scale).reshape(-1)


def _compress(flat, wire_dtype: str, block: int):
    """flat float32 -> (payload, scales-or-None) in the wire dtype."""
    if wire_dtype == "int8":
        return quantize_blocks(flat, block)
    if wire_dtype == "bf16":
        return flat.to(torch.bfloat16), None
    raise InvalidArgumentError(
        f"unknown comm wire dtype {wire_dtype!r}; "
        f"expected one of {_QUANT_WIRE_DTYPES}")


def _decompress(payload, scales):
    if scales is None:
        return payload.to(torch.float32).reshape(-1)
    return dequantize_blocks(payload, scales)


def compressed_size_ratio(wire_dtype: str, block: int = QUANT_BLOCK) -> float:
    """Analytic bytes-on-wire ratio vs float32 for one compressed
    transfer."""
    if wire_dtype == "int8":
        return (1.0 + 4.0 / block) / 4.0
    if wire_dtype == "bf16":
        return 0.5
    return 1.0


def _padded_chunks(flat, n, block):
    chunk = flat.shape[0] // n
    cpad = -(-chunk // block) * block
    xb = torch.nn.functional.pad(flat.reshape(n, chunk), (0, cpad - chunk))
    return xb, chunk, cpad


def quantized_reduce_scatter_flat(flat, axis_name: str, *,
                                  wire_dtype: str = "int8",
                                  block: int = QUANT_BLOCK,
                                  mean: bool = False):
    """Phase 1 of the quantized all-reduce: each rank contributes its local
    partial `flat` (length divisible by the axis size) and receives the
    fully reduced chunk it owns, float32, length len(flat)//axis_size.
    Each destination chunk is compressed on its own (block padding
    included), so a chunk boundary never splits a scale block."""
    n = axis_size(axis_name)
    if flat.dim() != 1 or flat.shape[0] % n != 0:
        raise InvalidArgumentError(
            f"quantized_reduce_scatter_flat wants a flat vector divisible by "
            f"the {axis_name!r} axis size {n}, got {tuple(flat.shape)}")
    xb, chunk, cpad = _padded_chunks(flat, n, block)
    payload, scales = _compress(xb.reshape(-1), wire_dtype, block)
    # rank i receives every peer's compressed version of chunk i
    payload = all_to_all(payload.reshape(n, -1), axis_name, 0, 0)
    if scales is not None:
        scales = all_to_all(scales.reshape(n, -1), axis_name, 0, 0)
        part = (payload.reshape(n, cpad // block, block).to(torch.float32)
                * scales.reshape(n, cpad // block, 1))
    else:
        part = payload.to(torch.float32)
    part = part.reshape(n, cpad).sum(dim=0)[:chunk]
    if mean:
        part = part / n
    return part


def quantization_residual_flat(flat, n: int, *, wire_dtype: str = "int8",
                               block: int = QUANT_BLOCK):
    """What phase 1 loses for THIS rank's contribution: flat minus the
    dequantized form of its compressed transfer, in the padded
    per-destination-chunk layout quantized_reduce_scatter_flat puts on the
    wire. The error-feedback accumulator's update."""
    xb, chunk, cpad = _padded_chunks(flat, n, block)
    payload, scales = _compress(xb.reshape(-1), wire_dtype, block)
    deq = _decompress(payload, scales).reshape(n, cpad)[:, :chunk]
    return flat - deq.reshape(-1)


def quantized_all_gather_flat(chunk, axis_name: str, *,
                              wire_dtype: str = "int8",
                              block: int = QUANT_BLOCK):
    """Phase 2: compress the owned chunk, all_gather, decompress. Returns
    the concatenation over ranks, float32, length len(chunk) *
    axis_size."""
    n = axis_size(axis_name)
    c = chunk.shape[0]
    cpad = -(-c // block) * block
    padded = torch.nn.functional.pad(chunk, (0, cpad - c))
    payload, scales = _compress(padded, wire_dtype, block)
    payload = all_gather(payload, axis_name, 0)
    if scales is not None:
        scales = all_gather(scales, axis_name, 0)
    full = _decompress(payload, scales).reshape(n, cpad)[:, :c]
    return full.reshape(-1)


def quantized_all_reduce_flat(flat, axis_name: str, *,
                              wire_dtype: str = "int8",
                              block: int = QUANT_BLOCK,
                              mean: bool = False):
    """Block-scaled quantized all-reduce of a flat vector (length divisible
    by the axis size): quantized reduce-scatter + quantized all-gather.
    Wire bytes ~= 2 * len(flat) * (1 + 4/block) for int8 vs 8 * len(flat)
    for the float32 ring."""
    part = quantized_reduce_scatter_flat(flat, axis_name,
                                         wire_dtype=wire_dtype, block=block,
                                         mean=mean)
    return quantized_all_gather_flat(part, axis_name, wire_dtype=wire_dtype,
                                     block=block)


# ---------------------------------------------------------------------------
# 2-D block quantization for weights at rest (weight-only serving)
# ---------------------------------------------------------------------------

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
