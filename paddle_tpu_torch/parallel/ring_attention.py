"""Ring attention: exact attention over sequences split across ranks.

≙ paddle_tpu/parallel/ring_attention.py. Q, K, V are split on the
sequence dim over the `sp` axis group; each rank runs its query block
against every K/V block in turn while the K/V blocks rotate around the
ring (`collective.ppermute`, a `dist.batch_isend_irecv` of each hop),
merging the per-block softmax results by their logsumexp, so no rank
holds the [T, T] scores or the whole K/V.

Each step's block goes through the hand-written flash kernels: K1
(`ops/flash_attention.py` `flash_fwd_cuda`, with lse) in the forward,
K2 / K3 (`flash_bwd_dq_cuda` / `flash_bwd_dkv_cuda`) in the backward,
with the GLOBAL logsumexp and delta passed in (the flash backward is
block-decomposable: p = exp(s - lse) is the block's slice of the global
softmax). On CPU tensors the plain versions run, as everywhere in the
port. The backward is one ring-level autograd Function that re-runs the
ring, rotating the dK / dV accumulators (float32) home with the blocks.

`_step_case` is the JAX package's case analysis: a causal step whose held
block lies wholly in the query block's future, or a packed step whose
segment-id ranges cannot meet, computes nothing; a causal ring of n blocks
launches K1 n(n+1)/2 times. A query row that sees no key of a held block
gets o = 0 and a logsumexp at the kernels' floor (-1e30), which the merge
gives weight 0, so masked rows stay finite.

The ring's steps take their held block from a transport: the ring itself
(`_RingHops`, one hop per step), or the whole K / V held in one process
and indexed (`_IndexedBlocks`, `ring_forward_local` /
`ring_backward_local`) — the same schedule and block functions, checked
on one card at full width.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import (flash_bwd_dkv_cuda, flash_bwd_dq_cuda,
                                   flash_bwd_plain, flash_delta,
                                   flash_fwd_cuda, flash_fwd_plain)
from . import collective as C
from .mesh import DATA_AXIS, SEQUENCE_AXIS, DeviceMesh, shard_map

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# one ring step
# ---------------------------------------------------------------------------


def block_forward(q, k, v, scale, causal, q_ids=None, kv_ids=None):
    """One ring block: q, k, v [B, H, t, D] -> (o float32 [B, H, t, D],
    lse float32 [B, H, t]) through K1 (the plain version on the CPU). o is
    the kernel's output in q's dtype, widened."""
    if q.is_cuda:
        o, lse = flash_fwd_cuda(q, k, v, scale, causal, q_ids, kv_ids)
    else:
        o, lse = flash_fwd_plain(q, k, v, scale, causal, q_ids, kv_ids)
    return o.float(), lse


def block_backward(q, k, v, do, lse, delta, scale, causal, q_ids=None,
                   kv_ids=None):
    """One ring block's (dq, dk, dv) against the GLOBAL lse and delta,
    through K2 and K3 (the plain version on the CPU)."""
    if q.is_cuda:
        dq = flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal,
                               q_ids, kv_ids)
        dk, dv = flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal,
                                    q_ids, kv_ids)
        return dq, dk, dv
    return flash_bwd_plain(q, k, v, None, lse, do, scale, causal, q_ids,
                           kv_ids, delta=delta)


def merge(o_acc, lse_acc, o_r, lse_r):
    """Logsumexp merge of a block's normalized output into the running one
    (≙ `_merge`: lse = logaddexp, o weighted by exp(lse_i - lse)). A row
    dead in both (lse at the -1e30 floor) stays o = 0, lse = -1e30."""
    m = torch.maximum(lse_acc, lse_r)
    live = m > _NEG_INF / 2
    m0 = torch.where(live, m, torch.zeros_like(m))
    w_acc = torch.exp(lse_acc - m0)
    w_r = torch.exp(lse_r - m0)
    tot = w_acc + w_r
    lse = torch.where(live, m0 + torch.log(tot.clamp_min(1e-30)),
                      torch.full_like(m, _NEG_INF))
    inv = torch.where(live, 1.0 / tot.clamp_min(1e-30), torch.zeros_like(m))
    o = o_acc * (w_acc * inv)[..., None] + o_r * (w_r * inv)[..., None]
    return o, lse


def step_case(r: int, idx: int, n: int, causal: bool, seg_q_minmax=None,
              seg_blk=None) -> int:
    """≙ `_step_case`: 0 full block, 1 diagonal (the causal mask applies
    inside it), 2 dead (computes nothing). At step r rank `idx` holds the
    block of rank (idx - r) % n. The segment test is the kernels'
    range-overlap test: no row's [min, max] id ranges meet -> dead. It
    reads the ids on the host (one sync a step of a packed ring)."""
    src = (idx - r) % n
    case = (1 if src == idx else 0 if src < idx else 2) if causal else 0
    if seg_blk is not None and case != 2:
        q_min, q_max = seg_q_minmax
        kv_min = seg_blk.amin(dim=1)
        kv_max = seg_blk.amax(dim=1)
        if not bool(((q_max >= kv_min) & (q_min <= kv_max)).any()):
            case = 2
    return case


# ---------------------------------------------------------------------------
# transports: where step r's held block comes from
# ---------------------------------------------------------------------------


class _RingHops:
    """The distributed ring: rank `idx` holds its own block at step 0 and
    passes what it holds to rank idx + 1 after each step; the dK / dV
    accumulators travel with their block."""

    def __init__(self, axis_name, k, v, seg):
        self.axis_name = axis_name
        self.n = C.axis_size(axis_name)
        self.idx = C.axis_index(axis_name)
        self.held = (k, v, seg)

    def block(self, r):
        return self.held

    def hop(self, r):
        k, v, seg = self.held
        sh = [C.shift_right(t, self.axis_name, self.n) if t is not None
              else None for t in (k, v, seg)]
        self.held = tuple(sh)

    def hop_grads(self, r, dk, dv):
        return (C.shift_right(dk, self.axis_name, self.n),
                C.shift_right(dv, self.axis_name, self.n))


class _IndexedBlocks:
    """One process holding every block: step r of rank `idx` indexes block
    (idx - r) % n instead of receiving it. The dK / dV accumulators stay
    with their block's index: `dks` / `dvs` (shared by every rank's
    transport) sum what each step computed for block j, as the ring's n
    hops bring it home."""

    def __init__(self, idx, n, ks, vs, segs, dks=None, dvs=None):
        self.idx, self.n = idx, n
        self.ks, self.vs, self.segs = ks, vs, segs
        self.dks, self.dvs = dks, dvs

    def block(self, r):
        j = (self.idx - r) % self.n
        return (self.ks[j], self.vs[j],
                None if self.segs is None else self.segs[j])

    def hop(self, r):
        pass

    def hop_grads(self, r, dk, dv):
        j = (self.idx - r) % self.n
        self.dks[j] += dk
        self.dvs[j] += dv
        return torch.zeros_like(dk), torch.zeros_like(dv)


# ---------------------------------------------------------------------------
# the ring's forward and backward on one rank
# ---------------------------------------------------------------------------


def _seg_minmax(seg):
    return None if seg is None else (seg.amin(dim=1), seg.amax(dim=1))


def ring_forward_steps(q, seg, transport, causal, scale):
    """Rank transport.idx's forward ring: q [B, H, t, D] against each held
    block. Returns (o float32, lse float32, live) with live the number of
    steps whose block computation ran."""
    n, idx = transport.n, transport.idx
    B, H, t, D = q.shape
    o_acc = torch.zeros((B, H, t, D), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((B, H, t), _NEG_INF, dtype=torch.float32,
                         device=q.device)
    live = 0
    mm = _seg_minmax(seg)
    for r in range(n):
        kb, vb, sb = transport.block(r)
        case = step_case(r, idx, n, causal, mm, sb)
        if case != 2:
            o_r, lse_r = block_forward(q, kb, vb, scale, case == 1, seg, sb)
            o_acc, lse_acc = merge(o_acc, lse_acc, o_r, lse_r)
            live += 1
        if r < n - 1:                        # n - 1 K/V hops exactly
            transport.hop(r)
    return o_acc, lse_acc, live


def ring_backward_steps(q, seg, lse, delta, do, transport, causal, scale):
    """Rank transport.idx's backward ring against the global (lse, delta):
    (dq, dk, dv) float32, dk / dv the accumulators after the transport's
    last `hop_grads` (on the ring: the rank's own K / V block's)."""
    n, idx = transport.n, transport.idx
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    mm = _seg_minmax(seg)
    kb, vb, _ = transport.block(0)
    dk_acc = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
    dv_acc = torch.zeros(vb.shape, dtype=torch.float32, device=q.device)
    for r in range(n):
        kb, vb, sb = transport.block(r)
        case = step_case(r, idx, n, causal, mm, sb)
        if case != 2:
            dq_r, dk_r, dv_r = block_backward(q, kb, vb, do, lse, delta,
                                              scale, case == 1, seg, sb)
            dq += dq_r.float()
            dk_acc = dk_acc + dk_r.float()
            dv_acc = dv_acc + dv_r.float()
        if r < n - 1:
            transport.hop(r)
        # the accumulators take all n hops: after the last step the held
        # block is rank idx + 1's, one more rotation brings it home
        dk_acc, dv_acc = transport.hop_grads(r, dk_acc, dv_acc)
    return dq, dk_acc, dv_acc


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, axis_name, causal, scale):
        o, lse, _ = ring_forward_steps(
            q, seg, _RingHops(axis_name, k, v, seg), causal, scale)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.seg, ctx.args = seg, (axis_name, causal, scale)
        # the backward may run after the caller left its `with mesh:`
        ctx.mesh = C.current_mesh()
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        axis_name, causal, scale = ctx.args
        g = g.contiguous()
        delta = flash_delta(o, g)
        with ctx.mesh:
            dq, dk, dv = ring_backward_steps(
                q, ctx.seg, lse, delta, g.to(q.dtype),
                _RingHops(axis_name, k, v, ctx.seg), causal, scale)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def _head_major(x):
    return x.transpose(1, 2).contiguous()


def ring_attention(q, k, v, *, axis_name: str = SEQUENCE_AXIS,
                   causal: bool = False, scale: Optional[float] = None,
                   segment_ids=None, backend: Optional[str] = None,
                   block_q: int = 512, block_k: int = 1024,
                   with_stats: bool = False):
    """Per-rank ring attention body over the `axis_name` group of the
    current mesh: q, k, v this rank's sequence blocks [B, t, H, D];
    segment_ids its [B, t] ids (packed batches). Returns this rank's
    output block [B, t, H, D], differentiable in q, k, v. `backend`,
    `block_q` and `block_k` are the JAX signature's (a TPU backend and
    its Pallas tiles); the port runs K1-K3 on a CUDA tensor and their
    plain versions on a CPU one. with_stats: also return how many ring
    steps computed a block on this rank (forward only)."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    seg = None if segment_ids is None else \
        torch.as_tensor(segment_ids).to(device=q.device,
                                        dtype=torch.int32).contiguous()
    qh, kh, vh = _head_major(q), _head_major(k), _head_major(v)
    if with_stats:
        with torch.no_grad():
            o, _, live = ring_forward_steps(
                qh, seg, _RingHops(axis_name, kh, vh, seg), causal,
                float(scale))
        return o.to(q.dtype).transpose(1, 2), live
    out = _RingAttention.apply(qh, kh, vh, seg, axis_name, bool(causal),
                               float(scale))
    return out.transpose(1, 2)


def ring_attention_sharded(mesh: DeviceMesh, q, k, v, *, causal=False,
                           scale=None, segment_ids=None, backend=None,
                           block_q: int = 512, block_k: int = 1024):
    """Global q, k, v [B, T, H, D] (the same on every rank of the mesh):
    each rank takes its (dp, sp) block and runs the ring over sp; returns
    the global attention output (gathered over dp and sp)."""
    if SEQUENCE_AXIS not in mesh.axes:
        raise ValueError(
            f"ring attention requires a {SEQUENCE_AXIS!r} axis in the mesh "
            f"(got axes {tuple(mesh.axes)}); for unsharded sequences use "
            f"plain attention")
    in_spec = mesh.pspec(DATA_AXIS, SEQUENCE_AXIS, None, None)
    seg_spec = mesh.pspec(DATA_AXIS, SEQUENCE_AXIS)

    if segment_ids is None:
        def body(q, k, v):
            return ring_attention(q, k, v, causal=causal, scale=scale)
        return shard_map(body, mesh=mesh, in_specs=(in_spec,) * 3,
                         out_specs=in_spec)(q, k, v)

    def body(q, k, v, seg):
        return ring_attention(q, k, v, causal=causal, scale=scale,
                              segment_ids=seg)
    return shard_map(body, mesh=mesh,
                     in_specs=(in_spec, in_spec, in_spec, seg_spec),
                     out_specs=in_spec)(q, k, v, torch.as_tensor(segment_ids))


def ring_attention_live_blocks(mesh: DeviceMesh, q, k, v, *, causal=False,
                               scale=None, segment_ids=None, backend=None):
    """Diagnostic entry: run the forward ring and return (out, the number
    of block computations executed across the ranks the computation is
    split over — dp and sp; a replicated axis is not summed). A causal
    ring over n ranks executes n(n+1)/2 of the n² blocks."""
    in_spec = mesh.pspec(DATA_AXIS, SEQUENCE_AXIS, None, None)
    seg_spec = mesh.pspec(DATA_AXIS, SEQUENCE_AXIS)
    args = [q, k, v] + ([] if segment_ids is None
                        else [torch.as_tensor(segment_ids)])
    specs = (in_spec,) * 3 + ((seg_spec,) if segment_ids is not None
                              else ())

    def body(*xs):
        seg = xs[3] if len(xs) > 3 else None
        out, live = ring_attention(xs[0], xs[1], xs[2], causal=causal,
                                   scale=scale, segment_ids=seg,
                                   with_stats=True)
        t = torch.tensor([float(live)], device=out.device)
        for a in (DATA_AXIS, SEQUENCE_AXIS):
            if a in mesh.axes:
                t = C.all_reduce(t, a)
        return out, t

    with torch.no_grad():
        out, live = shard_map(body, mesh=mesh, in_specs=specs,
                              out_specs=(in_spec, mesh.pspec()))(*args)
    return out, int(live.item())


# ---------------------------------------------------------------------------
# the whole ring in one process (the schedule at full width on one card)
# ---------------------------------------------------------------------------


def _blocks(x, n):
    return [b.contiguous() for b in x.chunk(n, dim=2)]


def ring_forward_local(q, k, v, n: int, *, causal: bool = False,
                       scale: Optional[float] = None, segment_ids=None):
    """Every rank's forward ring of an n-block split, run in this process
    with the held block indexed rather than sent. q, k, v [B, H, T, D]
    head-major; segment_ids [B, T]. Returns (o float32, lse float32,
    live): the same block functions and schedule as `ring_attention`."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    qs, ks, vs = _blocks(q, n), _blocks(k, n), _blocks(v, n)
    segs = None if segment_ids is None else [
        s.contiguous() for s in segment_ids.to(torch.int32).chunk(n, 1)]
    os_, lses, live = [], [], 0
    for idx in range(n):
        o, lse, lv = ring_forward_steps(
            qs[idx], None if segs is None else segs[idx],
            _IndexedBlocks(idx, n, ks, vs, segs), causal, float(scale))
        os_.append(o)
        lses.append(lse)
        live += lv
    return torch.cat(os_, dim=2), torch.cat(lses, dim=2), live


def ring_backward_local(q, k, v, o, lse, do, n: int, *,
                        causal: bool = False, scale: Optional[float] = None,
                        segment_ids=None):
    """Every rank's backward ring of an n-block split in this process,
    against the global lse and delta = Σ dO·O: (dq, dk, dv) float32
    [B, H, T, D]."""
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    delta = flash_delta(o, do)
    qs, ks, vs = _blocks(q, n), _blocks(k, n), _blocks(v, n)
    dos, lses, deltas = _blocks(do, n), [b.contiguous() for b in
                                         lse.chunk(n, 2)], \
        [b.contiguous() for b in delta.chunk(n, 2)]
    segs = None if segment_ids is None else [
        s.contiguous() for s in segment_ids.to(torch.int32).chunk(n, 1)]
    dqs = []
    dk = [torch.zeros(b.shape, dtype=torch.float32, device=q.device)
          for b in ks]
    dv = [torch.zeros_like(x) for x in dk]
    for idx in range(n):
        dq, _, _ = ring_backward_steps(
            qs[idx], None if segs is None else segs[idx], lses[idx],
            deltas[idx], dos[idx],
            _IndexedBlocks(idx, n, ks, vs, segs, dk, dv), causal,
            float(scale))
        dqs.append(dq)
    return torch.cat(dqs, 2), torch.cat(dk, 2), torch.cat(dv, 2)
