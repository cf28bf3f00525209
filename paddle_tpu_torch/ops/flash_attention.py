"""Fused attention: flash attention forward and backward as three CUDA
kernels, and the `fused_attention` op.

≙ paddle_tpu/ops/pallas_kernels.py, the counterpart of its Pallas TPU
kernels `_flash_kernel` (K1, forward), `_flash_bwd_dq_kernel` (K2, dQ) and
`_flash_bwd_dkv_kernel` (K3, dK and dV). The CUDA kernels are in
csrc/flash_attention.cu. Three pieces, as for every kernel of the port:

- `flash_fwd_cuda`, `flash_bwd_dq_cuda`, `flash_bwd_dkv_cuda` — wrappers of
  the hand-written kernels, called through the registered ops
  `ptpu::flash_fwd`, `ptpu::flash_bwd_dq` and `ptpu::flash_bwd_dkv`
  (kernel_ops.py), so a trace records each as one node. The ops' CUDA
  implementations check device, type, shape and layout,
  launch on the current stream, and add one to the count in
  `kernels.LAUNCHES` ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"; the
  bfloat16 launches, which run on the tensor cores, also to
  "flash_fwd_tc", "flash_bwd_dq_tc" and "flash_bwd_dkv_tc").
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

What a kernel may differ by from its plain version: float32 kernels
1e-5 · max(1, |ref|); the bfloat16 tensor-core K1, K2 and K3 the per-term
bounds `flash_fwd_bound`, `flash_bwd_dq_bound` and `flash_bwd_dkv_bound`
(`flash_check` applies each; `flash_control_masks` builds the wrong
kernels that the check must reject).

Masks: causal aligned bottom-right (query i sees keys up to i + Tk - Tq)
and segment ids (a query sees a key iff their ids are equal; the packed
batches of data/packing.py). Tensors are [B, H, T, D] in float32 or
bfloat16; the kernels are built for head dims 32, 64, 128 and 256, and
take any multiple of 128 above 256 on the wide-head route (D a runtime
argument, each block computing 128 columns of the output:
csrc/flash_attention.cu). The wrappers take any
D by zero-padding q, k, v (and dO) to the next head dim the kernels take
(`kernel_head_dim`, `pad_head_dim`) and slicing o, dq, dk and dv back.
That is exact: a zero column adds exactly 0 to every dot product and to
delta = Σ dO·O, and the caller's scale is passed unchanged. (At D = 256
each bfloat16 kernel's block computes one half of the output columns and
the float32 K2 and K3 take query tiles of 32 rows.) On the wide-head
route bfloat16 K1 and K2 run on the tensor cores, D split across a
cluster of up to 8 blocks that compute each score once and share it
through distributed shared memory; their launches count under
"flash_fwd_wide_tc" and "flash_bwd_dq_wide_tc". Float32 K1-K3 and
bfloat16 K3 there run float32 arithmetic on the CUDA cores, with the plain
version's rounding points, and count under "flash_fwd_wide",
"flash_bwd_dq_wide" and "flash_bwd_dkv_wide" (`launch_route`).

`delta` = Σ dO·O in float32 is a plain torch op, as in the JAX package;
the backward kernels also take it from the caller, and K1's lse output is
the other residual a ring-attention caller needs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernel_ops, kernels
from ..framework.registry import register_op

_NEG_INF = -1e30

#: head dims the CUDA kernels are built for
KERNEL_HEAD_DIMS = (32, 64, 128, 256)


#: columns of the output each block of the wide-head route computes (kWO
#: in csrc/flash_attention.cu): head dims above 256 run at a multiple of it
WIDE_COLS = 128


def kernel_head_dim(d):
    """The head dim the kernels run a caller's D at: the least of
    KERNEL_HEAD_DIMS not below D, and above 256 the least multiple of
    WIDE_COLS not below D (the wide-head route)."""
    for kd in KERNEL_HEAD_DIMS:
        if d <= kd:
            return kd
    return -(-d // WIDE_COLS) * WIDE_COLS


def pad_head_dim(kd, *tensors):
    """Each [..., D] tensor zero-padded on its last dim to kd (contiguous;
    the tensor itself where D is kd already)."""
    return tuple(t if t.shape[-1] == kd else torch.nn.functional.pad(
        t, (0, kd - t.shape[-1])).contiguous() for t in tensors)

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


def flash_fwd_plain(q, k, v, scale, causal, q_ids=None, kv_ids=None,
                    mask=None):
    """K1's function in plain PyTorch: (o [B,H,Tq,D] in q's dtype,
    lse [B,H,Tq] float32). Like the kernel, an online softmax over tiles of
    KEY_TILE keys: P is rounded to v's dtype against the running max of the
    tiles so far, which matters in bfloat16. `mask`, a [.., Tq, Tk] bool
    tensor of the visible pairs, replaces the one `causal` and the ids
    make (the controls of `flash_control_masks`)."""
    f = _acc(q)
    qf = q.to(f)
    if mask is None:
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
                    kv_ids=None, delta=None, mask=None):
    """K2 and K3's function in plain PyTorch: (dq, dk, dv) in q's, k's and
    v's dtypes. `delta` defaults to Σ dO·O; `o` may then be None. `mask`
    as in `flash_fwd_plain`."""
    if delta is None:
        delta = flash_delta(o, do)
    f = _acc(q)
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    p = torch.exp(s - lse.to(f).unsqueeze(-1))
    if mask is None:
        mask = _valid_mask(q, k, causal, q_ids, kv_ids)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros((), dtype=f, device=p.device))
    dp = torch.matmul(do.to(f), v.to(f).transpose(-1, -2))
    ds = p * (dp - delta.to(f).unsqueeze(-1)) * scale
    dv = torch.matmul(p.to(do.dtype).to(f).transpose(-1, -2), do.to(f))
    dq = torch.matmul(ds.to(k.dtype).to(f), k.to(f))
    dk = torch.matmul(ds.to(q.dtype).to(f).transpose(-1, -2), q.to(f))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- what a tensor-core kernel may differ by ---------------------------------
#
# The bfloat16 K1-K3 sum their products on the tensor cores, in another
# order than the plain version (and a tensor core may truncate where a
# float32 add rounds). So a score or dP differs in its last bits, and a P
# or dS near a rounding boundary rounds to the neighbouring bfloat16 value,
# which moves a sum of many terms by more than one step of the output. The
# bounds below state what each such term may contribute: each is computed
# in float32 from the plain version's own operands, first order in the
# float32 unit (the terms are ~1e-4 relative and smaller). `flash_check`
# adds the output's own final rounding. The float32 kernels are held to
# 1e-5 · max(1, max|ref|) instead.

#: u: the largest relative gap between neighbouring bfloat16 values
BF16_GAP = 2.0 ** -7
_F32_ULP = 2.0 ** -23


def _sum_err(n):
    """ε_n = n · 2⁻²³: how far two float32 sums of the same n terms in
    different orders may differ, relative to the sum of the terms' sizes:
    n · 2⁻²⁴ for each, rounding to nearest, doubled because a tensor core
    may truncate its adds."""
    return n * _F32_ULP


def _exponent_err(q, k, s, lse, scale):
    """E_x [.., Tq, Tk]: how far the exponent s·scale - lse (or s - m) of a
    kernel's P may be from the plain version's, and so how far P is in
    relative terms (|e^δ - 1| ≈ |δ|):
    - E_s = ε_D · scale · (|Q|·|K|ᵀ), the score's dot of D exact bfloat16
      products summed in another order;
    - 2⁻²² (1 + |s·scale| + |lse|): the float32 rounding of the scaling,
      of the subtraction of the max (a running max within log Tk of lse)
      and of the product by log2(e) on either side, and the error of the
      exponential itself (the kernels take ex2 of x·log2 e, ~2 ulps).
    """
    f = torch.float32
    d = q.shape[-1]
    e_s = torch.matmul(q.to(f).abs(), k.to(f).abs().transpose(-1, -2))
    e_s = e_s * (_sum_err(d) * scale)
    lse = lse.to(f).unsqueeze(-1)
    return e_s + 2.0 ** -22 * (1.0 + s.abs() + lse.abs())


def flash_fwd_bound(q, k, v, o_ref, lse_ref, scale, causal, q_ids=None,
                    kv_ids=None):
    """(slack_o, slack_lse): what the bfloat16 tensor-core K1 may differ by
    from `flash_fwd_plain`'s (o_ref, lse_ref) on these inputs, besides the
    output's final bfloat16 rounding (`flash_check` adds that). With A the
    row softmax (exp(s - lse_ref) on the visible pairs), E_x as in
    `_exponent_err`, and ε_n as in `_sum_err`:

    - o: u·(A·|V|) + (A∘E_x)·|V| + (Σ_j A∘E_x)·|o_ref|
         + ε_Tk·(A·|V| + |o_ref|).
      The first term is one flipped P rounding per term (P rounds to v's
      type at the plain version's point: a flip moves P by at most u·P).
      The next two are the score error carried through the softmax:
      o = Σ_j A_j v_j and dA_j = A_j (δ_j - Σ_k A_k δ_k), so
      |do| ≤ Σ_j A_j E_j |v_j| + (Σ_k A_k E_k) |o|. The last is the
      float32 sums over keys in another order: P·V, and l, which divides
      o (the rescalings by the running max add one rounding per tile of 64
      keys, inside ε_Tk).
    - lse = m + log l: Σ_j A_j E_j (d lse = Σ_j A_j δ_j) + ε_Tk (the sum l)
      + |lse|·2⁻²³ (the add and the log). Rows with no visible key keep
      the sentinel exactly: `flash_check` compares those for equality.
    """
    f = torch.float32
    tk = k.shape[2]
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * scale
    a = torch.exp(s - lse_ref.to(f).unsqueeze(-1))
    mask = _valid_mask(q, k, causal, q_ids, kv_ids)
    if mask is not None:
        a = torch.where(mask, a, torch.zeros((), dtype=f, device=a.device))
    ae = a * _exponent_err(q, k, s, lse_ref, scale)
    del s
    av = v.to(f).abs()
    oa = o_ref.to(f).abs()
    a_v = torch.matmul(a, av)
    slack_o = ((BF16_GAP + _sum_err(tk)) * a_v + torch.matmul(ae, av)
               + (ae.sum(-1, keepdim=True) + _sum_err(tk)) * oa)
    slack_lse = (ae.sum(-1) + _sum_err(tk)
                 + lse_ref.to(f).abs() * _F32_ULP)
    return slack_o, slack_lse


def _ds_err(q, k, v, do, lse, delta, scale, causal, q_ids, kv_ids):
    """The terms K2 and K3 share: (P, P∘E_x, |dS|, E_dS), each
    [.., Tq, Tk] float32, with P = exp(s·scale - lse) on the visible pairs
    (0 elsewhere), E_x as in `_exponent_err` (so |δP| ≤ P∘E_x), dP = dO·Vᵀ,
    dS = P∘(dP - delta)·scale and

        E_dS = (u + 2⁻²¹)·|dS| + scale·(P∘E_x∘|dP - delta| + P∘E_dP),
        E_dP = ε_D·(|dO|·|V|ᵀ) + 2⁻²³·(|dP| + |delta|):

    how far a kernel's dS, after its rounding to bfloat16, may be from the
    plain version's rounded dS: one flipped rounding (u·|dS|), the float32
    rounding of the three operations that make dS on either side (2⁻²¹),
    dS's error carried from P's, and from dP's (a dot of D exact bfloat16
    products summed in another order, then the subtraction of delta)."""
    f = torch.float32
    d = q.shape[-1]
    qf, kf, vf, dof = q.to(f), k.to(f), v.to(f), do.to(f)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    lse_f = lse.to(f).unsqueeze(-1)
    mask = _valid_mask(q, k, causal, q_ids, kv_ids)
    zero = torch.zeros((), dtype=f, device=q.device)
    if mask is None:
        p = torch.exp(s - lse_f)
    else:
        # a masked pair of a row with no visible key has exp(s + 1e30)
        p = torch.where(mask, torch.exp(torch.where(mask, s - lse_f, zero)),
                        zero)
    pe = p * _exponent_err(q, k, s, lse, scale)
    del s
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    delta_f = delta.to(f).unsqueeze(-1)
    e_dp = (_sum_err(d) * torch.matmul(dof.abs(), vf.abs().transpose(-1, -2))
            + _F32_ULP * (dp.abs() + delta_f.abs()))
    dpd = (dp - delta_f).abs()
    del dp
    ds = p * dpd * scale
    e_ds = ((BF16_GAP + 2.0 ** -21) * ds
            + scale * (pe * dpd + p * e_dp))
    return p, pe, ds, e_ds


def flash_bwd_dq_bound(q, k, v, do, lse, delta, dq_ref, scale, causal,
                       q_ids=None, kv_ids=None):
    """slack_dq: what the bfloat16 tensor-core K2 may differ by from
    `flash_bwd_plain`'s dq_ref on the same inputs (lse and delta are
    inputs: both take the same ones), besides the output's final bfloat16
    rounding. dQ = round(dS)·K, so with |dS| and E_dS as in `_ds_err`:

        slack_dq = E_dS·|K| + ε_Tk·(|dS|·|K|):

    each term's rounded dS may be off by E_dS (a flipped rounding, the
    float32 operations that make it, the score error through P and the dot
    error through dP), and the float32 sum over keys runs in another
    order. dq_ref is not read: the slack depends on the operands alone
    (the argument keeps the signature of the other two bounds)."""
    del dq_ref
    _, _, ds, e_ds = _ds_err(q, k, v, do, lse, delta, scale, causal, q_ids,
                             kv_ids)
    ak = k.to(torch.float32).abs()
    return torch.matmul(e_ds, ak) + _sum_err(k.shape[2]) * torch.matmul(
        ds, ak)


def flash_bwd_dkv_bound(q, k, v, do, lse, delta, dk_ref, dv_ref, scale,
                        causal, q_ids=None, kv_ids=None):
    """(slack_dk, slack_dv): what the bfloat16 tensor-core K3 may differ by
    from `flash_bwd_plain`'s (dk_ref, dv_ref) on the same inputs (lse and
    delta are inputs: both take the same ones), besides the outputs' final
    bfloat16 rounding. With P, P∘E_x, |dS| and E_dS as in `_ds_err`:

    - dV = round(P)ᵀ·dO: (u + ε_Tq)·(Pᵀ·|dO|) + (P∘E_x)ᵀ·|dO|: one flipped
      P per term, the float32 sum over queries in another order, and the
      score error through P.
    - dK = round(dS)ᵀ·Q: E_dSᵀ·|Q| + ε_Tq·(|dS|ᵀ·|Q|): each term's rounded
      dS off by E_dS, then the sum over queries in another order.
    """
    f = torch.float32
    tq = q.shape[2]
    p, pe, ds, e_ds = _ds_err(q, k, v, do, lse, delta, scale, causal, q_ids,
                              kv_ids)
    ado = do.to(f).abs()
    slack_dv = ((BF16_GAP + _sum_err(tq))
                * torch.matmul(p.transpose(-1, -2), ado)
                + torch.matmul(pe.transpose(-1, -2), ado))
    del p, pe
    aq = q.to(f).abs()
    slack_dk = (torch.matmul(e_ds.transpose(-1, -2), aq)
                + _sum_err(tq) * torch.matmul(ds.transpose(-1, -2), aq))
    return slack_dk, slack_dv


def bf16_step(out, ref):
    """One bfloat16 step at max(|out|, |ref|, rms(ref)), elementwise: the
    output's own final rounding (two results that differ before it may
    round to neighbouring values), taken no finer than at the tensor's rms
    so that elements near zero are not held to a step of their own tiny
    size."""
    out, ref = out.float(), ref.float()
    mag = torch.maximum(torch.maximum(out.abs(), ref.abs()),
                        ref.pow(2).mean().sqrt())
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def flash_check(out, ref, slack=None):
    """Hold a kernel output against its plain version. Returns
    {"max_abs_err", "ok", "ratio" (the largest err / tolerance),
    "beyond_step" (the share of elements more than one bfloat16 step
    apart)}. Tolerance, elementwise:
    - float32 outputs without `slack` (the float32 kernels): 1e-5 ·
      max(1, max|ref|), float32 rounding of sums in another order;
    - bfloat16 outputs without `slack`: one bfloat16 step (`bf16_step`),
      right for a kernel that sums in float32 on the CUDA cores and rounds
      where the plain version does; no kernel of the port is held to it
      any more (every bfloat16 kernel runs on the tensor cores);
    - with `slack` (the tensor-core K1-K3, from `flash_fwd_bound`,
      `flash_bwd_dq_bound` and `flash_bwd_dkv_bound`): slack, plus one
      bfloat16 step where the output is bfloat16.
    Entries of `ref` at or below -1e29 (the lse sentinel of rows with no
    visible key) must match exactly."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    live = ref > -1e29
    res = {"max_abs_err": 0.0, "ok": True, "ratio": 0.0, "beyond_step": 0.0}
    if not bool((out[~live] == ref[~live]).all()):
        return {**res, "max_abs_err": float("inf"), "ok": False,
                "ratio": float("inf")}
    if slack is not None:
        slack = slack.float()[live]
    out, ref = out[live], ref[live]
    if ref.numel() == 0:
        return res
    diff = (out - ref).abs()
    step = bf16_step(out, ref)
    if slack is None:
        tol = (step if bf16 else
               torch.full_like(ref, 1e-5 * max(1.0, float(ref.abs().max()))))
    else:
        tol = slack + step if bf16 else slack
    ratio = diff / tol
    return {"max_abs_err": float(diff.max()),
            "ok": bool((diff <= tol).all()),
            "ratio": float(ratio.max()),
            "beyond_step": float((diff > step).float().mean())}


def flash_control_masks(tq, tk, device=None):
    """Visibility masks [Tq, Tk] of two wrong causal kernels, for showing
    that `flash_check` with the bounds still rejects a wrong result:
    "causal_off_by_one" (each query also sees the next key) and
    "dropped_tile" (the loop over key tiles stops one short: each q tile
    of KEY_TILE rows loses the last key tile it sees)."""
    causal = torch.ones(tq, tk, dtype=torch.bool, device=device).tril(
        tk - tq)
    rows = torch.arange(tq, device=device)
    q_tile = rows // KEY_TILE
    last_key = torch.clamp(q_tile * KEY_TILE + KEY_TILE - 1, max=tq - 1)
    last_tile = (last_key + tk - tq) // KEY_TILE
    key_tile = torch.arange(tk, device=device) // KEY_TILE
    dropped = causal & (key_tile[None, :] != last_tile[:, None])
    off_by_one = torch.ones(tq, tk, dtype=torch.bool, device=device).tril(
        tk - tq + 1)
    return {"causal_off_by_one": off_by_one, "dropped_tile": dropped}


# --- the CUDA kernels -------------------------------------------------------

def _bind(lib):
    if getattr(lib, "_ptt_bound", False):
        return
    c_int, c_vp, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    tail = [c_int, c_int, c_int, c_int, c_f, c_int, c_vp]
    lib.ptt_flash_fwd.argtypes = [c_int, c_int] + [c_vp] * 7 + tail
    lib.ptt_flash_bwd_dq.argtypes = [c_int, c_int] + [c_vp] * 9 + tail
    lib.ptt_flash_bwd_dkv.argtypes = [c_int, c_int] + [c_vp] * 10 + tail
    lib.ptt_flash_smem_bytes.argtypes = [c_int, c_int, c_int]
    for fn in (lib.ptt_flash_fwd, lib.ptt_flash_bwd_dq,
               lib.ptt_flash_bwd_dkv, lib.ptt_flash_smem_bytes):
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
    if kernel_head_dim(d) != d:
        raise ValueError(f"{name}: head dim {d} is not one the kernels take "
                         f"({KERNEL_HEAD_DIMS} or a multiple of {WIDE_COLS} "
                         f"above 256; pad_head_dim)")
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
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must start 16-byte aligned "
                             f"(the kernels copy 16-byte pieces)")
    for ids, t in ((q_ids, q.shape[2]), (kv_ids, k.shape[2])):
        if ids is not None and (ids.device != dev or ids.dtype != torch.int32
                                or tuple(ids.shape) != (b, t)
                                or not ids.is_contiguous()):
            raise ValueError(f"{name}: segment ids must be contiguous int32 "
                             f"[{b}, {t}] on q's device")


def _ptr(t):
    return None if t is None else t.data_ptr()


def launch_route(name, bf16, d):
    """The second name a launch of kernel `name` counts under, which says
    the design that took it, or None: above head dim 256 `<name>_wide_tc`
    for bfloat16 K1 and K2 (tensor cores, a cluster of blocks splitting D)
    and `<name>_wide` for float32 and for K3 (the CUDA cores); at or below
    256 `<name>_tc` for bfloat16, and none for float32."""
    if d > KERNEL_HEAD_DIMS[-1]:
        tc = bf16 and name in ("flash_fwd", "flash_bwd_dq")
        return name + ("_wide_tc" if tc else "_wide")
    return name + "_tc" if bf16 else None


def _launch(name, fn, bf16, d, *args):
    """Launch `fn` with (is_bf16, D, *args); count it under `name`, and
    under its route too (`launch_route`)."""
    lib = kernels.load("flash_attention")
    _bind(lib)
    err = getattr(lib, fn)(int(bf16), d, *args)
    kernels.check(lib, name, err)
    kernels.count_launch(name)
    route = launch_route(name, bf16, d)
    if route is not None:
        kernels.count_launch(route)


def _flash_fwd_launch(q, k, v, q_ids, kv_ids, scale, causal, with_lse):
    """`ptpu::flash_fwd` on CUDA tensors: K1 at a head dim the kernels
    take. Returns (o, lse, or an empty [0] tensor without `with_lse`)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _check("flash_fwd_cuda", [(k, q.dtype, (b, h, tk, d)),
                              (v, q.dtype, (b, h, tk, d)),
                              (q, q.dtype, (b, h, tq, d))], q, k, q_ids,
           kv_ids)
    with torch.cuda.device(q.device):
        o = torch.empty_like(q)
        lse = torch.empty((b, h, tq) if with_lse else (0,),
                          dtype=torch.float32, device=q.device)
        _launch("flash_fwd", "ptt_flash_fwd", q.dtype == torch.bfloat16, d,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_ids),
                _ptr(kv_ids), o.data_ptr(), lse.data_ptr() if with_lse
                else None, b * h, h, tq, tk, float(scale),
                int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    return o, lse


def flash_fwd_cuda(q, k, v, scale, causal, q_ids=None, kv_ids=None,
                   with_lse=True):
    """Launch K1 (`ptpu::flash_fwd`). q [B,H,Tq,D], k/v [B,H,Tk,D]:
    contiguous CUDA tensors of one dtype, any D (padded to
    `kernel_head_dim`). Returns (o, lse or None)."""
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    if kd != d and q.is_cuda:
        o, lse = flash_fwd_cuda(*pad_head_dim(kd, q, k, v), scale, causal,
                                q_ids, kv_ids, with_lse)
        return o[..., :d].contiguous(), lse
    kernel_ops.require_cuda("flash_fwd_cuda", q, k, v)
    o, lse = torch.ops.ptpu.flash_fwd(q, k, v, q_ids, kv_ids, float(scale),
                                      bool(causal), bool(with_lse))
    return o, (lse if with_lse else None)


def _bwd_check(name, q, k, v, do, lse, delta, q_ids, kv_ids):
    b, h, tq, d = q.shape
    tk = k.shape[2]
    _check(name, [(q, q.dtype, (b, h, tq, d)), (k, q.dtype, (b, h, tk, d)),
                  (v, q.dtype, (b, h, tk, d)), (do, q.dtype, (b, h, tq, d)),
                  (lse, torch.float32, (b, h, tq)),
                  (delta, torch.float32, (b, h, tq))], q, k, q_ids, kv_ids)
    return b, h, tq, tk, d


def _flash_bwd_dq_launch(q, k, v, do, lse, delta, q_ids, kv_ids, scale,
                         causal):
    """`ptpu::flash_bwd_dq` on CUDA tensors: K2."""
    b, h, tq, tk, d = _bwd_check("flash_bwd_dq_cuda", q, k, v, do, lse,
                                 delta, q_ids, kv_ids)
    with torch.cuda.device(q.device):
        dq = torch.empty_like(q)
        _launch("flash_bwd_dq", "ptt_flash_bwd_dq",
                q.dtype == torch.bfloat16, d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(q_ids), _ptr(kv_ids), dq.data_ptr(),
                b * h, h, tq, tk, float(scale), int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def _flash_bwd_dkv_launch(q, k, v, do, lse, delta, q_ids, kv_ids, scale,
                          causal):
    """`ptpu::flash_bwd_dkv` on CUDA tensors: K3."""
    b, h, tq, tk, d = _bwd_check("flash_bwd_dkv_cuda", q, k, v, do, lse,
                                 delta, q_ids, kv_ids)
    with torch.cuda.device(q.device):
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        _launch("flash_bwd_dkv", "ptt_flash_bwd_dkv",
                q.dtype == torch.bfloat16, d, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), _ptr(q_ids), _ptr(kv_ids), dk.data_ptr(),
                dv.data_ptr(), b * h, h, tq, tk, float(scale),
                int(bool(causal)),
                torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


kernel_ops.impl("flash_fwd", _flash_fwd_launch)
kernel_ops.impl("flash_bwd_dq", _flash_bwd_dq_launch)
kernel_ops.impl("flash_bwd_dkv", _flash_bwd_dkv_launch)


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, scale, causal, q_ids=None,
                      kv_ids=None):
    """Launch K2 (`ptpu::flash_bwd_dq`): dq in q's dtype."""
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    if kd != d and q.is_cuda:
        dq = flash_bwd_dq_cuda(*pad_head_dim(kd, q, k, v, do), lse, delta,
                               scale, causal, q_ids, kv_ids)
        return dq[..., :d].contiguous()
    kernel_ops.require_cuda("flash_bwd_dq_cuda", q, k, v, do)
    return torch.ops.ptpu.flash_bwd_dq(q, k, v, do, lse, delta, q_ids,
                                       kv_ids, float(scale), bool(causal))


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, scale, causal, q_ids=None,
                       kv_ids=None):
    """Launch K3 (`ptpu::flash_bwd_dkv`): (dk, dv) in k's and v's
    dtype."""
    d = q.shape[-1]
    kd = kernel_head_dim(d)
    if kd != d and q.is_cuda:
        dk, dv = flash_bwd_dkv_cuda(*pad_head_dim(kd, q, k, v, do), lse,
                                    delta, scale, causal, q_ids, kv_ids)
        return dk[..., :d].contiguous(), dv[..., :d].contiguous()
    kernel_ops.require_cuda("flash_bwd_dkv_cuda", q, k, v, do)
    return torch.ops.ptpu.flash_bwd_dkv(q, k, v, do, lse, delta, q_ids,
                                        kv_ids, float(scale), bool(causal))


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
