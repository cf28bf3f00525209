"""The tolerance the bfloat16 tensor-core flash kernels (K1 forward, K2 dQ,
K3 dK/dV) are held to: `flash_fwd_bound`, `flash_bwd_dq_bound` and
`flash_bwd_dkv_bound` in paddle_tpu_torch/ops/flash_attention.py, checked
by `flash_check`.

A tensor-core kernel sums its products in another order than the plain
version, so some P and dS values round to the neighbouring bfloat16 value,
and a sum of many terms then moves by more than one step of the output.
The bounds state what each such term may contribute. These tests show, at
small shapes on the CPU, that the bounds admit a result that differs the
way a tensor-core kernel's does (the plain version with its scores and dP
perturbed at the level of a float32 sum in another order, and the JAX
package's Pallas kernels in interpret mode, whose tiles and sums differ
from the port's), that they reject wrong kernels (three for each output),
and that the float32 tolerance is unchanged. Inputs come from a numpy seed, [B, H, T, D].
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import (_flash_attention_bwd_pallas,
                                           _flash_attention_pallas)
from paddle_tpu_torch.ops.flash_attention import (
    KEY_TILE, _valid_mask, flash_bwd_dkv_bound, flash_bwd_dq_bound,
    flash_bwd_plain, flash_check, flash_control_masks, flash_delta,
    flash_fwd_bound, flash_fwd_plain)

BF16 = torch.bfloat16
NEG_INF = -1e30

# (id, B, H, Tq, Tk, D, causal, segments)
CASES = [
    ("causal_d64", 2, 2, 128, 128, 64, True, False),
    ("packed_d32", 2, 2, 160, 160, 32, True, True),
    ("tq_lt_tk_d64", 1, 2, 96, 160, 64, True, False),
    ("causal_d256", 1, 2, 96, 96, 256, True, False),
]


def _inputs(b, h, tq, tk, d, seg, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype("float32"))
                   .to(BF16) for t in (tq, tk, tk, tq))
    ids = None
    if seg:   # three sequences per row, then padding
        ids = np.zeros((b, tq), "int32")
        ids[:, :50], ids[:, 50:90], ids[:, 90:150] = 1, 2, 3
        ids = torch.from_numpy(ids)
    return q, k, v, do, ids, rng


def _imitate_fwd(q, k, v, scale, mask, noise):
    """K1 as a tensor-core kernel computes it: `flash_fwd_plain`'s tiled
    online softmax, with each score perturbed by relative noise at the
    level of a float32 dot of D products summed in another order
    (s · (1 + D·2⁻²³·ξ), ξ uniform in [-1, 1]), P rounded from the
    perturbed scores."""
    f = torch.float32
    s_all = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * noise * scale
    m = torch.full(q.shape[:-1] + (1,), NEG_INF)
    lsum = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[2], KEY_TILE):
        s = s_all[..., k0:k0 + KEY_TILE]
        s = s.masked_fill(~mask[..., k0:k0 + KEY_TILE], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_new),
                        torch.zeros(()))
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(BF16).to(f),
                                         v[:, :, k0:k0 + KEY_TILE].to(f))
        m = m_new
    lsum = lsum.clamp_min(1e-30)
    return (acc / lsum).to(BF16), (m + torch.log(lsum)).squeeze(-1)


def _imitate_bwd(q, k, v, do, lse, delta, scale, mask, noise_s, noise_dp):
    """K2 and K3 as tensor-core kernels compute them: scores and dP
    perturbed as in `_imitate_fwd`, P and dS rounded to bfloat16 from the
    perturbed values. Returns (dq, dk, dv)."""
    f = torch.float32
    s = torch.matmul(q.to(f), k.to(f).transpose(-1, -2)) * noise_s * scale
    p = torch.where(mask, torch.exp(s - lse.unsqueeze(-1)), torch.zeros(()))
    dp = torch.matmul(do.to(f), v.to(f).transpose(-1, -2)) * noise_dp
    ds = p * (dp - delta.unsqueeze(-1)) * scale
    dv = torch.matmul(p.to(BF16).to(f).transpose(-1, -2), do.to(f))
    dk = torch.matmul(ds.to(BF16).to(f).transpose(-1, -2), q.to(f))
    dq = torch.matmul(ds.to(BF16).to(f), k.to(f))
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _reference(q, k, v, do, ids, scale):
    o, lse = flash_fwd_plain(q, k, v, scale, True, ids, ids)
    delta = flash_delta(o, do)
    dq, dk, dv = flash_bwd_plain(q, k, v, None, lse, do, scale, True, ids,
                                 ids, delta=delta)
    return o, lse, delta, dq, dk, dv


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bound_admits_a_tensor_core_imitation(case):
    _, b, h, tq, tk, d, causal, seg = case
    q, k, v, do, ids, rng = _inputs(b, h, tq, tk, d, seg, seed=11)
    scale = d ** -0.5
    o, lse, delta, dq, dk, dv = _reference(q, k, v, do, ids, scale)
    mask = _valid_mask(q, k, causal, ids, ids)
    eps = d * 2.0 ** -23

    def noise():
        return torch.from_numpy(
            1 + eps * rng.uniform(-1, 1, (b, h, tq, tk)).astype("float32"))

    o_i, lse_i = _imitate_fwd(q, k, v, scale, mask, noise())
    dq_i, dk_i, dv_i = _imitate_bwd(q, k, v, do, lse, delta, scale, mask,
                                    noise(), noise())
    slack_o, slack_lse = flash_fwd_bound(q, k, v, o, lse, scale, causal,
                                         ids, ids)
    slack_dq = flash_bwd_dq_bound(q, k, v, do, lse, delta, dq, scale, causal,
                                  ids, ids)
    slack_dk, slack_dv = flash_bwd_dkv_bound(q, k, v, do, lse, delta, dk,
                                             dv, scale, causal, ids, ids)
    differs = set()
    for name, out, ref, slack in (("o", o_i, o, slack_o),
                                  ("lse", lse_i, lse, slack_lse),
                                  ("dq", dq_i, dq, slack_dq),
                                  ("dk", dk_i, dk, slack_dk),
                                  ("dv", dv_i, dv, slack_dv)):
        res = flash_check(out, ref, slack)
        assert res["ok"], (name, res)
        if res["max_abs_err"] > 0:
            differs.add(name)
    assert differs, "the imitation equals the plain version: no test"
    assert "dq" in differs, "the imitated dq equals the plain one: no test"


@pytest.mark.parametrize("control", ["causal_off_by_one", "dropped_tile",
                                     "dk_without_scale", "dq_without_scale"])
def test_bound_rejects_wrong_kernels(control):
    """The controls chip_smoke.py phase 3 runs at the LM's shape: each
    wrong result, computed by the plain version, is rejected by the same
    check that admits the kernels (the two masks for o, dq, dk and dv; dS
    not multiplied by scale for dk and for dq)."""
    b, h, t, d = 1, 2, 128, 64
    q, k, v, do, _, _ = _inputs(b, h, t, t, d, False, seed=12)
    scale = d ** -0.5
    o, lse, delta, dq, dk, dv = _reference(q, k, v, do, None, scale)
    slack_o, slack_lse = flash_fwd_bound(q, k, v, o, lse, scale, True)
    slack_dq = flash_bwd_dq_bound(q, k, v, do, lse, delta, dq, scale, True)
    slack_dk, slack_dv = flash_bwd_dkv_bound(q, k, v, do, lse, delta, dk,
                                             dv, scale, True)
    # scale is a power of two at D = 64: dividing by it is exactly the plain
    # version with dS not multiplied by it
    if control == "dk_without_scale":
        wrong = [("dk", (dk.float() / scale).to(BF16), dk, slack_dk)]
    elif control == "dq_without_scale":
        wrong = [("dq", (dq.float() / scale).to(BF16), dq, slack_dq)]
    else:
        mask = flash_control_masks(t, t)[control][None, None]
        o_c, _ = flash_fwd_plain(q, k, v, scale, True, mask=mask)
        dq_c, dk_c, dv_c = flash_bwd_plain(q, k, v, None, lse, do, scale,
                                           True, delta=delta, mask=mask)
        wrong = [("o", o_c, o, slack_o), ("dq", dq_c, dq, slack_dq),
                 ("dk", dk_c, dk, slack_dk), ("dv", dv_c, dv, slack_dv)]
    for name, out, ref, slack in wrong:
        res = flash_check(out, ref, slack)
        assert not res["ok"] and res["ratio"] > 1, (control, name, res)
    # and the right results pass the same check
    assert flash_check(o, o, slack_o)["ok"]
    assert flash_check(dq, dq, slack_dq)["ok"]
    assert flash_check(dk, dk, slack_dk)["ok"]


def test_float32_and_k2_tolerances_unchanged():
    """Without a slack, float32 outputs are held to 1e-5 · max(1, max|ref|)
    and bfloat16 ones to one bfloat16 step (no kernel is held to that any
    more: every bfloat16 kernel, K2 included, runs on the tensor cores and
    takes its per-term bound); lse sentinels exactly."""
    rng = np.random.RandomState(13)
    ref = torch.from_numpy(rng.randn(4, 64).astype("float32") * 3)
    tol = 1e-5 * float(ref.abs().max())
    assert flash_check(ref + 0.9 * tol, ref)["ok"]
    assert not flash_check(ref + 1.1 * tol, ref)["ok"]
    small = ref / 100         # max|ref| < 1: the tolerance is 1e-5
    assert flash_check(small + 0.9e-5, small)["ok"]
    assert not flash_check(small + 1.1e-5, small)["ok"]

    ref16 = ref.to(BF16)
    # one step larger in magnitude: admitted; three: rejected
    one_step = (ref16.view(torch.int16) + 1).view(BF16)
    assert flash_check(one_step, ref16)["ok"]
    three_steps = (ref16.view(torch.int16) + 3).view(BF16)
    assert not flash_check(three_steps, ref16)["ok"]

    lse = torch.tensor([1.5, NEG_INF, 2.0])
    assert flash_check(lse.clone(), lse)["ok"]
    bad = lse.clone()
    bad[1] = NEG_INF * 0.5
    assert not flash_check(bad, lse)["ok"]


def test_bound_admits_the_jax_kernel_in_bfloat16():
    """The JAX package's Pallas kernels in interpret mode, in bfloat16:
    tiles of 128 keys where the port's are 64 (so P rounds against another
    running max) and XLA's sums: o, dq, dk and dv admitted by the bounds
    against the port's plain version."""
    b, h, t, d = 1, 2, 128, 32
    q, k, v, do, _, _ = _inputs(b, h, t, t, d, False, seed=14)
    scale = d ** -0.5
    o, lse, delta, dq, dk, dv = _reference(q, k, v, do, None, scale)

    def j(x):
        return jnp.asarray(x.float().numpy(), jnp.bfloat16)

    jo = _flash_attention_pallas(j(q), j(k), j(v), scale, True, 128, 128,
                                 interpret=True)
    jdq, jdk, jdv = _flash_attention_bwd_pallas(
        j(q), j(k), j(v), j(o), jnp.asarray(lse.numpy()), j(do), scale, True,
        128, 128, interpret=True)
    slack_o, _ = flash_fwd_bound(q, k, v, o, lse, scale, True)
    slack_dq = flash_bwd_dq_bound(q, k, v, do, lse, delta, dq, scale, True)
    slack_dk, slack_dv = flash_bwd_dkv_bound(q, k, v, do, lse, delta, dk,
                                             dv, scale, True)

    def t_(x):
        return torch.from_numpy(np.array(x.astype(jnp.float32))).to(BF16)

    for name, out, ref, slack in (("o", t_(jo), o, slack_o),
                                  ("dq", t_(jdq), dq, slack_dq),
                                  ("dk", t_(jdk), dk, slack_dk),
                                  ("dv", t_(jdv), dv, slack_dv)):
        res = flash_check(out, ref, slack)
        assert res["ok"], (name, res)
