"""The port's flash attention (K1 forward, K2 dQ, K3 dK/dV) against the JAX
package's.

The port's plain versions (paddle_tpu_torch/ops/flash_attention.py
`flash_fwd_plain`, `flash_bwd_plain`, and the `FlashAttention` autograd
function, which CPU tensors run) are held against
paddle_tpu/ops/pallas_kernels.py: the Pallas kernels in interpret mode
(`_flash_attention_pallas`, `_flash_attention_bwd_pallas`,
`interpret=True`, as tests/test_pallas_attention.py runs them) — the
functions the port's CUDA kernels implement — and the XLA composite
`_attention_reference`. Inputs come from a numpy seed, [B, H, T, D]. The
CUDA kernels themselves run only on the card (chip_smoke.py holds them
against these plain versions there).

Tolerances: float32 at atol 1e-5 (both compute in float32; sums in
another order). bfloat16 against the interpret kernel at one bfloat16
step (2**-7 relative, atol 1e-2 at these magnitudes): both round P to
bfloat16 at the same point and the output once.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.ops.pallas_kernels import (_attention_reference,
                                           _flash_attention_bwd_pallas,
                                           _flash_attention_pallas,
                                           _fused_attention)
from paddle_tpu_torch import kernels
from paddle_tpu_torch.ops.flash_attention import (FlashAttention,
                                                  flash_bwd_plain,
                                                  flash_delta,
                                                  flash_fwd_cuda,
                                                  flash_fwd_plain,
                                                  fused_attention)

D = 16
BLOCK = 128

# (id, B, H, Tq, Tk, causal, segments, head dim): segments "packed" = two
# sequences per row then padding; "unmatched" = the first rows carry an id
# no key has; "d256" is the largest head dim of the tensor-core kernels,
# "d384" and "d512" run on the wide-head route on the card
CASES = [
    ("causal", 2, 2, 64, 64, True, None, D),
    ("tq_ne_tk", 1, 2, 48, 80, True, None, D),
    ("odd_t", 2, 1, 37, 37, False, None, D),
    ("packed", 2, 2, 64, 64, True, "packed", D),
    ("no_key_causal", 1, 2, 96, 32, True, None, D),
    ("no_key_segment", 1, 2, 40, 40, False, "unmatched", D),
    ("d256", 1, 2, 40, 72, True, None, 256),
    ("d384_causal", 1, 2, 40, 72, True, None, 384),
    ("d384", 1, 1, 33, 33, False, None, 384),
    ("d512_causal", 1, 1, 48, 48, True, None, 512),
    ("d512", 1, 2, 24, 40, False, None, 512),
]


def _inputs(b, h, tq, tk, seg, seed=0, d=D):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(b, h, t, d).astype("float32")
                   for t in (tq, tk, tk, tq))
    q_ids = kv_ids = None
    if seg == "packed":
        q_ids = np.zeros((b, tq), "int32")
        q_ids[:, :25], q_ids[:, 25:57] = 1, 2
        kv_ids = q_ids
    elif seg == "unmatched":
        kv_ids = np.full((b, tk), 3, "int32")
        q_ids = kv_ids.copy()
        q_ids[:, :10] = 9
    return q, k, v, do, q_ids, kv_ids


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(
        dtype if a.dtype.kind == "f" else torch.int32)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(
        a, dtype=dtype if a.dtype.kind == "f" else jnp.int32)


def _jseg(q_ids, kv_ids):
    return None if q_ids is None else (_j(q_ids), _j(kv_ids))


def _no_key_rows(tq, tk, causal, q_ids, kv_ids):
    """[B or 1, Tq] bool: query rows that see no key."""
    vis = np.ones((1, tq, tk), bool)
    if causal:
        vis &= np.tril(np.ones((tq, tk), bool), tk - tq)[None]
    if q_ids is not None:
        vis = vis & (q_ids[:, :, None] == kv_ids[:, None, :])
    return ~vis.any(-1)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_forward_matches_pallas_interpret_and_reference(case):
    _, b, h, tq, tk, causal, seg, d = case
    q, k, v, _, q_ids, kv_ids = _inputs(b, h, tq, tk, seg, d=d)
    scale = d ** -0.5
    o, lse = flash_fwd_plain(_t(q), _t(k), _t(v), scale, causal,
                             _t(q_ids), _t(kv_ids))
    jo, jlse = _flash_attention_pallas(
        _j(q), _j(k), _j(v), scale, causal, BLOCK, BLOCK, interpret=True,
        with_lse=True, segment_ids=_jseg(q_ids, kv_ids))
    ref = _attention_reference(_j(q), _j(k), _j(v), scale, causal,
                               _jseg(q_ids, kv_ids))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # lse relative to its size (~1e1); the -1e30 sentinel of rows with no
    # visible key is the same float32 in both
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=1e-5,
                               rtol=1e-6)
    dead = _no_key_rows(tq, tk, causal, q_ids, kv_ids)
    dead = np.broadcast_to(dead[:, None, :], (b, h, tq))
    if case[0].startswith("no_key"):
        assert dead.any()
    assert (o.numpy()[dead] == 0).all()      # rows with no key give zeros


@pytest.mark.parametrize("delta_given", [False, True],
                         ids=["delta_computed", "delta_passed"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_backward_matches_pallas_interpret(case, delta_given):
    _, b, h, tq, tk, causal, seg, d = case
    q, k, v, do, q_ids, kv_ids = _inputs(b, h, tq, tk, seg, seed=1, d=d)
    scale = d ** -0.5
    o, lse = flash_fwd_plain(_t(q), _t(k), _t(v), scale, causal,
                             _t(q_ids), _t(kv_ids))
    delta = flash_delta(o, _t(do)) if delta_given else None
    got = flash_bwd_plain(_t(q), _t(k), _t(v), None if delta_given else o,
                          lse, _t(do), scale, causal, _t(q_ids), _t(kv_ids),
                          delta=delta)
    want = _flash_attention_bwd_pallas(
        _j(q), _j(k), _j(v), jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()),
        _j(do), scale, causal, BLOCK, BLOCK, interpret=True,
        segment_ids=_jseg(q_ids, kv_ids),
        delta=jnp.asarray(delta.numpy()) if delta_given else None)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_autograd_function_matches_jax_vjp(case):
    """FlashAttention forward and backward on CPU tensors against jax.vjp
    through the JAX package's custom-vjp `_fused_attention` on the
    "pallas_interpret" backend."""
    _, b, h, tq, tk, causal, seg, _ = case
    q, k, v, do, q_ids, kv_ids = _inputs(b, h, tq, tk, seg, seed=2)
    scale = D ** -0.5
    jseg = _jseg(q_ids, kv_ids)
    jo, vjp = jax.vjp(
        lambda q_, k_, v_: _fused_attention(q_, k_, v_, jseg, scale, causal,
                                            "pallas_interpret", BLOCK,
                                            BLOCK), _j(q), _j(k), _j(v))
    jgrads = vjp(_j(do))
    tq_, tk_, tv_ = (_t(a).requires_grad_() for a in (q, k, v))
    seg_arg = None if q_ids is None else (_t(q_ids), _t(kv_ids))
    kernels.reset_launch_counts()
    o = fused_attention(tq_, tk_, tv_, scale, causal, seg_arg)
    grads = torch.autograd.grad(o, (tq_, tk_, tv_), _t(do))
    assert all(n == 0 for n in kernels.LAUNCHES.values())   # CPU: plain
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), atol=1e-5,
                               rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)


def test_bf16_plain_matches_pallas_interpret_and_composite():
    """bfloat16 q/k/v, the LM's path. Against the interpret kernel: one
    bfloat16 step. Against the XLA composite, which rounds the scores to
    bfloat16 before the softmax where the kernels keep them in float32:
    atol 5e-2."""
    q, k, v, do, _, _ = _inputs(2, 2, 64, 64, None, seed=3)
    scale = D ** -0.5
    o, lse = flash_fwd_plain(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                             _t(v, torch.bfloat16), scale, True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    jo = _flash_attention_pallas(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                 _j(v, jnp.bfloat16), scale, True, BLOCK,
                                 BLOCK, interpret=True)
    port = o.float().numpy()
    np.testing.assert_allclose(port, np.asarray(jo.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    ref = _attention_reference(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                               _j(v, jnp.bfloat16), scale, True)
    np.testing.assert_allclose(port, np.asarray(ref.astype(jnp.float32)),
                               atol=5e-2, rtol=0)
    dq, dk, dv = flash_bwd_plain(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        o, lse, _t(do, torch.bfloat16), scale, True)
    want = _flash_attention_bwd_pallas(
        _j(q, jnp.bfloat16), _j(k, jnp.bfloat16), _j(v, jnp.bfloat16),
        jnp.asarray(o.float().numpy(), jnp.bfloat16),
        jnp.asarray(lse.numpy()), _j(do, jnp.bfloat16), scale, True, BLOCK,
        BLOCK, interpret=True)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=1e-2, err_msg=name)


@pytest.mark.parametrize("seg", [None, "packed"])
def test_plain_path_gradcheck_float64(seg):
    """The plain forward and backward are each other's derivative: a
    float64 gradcheck of the autograd function on the CPU."""
    t = 64 if seg else 9
    q, k, v, _, q_ids, kv_ids = _inputs(1, 1, t, t, seg, seed=4)
    args = [_t(a[..., :4], torch.float64).contiguous().requires_grad_()
            for a in (q, k, v)]
    ids = _t(q_ids), _t(kv_ids)
    assert torch.autograd.gradcheck(
        lambda a, b_, c: FlashAttention.apply(a, b_, c, ids[0], ids[1], 0.5,
                                              True),
        args, eps=1e-6, atol=1e-6)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrappers launch or raise; they never compute on the CPU
    and count no launch when they refuse."""
    q, k, v, _, _, _ = _inputs(1, 2, 64, 64, None)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        flash_fwd_cuda(_t(q), _t(k), _t(v), 0.25, True)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 40, 96, 160, 200])
def test_head_dim_padding_matches_unpadded_plain(d, dtype):
    """What the CUDA wrappers do with a head dim the kernels are not built
    for: q, k, v and dO zero-padded to `kernel_head_dim(D)`, the caller's
    scale unchanged, lse and delta passed through, o, dq, dk, dv sliced
    back. Run through the plain versions, that equals the unpadded plain
    version (float32 at 1e-5, bfloat16 at one bfloat16 step:
    `flash_check`'s rules; zero columns add exactly 0 to every product)."""
    from paddle_tpu_torch.ops.flash_attention import (
        flash_check, kernel_head_dim, pad_head_dim)
    rng = np.random.RandomState(d)
    b, h, t = 2, 2, 72
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype("float32"))
                   .to(dtype) for _ in range(4))
    ids = torch.zeros(b, t, dtype=torch.int32)
    ids[:, :30], ids[:, 30:65] = 1, 2
    scale = d ** -0.5
    kd = kernel_head_dim(d)
    assert kd == {16: 32, 40: 64, 96: 128, 160: 256, 200: 256}[d]
    qp, kp, vp, dop = pad_head_dim(kd, q, k, v, do)
    assert qp.shape[-1] == kd and bool((qp[..., d:] == 0).all())
    o, lse = flash_fwd_plain(q, k, v, scale, True, ids, ids)
    op, lsep = flash_fwd_plain(qp, kp, vp, scale, True, ids, ids)
    delta = flash_delta(o, do)
    assert torch.equal(flash_delta(op, dop), delta)
    grads = flash_bwd_plain(q, k, v, None, lse, do, scale, True, ids, ids,
                            delta=delta)
    gradsp = flash_bwd_plain(qp, kp, vp, None, lsep, dop, scale, True, ids,
                             ids, delta=delta)
    assert flash_check(lsep, lse)["ok"]
    for name, out, ref in zip(("o", "dq", "dk", "dv"), (op, *gradsp),
                              (o, *grads)):
        assert bool((out[..., d:] == 0).all()), name
        res = flash_check(out[..., :d].contiguous(), ref)
        assert res["ok"], (name, res)


def test_head_dims_above_128_raise_naming_the_follow_up():
    """The head dim each caller's D runs at (the name is kept from when
    head dims above 128, then above 256, raised): 129..256 run at 256,
    and above 256 nothing raises any more: D runs at the least multiple of
    128 not below it, on the wide-head route (300 -> 384, 512 stays 512,
    1000 -> 1024)."""
    from paddle_tpu_torch.ops.flash_attention import (WIDE_COLS,
                                                      kernel_head_dim,
                                                      pad_head_dim)
    assert [kernel_head_dim(d) for d in (1, 32, 33, 64, 100, 128)] == \
        [32, 32, 64, 64, 128, 128]
    assert all(kernel_head_dim(d) == 256 for d in range(129, 257))
    assert [kernel_head_dim(d) for d in (257, 300, 384, 385, 512, 1000)] == \
        [384, 384, 384, 512, 512, 1024]
    assert all(kernel_head_dim(d) % WIDE_COLS == 0
               and 0 <= kernel_head_dim(d) - d < WIDE_COLS
               for d in range(257, 2049))
    x = torch.ones(1, 1, 4, 64)
    assert pad_head_dim(64, x)[0] is x
    y = pad_head_dim(384, torch.ones(1, 1, 4, 300))[0]
    assert y.shape[-1] == 384 and bool((y[..., 300:] == 0).all())
