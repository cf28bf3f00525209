"""The port's fused decode-attention step against the JAX package's.

The port's plain version (paddle_tpu_torch/fusion/decode_attention.py
`decode_attention_plain`, what a CPU tensor runs) is held against
`paddle_tpu.fusion.fused_decode_attention` run two ways: through the Pallas
kernel in interpret mode (`backend="pallas_interpret"`, as
tests/test_fusion.py runs it) — the function the port's CUDA kernel
implements — and through the XLA composite (`backend="xla"`). Inputs come
from a numpy seed and have the decode tick's layout: q [R,1,nh,1,dh],
K/V [R,1,nh,T,dh] float32 caches, bias [R,1,1,1,T] with each row's mask
ending at its own position. The CUDA kernel itself runs only on the card
(chip_smoke.py holds it against this plain version there).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.fusion import fused_decode_attention as jax_fused
from paddle_tpu_torch import kernels
from paddle_tpu_torch.fusion import (decode_attention_cuda,
                                     decode_attention_plain,
                                     fused_decode_attention)

DH = 16


def _inputs(t, nh, r=3, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(r, 1, nh, 1, DH).astype("float32")
    k = rng.randn(r, 1, nh, t, DH).astype("float32")
    v = rng.randn(r, 1, nh, t, DH).astype("float32")
    # each row's mask ends at its own position (slot 0 sees one key)
    ends = np.array([1, t // 2 + 1, t])[:r]
    keep = np.arange(t)[None] < ends[:, None]
    bias = (keep.astype("float32") * 1e9 - 1e9).reshape(r, 1, 1, 1, t)
    return q, k, v, bias


def _jax(q, k, v, bias, q_dtype, backend):
    out = jax_fused(jnp.asarray(q, dtype=q_dtype), jnp.asarray(k),
                    jnp.asarray(v), jnp.asarray(bias), scale=DH ** -0.5,
                    backend=backend)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, bias, q_dtype):
    out = fused_decode_attention(
        torch.from_numpy(q).to(q_dtype), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(bias), scale=DH ** -0.5)
    assert out.dtype == q_dtype       # the output takes q's dtype
    return out.float().numpy()


@pytest.mark.parametrize("nh", [4, 6])
@pytest.mark.parametrize("t", [16, 40, 128])
def test_plain_matches_pallas_interpret_and_xla_f32(t, nh):
    """float32: the Pallas kernel, the XLA composite and the port's plain
    version compute the same float32 function; atol 1e-5 covers the
    different summation orders."""
    q, k, v, bias = _inputs(t, nh)
    port = _port(q, k, v, bias, torch.float32)
    for backend in ("pallas_interpret", "xla"):
        np.testing.assert_allclose(
            port, _jax(q, k, v, bias, jnp.float32, backend), atol=1e-5,
            rtol=0, err_msg=backend)


@pytest.mark.parametrize("nh", [4, 6])
@pytest.mark.parametrize("t", [16, 40, 128])
def test_plain_matches_pallas_interpret_and_xla_bf16(t, nh):
    """bfloat16 q over float32 caches (the serving tick's mix).

    Against the interpret kernel: both compute in float32 and round the
    output to bfloat16 once, so they differ only where the float32 results
    straddle a rounding boundary — by one bfloat16 step (2**-8 relative,
    ~1e-2 at these magnitudes); most elements must agree exactly.

    Against the XLA composite: it rounds the scores to bfloat16 before
    scaling (paddle_tpu/fusion/decode_attention.py:52-53) and the kernel
    does not, so the two definitions differ by that rounding's effect on
    the softmax — atol 5e-2."""
    q, k, v, bias = _inputs(t, nh)
    port = _port(q, k, v, bias, torch.bfloat16)
    interp = _jax(q, k, v, bias, jnp.bfloat16, "pallas_interpret")
    np.testing.assert_allclose(port, interp, rtol=1e-2, atol=1e-2)
    assert np.mean(port == interp) > 0.9
    np.testing.assert_allclose(port, _jax(q, k, v, bias, jnp.bfloat16, "xla"),
                               atol=5e-2, rtol=0)


@pytest.mark.parametrize("rows", ["first_only", "masked_everywhere"])
def test_plain_matches_pallas_interpret_on_masked_rows(rows):
    """Rows whose mask hides every position but the first, or every
    position (bias -1e9, as the models build it): the first gives V[0]
    exactly, the second the uniform average of V, in the plain version as
    in the Pallas kernel. The CUDA kernel splits the cache into chunks, so
    most chunks of such rows are all masked; its merge must give them
    weight 0 beside a visible chunk, and equal weights when no position is
    visible (chip_smoke.py phase 3 holds it to this plain version on such
    rows). float32, atol 1e-5."""
    t = 96
    q, k, v, bias = _inputs(t, 4)
    hidden = 1 if rows == "first_only" else 0
    bias[1] = np.where(np.arange(t) < hidden, 0.0, -1e9).reshape(1, 1, 1, t)
    port = _port(q, k, v, bias, torch.float32)
    np.testing.assert_allclose(
        port, _jax(q, k, v, bias, jnp.float32, "pallas_interpret"),
        atol=1e-5, rtol=0)
    want = (v[1, 0, :, 0] if rows == "first_only" else v[1, 0].mean(1))
    np.testing.assert_allclose(port[1, 0, :, 0], want, atol=1e-5, rtol=0)


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    q, k, v, bias = _inputs(40, 4)
    kernels.reset_launch_counts()
    out = fused_decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(bias),
                                 scale=DH ** -0.5)
    assert kernels.LAUNCHES["decode_attention"] == 0
    direct = decode_attention_plain(
        torch.from_numpy(q).reshape(3, 4, DH),
        torch.from_numpy(k).reshape(3, 4, 40, DH),
        torch.from_numpy(v).reshape(3, 4, 40, DH),
        torch.from_numpy(bias).reshape(3, 1, 40).expand(3, 4, 40),
        DH ** -0.5)
    np.testing.assert_array_equal(out.reshape(3, 4, DH).numpy(),
                                  direct.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never computes on the CPU."""
    q, k, v, bias = _inputs(16, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_cuda(torch.from_numpy(q).reshape(3, 4, DH),
                              torch.from_numpy(k).reshape(3, 4, 16, DH),
                              torch.from_numpy(v).reshape(3, 4, 16, DH),
                              torch.from_numpy(bias).reshape(3, 1, 16)
                              .expand(3, 4, 16), 1.0)
    assert kernels.LAUNCHES["decode_attention"] == 0


@pytest.mark.parametrize("case", ["multi_position", "int8_kv"])
def test_off_slice_variants_raise(case):
    """G > 1 (speculative verify) and int8 KV are not silently composited."""
    q, k, v, bias = _inputs(16, 4)
    qt, kt, vt, bt = (torch.from_numpy(a) for a in (q, k, v, bias))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        if case == "multi_position":
            fused_decode_attention(qt.expand(3, 1, 4, 2, DH), kt, vt, bt)
        else:
            fused_decode_attention(qt, kt, vt, bt,
                                   k_scale=torch.ones(3, 1, 4, 2))
