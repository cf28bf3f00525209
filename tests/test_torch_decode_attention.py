"""The port's fused decode-attention step against the JAX package's.

The port's plain version (paddle_tpu_torch/fusion/decode_attention.py
`decode_attention_plain`, what a CPU tensor runs) is held against
`paddle_tpu.fusion.fused_decode_attention` run two ways: through the Pallas
kernel in interpret mode (`backend="pallas_interpret"`, as
tests/test_fusion.py runs it) — the function the port's CUDA kernel
implements — and through the XLA composite (`backend="xla"`). Inputs come
from a numpy seed and have the decode tick's layout: q [R,1,nh,1,dh],
K/V [R,1,nh,T,dh] float32 caches, bias [R,1,1,1,T] with each row's mask
ending at its own position. Verify windows (G > 1 query rows) and int8
caches (`quantize_kv_time_blocks`) are held against the JAX package's XLA
composite, which is what it runs for them. The CUDA kernel itself runs only
on the card (chip_smoke.py holds it against this plain version there).
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

from tests.port_env import port_jax_compile_cache  # noqa: F401

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


@pytest.mark.parametrize("t", [16, 64])
def test_bf16_cache_matches_pallas_interpret(t):
    """bfloat16 q over bfloat16 K and V (the encoder-decoder generator's
    cross-attention at beam 1: its keys and values come from bfloat16 fc
    layers). The Pallas kernel widens any cache to float32 and so does
    the port, on the card (the CUDA kernel, chip_smoke.py phase 3) and on
    the CPU (the plain version, here): as the bf16-q test above, one
    bfloat16 step apart at most, most elements exactly equal."""
    q, k, v, bias = _inputs(t, 4)
    kb, vb = (torch.from_numpy(a).bfloat16() for a in (k, v))
    out = fused_decode_attention(torch.from_numpy(q).bfloat16(), kb, vb,
                                 torch.from_numpy(bias), scale=DH ** -0.5)
    assert out.dtype == torch.bfloat16
    port = out.float().numpy()
    interp = np.asarray(jax_fused(
        jnp.asarray(q, dtype=jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(bias), scale=DH ** -0.5,
        backend="pallas_interpret").astype(jnp.float32))
    np.testing.assert_allclose(port, interp, rtol=1e-2, atol=1e-2)
    assert np.mean(port == interp) > 0.9


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


# -- verify windows (G > 1) and int8 caches -------------------------------


def _window(g, t=24, nh=4, r=3, seed=0, masked_row=False):
    """q [R,1,nh,G,dh] and a causal window mask [R,1,1,G,T]: row g of slot
    i sees positions <= base_i + g."""
    rng = np.random.RandomState(seed)
    q = rng.randn(r, 1, nh, g, DH).astype("float32")
    k = rng.randn(r, 1, nh, t, DH).astype("float32")
    v = rng.randn(r, 1, nh, t, DH).astype("float32")
    base = np.array([0, t // 3, t - g])[:r]
    keep = np.arange(t)[None, None] <= (base[:, None, None]
                                         + np.arange(g)[None, :, None])
    if masked_row:
        keep[1, 2] = False                 # one query row sees nothing
    bias = (keep.astype("float32") * 1e9 - 1e9).reshape(r, 1, 1, g, t)
    return q, k, v, bias


def _quant(a, bt):
    from paddle_tpu.fusion.decode_attention import quantize_kv_time_blocks
    pq, sc = quantize_kv_time_blocks(jnp.asarray(a), bt)
    return np.array(pq), np.array(sc)          # writable copies for torch


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [2, 5, 9])
def test_verify_window_matches_jax(g, q_dtype):
    """G query rows: the JAX package computes them through its XLA
    composite (the Pallas kernel is single-position). float32 at 1e-5;
    bfloat16 q at 5e-2 (the composite rounds the scores to bfloat16,
    the kernel and the plain version do not)."""
    q, k, v, bias = _window(g)
    jd, td = (jnp.float32, torch.float32) if q_dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    port = _port(q, k, v, bias, td)
    assert port.shape == q.shape
    np.testing.assert_allclose(port, _jax(q, k, v, bias, jd, "xla"),
                               atol=1e-5 if q_dtype == "float32" else 5e-2,
                               rtol=0)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bt", [8, 3])
@pytest.mark.parametrize("g", [1, 5])
def test_int8_cache_matches_jax(g, bt, q_dtype):
    """int8 K and V with one scale per bt positions: the JAX package
    dequantizes to q's dtype and runs the composite; the port's plain
    version dequantizes the same way (what the kernel does per element).
    Tolerances as for the float32 cache."""
    q, k, v, bias = _window(g, seed=bt)
    (kq, ks), (vq, vs) = _quant(k, bt), _quant(v, bt)
    jd, td = (jnp.float32, torch.float32) if q_dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    want = np.asarray(jax_fused(
        jnp.asarray(q, dtype=jd), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(bias), scale=DH ** -0.5, backend="xla",
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)).astype(
            jnp.float32))
    got = fused_decode_attention(
        torch.from_numpy(q).to(td), torch.from_numpy(kq),
        torch.from_numpy(vq), torch.from_numpy(bias), scale=DH ** -0.5,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=1e-5 if q_dtype == "float32" else 5e-2,
                               rtol=0)


def test_window_with_a_fully_masked_row_matches_pallas_and_xla():
    """A query row that sees no position gives the uniform average of V,
    as the JAX package's composite does."""
    q, k, v, bias = _window(5, masked_row=True)
    port = _port(q, k, v, bias, torch.float32)
    np.testing.assert_allclose(port, _jax(q, k, v, bias, jnp.float32, "xla"),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port[1, 0, :, 2], v[1, 0].mean(1),
                               atol=1e-5, rtol=0)


def test_window_rows_equal_single_position_calls():
    """Each row of a G = 5 call equals a G = 1 call with that row's q and
    bias (the plain version here; chip_smoke.py asserts the kernel's rows
    bit-equal on the card)."""
    q, k, v, bias = _window(5)
    args = [torch.from_numpy(a) for a in (q, k, v, bias)]
    whole = fused_decode_attention(*args, scale=DH ** -0.5)
    for g in range(5):
        one = fused_decode_attention(args[0][..., g:g + 1, :], args[1],
                                     args[2], args[3][..., g:g + 1, :],
                                     scale=DH ** -0.5)
        np.testing.assert_allclose(one[..., 0, :].numpy(),
                                   whole[..., g, :].numpy(), atol=1e-6,
                                   rtol=0)


def test_gradients_at_g5_match_jax():
    """q, bias and (int8 caches) the scales take the JAX package's
    gradients at G = 5; the int8 payloads take none. float32, 1e-5."""
    import jax
    q, k, v, bias = _window(5, seed=3)
    (kq, ks), (vq, vs) = _quant(k, 8), _quant(v, 8)
    cot = np.random.RandomState(4).randn(*q.shape).astype("float32")

    def jloss(q_, b_, ks_, vs_):
        out = jax_fused(q_, jnp.asarray(kq), jnp.asarray(vq), b_,
                        scale=DH ** -0.5, backend="xla", k_scale=ks_,
                        v_scale=vs_)
        return jnp.sum(out * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(q), jnp.asarray(bias), jnp.asarray(ks), jnp.asarray(vs))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (q, bias, ks, vs)]
    kt, vt = torch.from_numpy(kq), torch.from_numpy(vq)
    out = fused_decode_attention(leaves[0], kt, vt, leaves[1],
                                 scale=DH ** -0.5, k_scale=leaves[2],
                                 v_scale=leaves[3])
    (out * torch.from_numpy(cot)).sum().backward()
    for leaf, w, name in zip(leaves, want, ("q", "bias", "k_scale",
                                            "v_scale")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert kt.grad is None and vt.grad is None
    # float32 caches at G = 5: q and bias against jax.grad as well
    qt, bt_ = (torch.from_numpy(a).requires_grad_() for a in (q, bias))
    (fused_decode_attention(qt, torch.from_numpy(k), torch.from_numpy(v),
                            bt_, scale=DH ** -0.5)
     * torch.from_numpy(cot)).sum().backward()
    jq, jb = jax.grad(lambda q_, b_: jnp.sum(jax_fused(
        q_, jnp.asarray(k), jnp.asarray(v), b_, scale=DH ** -0.5,
        backend="xla") * cot), argnums=(0, 1))(jnp.asarray(q),
                                               jnp.asarray(bias))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(jq), atol=1e-5)
    np.testing.assert_allclose(bt_.grad.numpy(), np.asarray(jb), atol=1e-5)


def test_cpu_window_and_int8_calls_count_no_launch():
    q, k, v, bias = _window(5)
    (kq, ks), (vq, vs) = _quant(k, 8), _quant(v, 8)
    kernels.reset_launch_counts()
    fused_decode_attention(*(torch.from_numpy(a) for a in (q, kq, vq, bias)),
                           scale=DH ** -0.5, k_scale=torch.from_numpy(ks),
                           v_scale=torch.from_numpy(vs))
    assert kernels.LAUNCHES["decode_attention"] == 0
    assert kernels.LAUNCHES["decode_attention_multi"] == 0
    assert kernels.LAUNCHES["decode_attention_int8"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_cuda(torch.from_numpy(q[:, 0]),
                              torch.from_numpy(kq[:, 0]),
                              torch.from_numpy(vq[:, 0]),
                              torch.from_numpy(bias[:, 0]).expand(
                                  3, 4, 5, 24), 1.0,
                              torch.from_numpy(ks[:, 0]),
                              torch.from_numpy(vs[:, 0]))
