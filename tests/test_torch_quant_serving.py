"""Weight-quantized serving of the port against the JAX package's.

The 2-D block quantization, the int4 nibble packing and the int8 KV time
blocks must give the JAX package's payloads and scales byte for byte on
the same numpy input (both divide and round half to even).
`quantize_params_pass` must rewrite a tick program into the JAX package's
JSON and resident payloads; `qmatmul` and `qlookup` are held against the
JAX registry (float32 at 1e-5: the products sum in another order). The
quantized engines (int8 and int4 weights on the slot engine, int8 KV
pools on the paged engine) run the small LM (vocab 64, d_model 32, 2
layers) from the JAX package's initial weights in float32 and must
generate the JAX engines' tokens.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.fusion.decode_attention import \
    quantize_kv_time_blocks as jquant_kv
from paddle_tpu.framework import registry as jreg
from paddle_tpu.framework.passes import get_pass as jget_pass
from paddle_tpu.models import transformer as jtr
from paddle_tpu.parallel import collective as jcol
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import PagedKVEngine as JPaged

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.fusion import quantize_kv_time_blocks
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.parallel import collective as tcol
from paddle_tpu_torch.serving import ContinuousBatchingEngine, PagedKVEngine

from tests.port_env import port_jax_compile_cache  # noqa: F401

DIMS = dict(vocab=64, max_len=32, d_model=32, d_inner=64, num_heads=4,
            num_layers=2)
PROMPTS = [[7], [3, 9], [11, 2, 5], [40, 41, 42, 43, 44, 45, 46],
           [5, 6, 7, 8, 9, 10, 11, 12, 13]]
CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = {n: (jflags.get_flag(n), tflags.get_flag(n))
             for n in ("use_bf16_matmul", "quant_params")}
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    for n, (jv, tv) in saved.items():
        jflags.set_flag(n, jv)
        tflags.set_flag(n, tv)


@pytest.fixture(scope="module")
def float32_mode():
    """Both packages in float32 while the module's fixtures build; the
    flags are restored when the module ends (a module fixture is set up
    before the per-test fixture saves them)."""
    saved = (jflags.get_flag("use_bf16_matmul"),
             tflags.get_flag("use_bf16_matmul"))
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)
    yield
    jflags.set_flag("use_bf16_matmul", saved[0])
    tflags.set_flag("use_bf16_matmul", saved[1])


@pytest.fixture(scope="module")
def params(float32_mode):
    jscope = pt.Scope()
    eng = JEngine(n_slots=3, scope=jscope, **DIMS)
    return {p.name: np.asarray(jscope.get(p.name))
            for p in eng._program.all_parameters()}


def _jscope(params):
    scope = pt.Scope()
    for n, a in params.items():
        scope.set_var(n, jnp.asarray(a))
    return scope


def _tscope(params):
    return ptt.load_numpy_params(params, ptt.Scope(), CPU)


def _gen(eng, prompts=PROMPTS, max_new=8):
    reqs = [eng.submit(list(p), max_new=max_new) for p in prompts]
    eng.run_until_idle()
    return [list(r.tokens) for r in reqs]


# -- quantized payloads: byte-equal ---------------------------------------


def _weights(shape, seed):
    rng = np.random.RandomState(seed)
    w = (rng.randn(*shape) * 3).astype("float32")
    w[:min(4, shape[0])] = 0.0                          # zero tiles
    # values whose quotient by the tile's scale lands on .5 (a tie)
    w[-1, :4] = np.array([127.0, 0.5, -2.5, 63.5], "float32")[:shape[1]]
    return w


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(64, 96), (50, 30), (7, 10), (128, 200)])
def test_quantize_blocks_2d_byte_equal(shape, bits):
    w = _weights(shape, seed=shape[0])
    jq, js = jcol.quantize_blocks_2d(w, bits=bits)
    tq, ts = tcol.quantize_blocks_2d(w, bits=bits)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcol.dequantize_blocks_2d(tq, ts, bits=bits).numpy(),
        np.asarray(jcol.dequantize_blocks_2d(jq, js, bits=bits)))
    assert tcol.block_dims_2d(shape) == jcol.block_dims_2d(shape)


def test_int4_pack_unpack_byte_equal_and_exact():
    rng = np.random.RandomState(4)
    q = rng.randint(-7, 8, (9, 16)).astype("int8")
    tp = tcol.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(tp.numpy(),
                                  np.asarray(jcol.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tcol.unpack_int4(tp).numpy(), q)


@pytest.mark.parametrize("t,block", [(24, 8), (20, 8), (7, 8), (9, 3)])
def test_quantize_kv_time_blocks_byte_equal(t, block):
    rng = np.random.RandomState(t)
    kv = rng.randn(2, 3, t, 5).astype("float32")
    kv[0, 1] = 0.0                                       # zero tiles
    jq, js = jquant_kv(jnp.asarray(kv), block)
    tq, ts = quantize_kv_time_blocks(torch.from_numpy(kv), block)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# -- the pass: the JAX package's program and payloads ----------------------


def _tick_programs(params, builder, bits, **kw):
    """The tick `builder` in both packages, quantized by each package's
    pass over a scope holding `params`; returns ((jprog, jscope),
    (tprog, tscope))."""
    out = []
    for pk, tr, scope, get_pass in (
            (pt, jtr, _jscope(params), jget_pass),
            (ptt, ttr, _tscope(params), ptt.get_pass)):
        m, s = pk.Program(), pk.Program()
        with pk.program_guard(m, s), pk.unique_name.guard():
            getattr(tr, builder)(cache_prefix="q", **kw)
        get_pass("quantize_params_pass", bits=bits)(m, scope)
        out.append((m, scope))
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_pass_program_and_payloads_equal(params, bits):
    (jm, js), (tm, ts) = _tick_programs(
        params, "transformer_lm_decode_tick", bits, n_slots=3, **DIMS)
    assert tm.to_json() == jm.to_json()
    types = [op.type for op in tm.global_block().ops]
    assert types.count("qmatmul") == 2 * 6 + 1 and "qlookup" in types
    assert "mul" not in types and "lookup_table" not in types
    for name in params:
        if ts.has_var(name + "@qparam"):
            assert not ts.has_var(name)                  # f32 erased
            np.testing.assert_array_equal(
                ts.get(name + "@qparam").numpy(),
                np.asarray(js.get(name + "@qparam")))
            np.testing.assert_array_equal(
                ts.get(name + "@qscale").numpy(),
                np.asarray(js.get(name + "@qscale")))
        else:                      # biases and layer norms stay f32
            assert ts.get(name).dim() == 1


def test_quantize_params_pass_twin_reuses_resident_payloads(params):
    """A verify program quantized after the tick over the same scope reads
    the tick's payload tensors (same objects), and its JSON is the JAX
    package's twin's."""
    built = []
    for pk, tr, scope, get_pass in (
            (pt, jtr, _jscope(params), jget_pass),
            (ptt, ttr, _tscope(params), ptt.get_pass)):
        progs = []
        for builder, kw in (("transformer_lm_decode_tick", {}),
                            ("transformer_lm_spec_verify_tick",
                             {"gamma": 3})):
            m, s = pk.Program(), pk.Program()
            with pk.program_guard(m, s), pk.unique_name.guard():
                getattr(tr, builder)(n_slots=3, cache_prefix="q", **kw,
                                     **DIMS)
            if builder != "transformer_lm_decode_tick":
                payload = scope.get("lm_head.w_0@qparam")
            get_pass("quantize_params_pass", bits=8)(m, scope)
            progs.append(m)
        assert scope.get("lm_head.w_0@qparam") is payload
        built.append([p.to_json() for p in progs])
    assert built[0] == built[1]


def test_quantize_params_pass_refuses_other_bits():
    with pytest.raises(InvalidArgumentError):
        ptt.get_pass("quantize_params_pass", bits=2)(ptt.Program(),
                                                    ptt.Scope())


# -- qmatmul / qlookup against the JAX registry ---------------------------


def _both(op_type, ins, attrs):
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs))
    tout = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {k: [torch.from_numpy(np.array(a)) for a in v]
                          for k, v in ins.items()}, dict(attrs))
    jv = np.asarray(jout["Out"][0].astype(jnp.float32))
    return jv, tout["Out"][0].float().numpy(), tout["Out"][0].dtype


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("bf16", [False, True])
def test_qmatmul_matches_jax(bits, bf16):
    rng = np.random.RandomState(bits)
    w = _weights((64, 48), seed=9)
    q, s = jcol.quantize_blocks_2d(w, bits=bits)
    x = rng.randn(3, 1, 64).astype("float32")
    attrs = {"bits": bits, "x_num_col_dims": 2}
    if bf16:
        attrs["use_bf16"] = True
    jflags.set_flag("use_bf16_matmul", True)
    tflags.set_flag("use_bf16_matmul", True)
    jv, tv, dt = _both("qmatmul", {"X": [x], "QW": [np.asarray(q)],
                                   "Scales": [np.asarray(s)]}, attrs)
    assert tv.shape == (3, 1, 48)
    assert dt == (torch.bfloat16 if bf16 else torch.float32)
    # bf16: one or two bfloat16 steps (sums in another order before the
    # one rounding); float32: summation order
    np.testing.assert_allclose(tv, jv, rtol=2e-2 if bf16 else 1e-5,
                               atol=2e-2 if bf16 else 1e-5)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", ["plain", "padding_idx", "neg_padding_idx",
                                  "zero_rows", "out_of_range"])
def test_qlookup_matches_jax(bits, case):
    w = _weights((40, 16), seed=3)
    q, s = jcol.quantize_blocks_2d(w, bits=bits, block=8)
    ids = np.array([[0], [5], [39], [5], [17]], "int64")
    attrs = {"bits": bits}
    if case == "padding_idx":
        attrs["padding_idx"] = 5
    elif case == "neg_padding_idx":
        attrs["padding_idx"] = -1                        # the last row
    elif case == "out_of_range":
        ids = np.array([[-1], [40], [-41], [3]], "int64")
    jv, tv, _ = _both("qlookup", {"Ids": [ids], "QW": [np.asarray(q)],
                                  "Scales": [np.asarray(s)]}, attrs)
    np.testing.assert_array_equal(np.isnan(tv), np.isnan(jv))
    np.testing.assert_allclose(tv, jv, rtol=0, atol=0)
    if case == "zero_rows":
        assert (tv[0] == 0).all()                        # zero tile exact


# -- the engines: the JAX engines' tokens ---------------------------------


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_quant_engine_tokens_match_jax(params, quant):
    jeng = JEngine(n_slots=3, scope=_jscope(params), quant=quant, **DIMS)
    teng = ContinuousBatchingEngine(n_slots=3, scope=_tscope(params),
                                    quant=quant, place=CPU, **DIMS)
    assert teng.quant == quant
    assert teng.params_bytes_f32 == jeng.params_bytes_f32
    assert teng.quant_freed_bytes == jeng.quant_freed_bytes > 0
    ratio = teng.params_bytes_f32 / teng.params_bytes_quantized
    assert ratio > (2.0 if quant == "int8" else 3.0)
    got, want = _gen(teng), _gen(jeng)
    assert got == want
    assert len({t for r in got for t in r}) > 4


def test_int4_first_tokens_match_float32():
    """The JAX package's own bound for int4 (tests/test_quant_serving.py:
    226-239), at its configuration (vocab 50, max_len 16, the default
    bfloat16 matmuls, its three prompts, weights from its engine's startup
    program): every sequence's first token matches float32, in the JAX
    package and in the port."""
    dims = dict(DIMS, vocab=50, max_len=16)
    prompts = ([7], [3, 9], [11, 2, 5])
    jflags.set_flag("use_bf16_matmul", True)
    tflags.set_flag("use_bf16_matmul", True)
    jscope = pt.Scope()
    jf32 = JEngine(n_slots=3, scope=jscope, **dims)
    w = {p.name: np.asarray(jscope.get(p.name))
         for p in jf32._program.all_parameters()}
    jq4 = JEngine(n_slots=3, scope=_jscope(w), quant="int4", **dims)
    f32 = ContinuousBatchingEngine(n_slots=3, scope=_tscope(w), place=CPU,
                                   **dims)
    q4 = ContinuousBatchingEngine(n_slots=3, scope=_tscope(w),
                                  quant="int4", place=CPU, **dims)
    firsts = [[r[0] for r in _gen(e, prompts, 6)]
              for e in (jf32, jq4, f32, q4)]
    assert firsts[0] == firsts[1]                 # the JAX package's bound
    assert firsts[2] == firsts[3]                 # the port's
    assert firsts[3] == firsts[1]


def test_kv_quant_paged_engine_tokens_match_jax(params):
    kw = dict(n_slots=3, block_size=4, kv_quant=True)
    jeng = JPaged(scope=_jscope(params), **kw, **DIMS)
    teng = PagedKVEngine(scope=_tscope(params), place=CPU, **kw, **DIMS)
    assert teng.n_blocks == jeng.n_blocks
    assert teng.kv_quant_freed_bytes == jeng.kv_quant_freed_bytes > 0
    assert teng.scope.get(teng.cache_names[0]).dtype == torch.int8
    assert _gen(teng) == _gen(jeng)
    teng.pager.pool.check()


def test_paged_engine_over_int8_weights_matches_jax(params):
    kw = dict(n_slots=3, block_size=4, quant="int8")
    jeng = JPaged(scope=_jscope(params), **kw, **DIMS)
    teng = PagedKVEngine(scope=_tscope(params), place=CPU, **kw, **DIMS)
    assert _gen(teng) == _gen(jeng)


def test_kill_switch_keeps_the_engine_float32(params):
    tflags.set_flag("quant_params", False)
    eng = ContinuousBatchingEngine(n_slots=3, scope=_tscope(params),
                                   quant="int8", place=CPU, **DIMS)
    assert eng.quant is None and eng.quant_freed_bytes == 0
    assert "qmatmul" not in [op.type for op in
                             eng._program.global_block().ops]
    with pytest.raises(InvalidArgumentError):
        ContinuousBatchingEngine(n_slots=3, quant="int2", place=CPU, **DIMS)


def test_quant_engine_defaults_to_the_card():
    """Without a card the default place raises instead of dropping to the
    CPU; with one it is CUDAPlace(0)."""
    if torch.cuda.is_available():
        assert ptt.default_place() == ptt.CUDAPlace(0)
        return
    from paddle_tpu_torch.core.enforce import UnavailableError
    with pytest.raises(UnavailableError):
        ContinuousBatchingEngine(n_slots=2, quant="int8", **DIMS)
