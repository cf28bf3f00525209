"""Speculative decoding of the port against the JAX package's.

Small model (vocab 64, d_model 32, d_inner 64, 4 heads, 2 layers, max_len
32, 3 slots) from the JAX package's initial weights, float32 in both
packages. Greedy speculative decoding must give the JAX package's tokens
on the slot engine and on the paged engine (float32 and int8 KV pools,
float32 and int8 target weights) for every draft precision, and the
port's own target-only tokens: a draft token is accepted only where it
equals the target's argmax. `rejection_sample` must draw the JAX
function's tokens from the same `numpy.random.RandomState` seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.serving import ContinuousBatchingEngine as JEngine
from paddle_tpu.serving import PagedKVEngine as JPaged
from paddle_tpu.serving import SpecConfig as JSpec
from paddle_tpu.serving import rejection_sample as jreject

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework.costs import state_category
from paddle_tpu_torch.serving import (ContinuousBatchingEngine,
                                      PagedKVEngine, SpecConfig,
                                      rejection_sample)

DIMS = dict(vocab=64, max_len=32, d_model=32, d_inner=64, num_heads=4,
            num_layers=2)
CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = {n: (jflags.get_flag(n), tflags.get_flag(n))
             for n in ("use_bf16_matmul",)}
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


def _drive(eng, n_requests=5, max_new=10, seed=0):
    rng = np.random.RandomState(seed)
    reqs = []
    for _ in range(n_requests):
        p = rng.randint(1, DIMS["vocab"], size=rng.randint(2, 8)).tolist()
        reqs.append(eng.submit(p, max_new=max_new))
    eng.run_until_idle(max_ticks=4000)
    assert all(r.done for r in reqs)
    return [r.tokens for r in reqs]


@pytest.fixture(scope="module")
def target_tokens(params):
    """Target-only tokens of the port's slot engine and of the JAX
    package's, which must agree."""
    want = _drive(JEngine(n_slots=3, scope=_jscope(params), **DIMS))
    got = _drive(ContinuousBatchingEngine(n_slots=3, scope=_tscope(params),
                                          place=CPU, **DIMS))
    assert got == want
    assert len({t for r in got for t in r}) > 4
    return got


@pytest.mark.parametrize("draft", ["f32", "int8", "int4"])
def test_greedy_slot_engine_matches_jax_and_target_only(params,
                                                       target_tokens, draft):
    spec = lambda S: S(gamma=4, draft=draft)                   # noqa: E731
    jeng = JEngine(n_slots=3, scope=_jscope(params), speculative=spec(JSpec),
                   **DIMS)
    teng = ContinuousBatchingEngine(n_slots=3, scope=_tscope(params),
                                    speculative=spec(SpecConfig), place=CPU,
                                    **DIMS)
    got = _drive(teng)
    assert got == target_tokens
    assert got == _drive(jeng)
    ts, js = teng.spec.stats(), jeng.spec.stats()
    for k in ("rounds", "draft_ticks", "verify_forwards", "draft_proposed",
              "draft_accepted", "draft_param_bytes"):
        assert ts[k] == js[k], k
    assert ts["rounds"] > 0 and teng.target_forwards == jeng.target_forwards
    assert teng.tokens_out / teng.target_forwards > 1.0


@pytest.mark.parametrize("kw", [{"draft": "int8"}, {"draft": "int4"},
                                {"draft": "int8", "kv_quant": True},
                                {"draft": "int8", "quant": "int8"}],
                         ids=["int8", "int4", "kv_quant", "int8_target"])
def test_greedy_paged_engine_matches_jax(params, target_tokens, kw):
    kw = dict(kw)
    draft = kw.pop("draft")
    jeng = JPaged(n_slots=3, block_size=8, scope=_jscope(params),
                  speculative=JSpec(gamma=4, draft=draft), **kw, **DIMS)
    teng = PagedKVEngine(n_slots=3, block_size=8, scope=_tscope(params),
                         speculative=SpecConfig(gamma=4, draft=draft),
                         place=CPU, **kw, **DIMS)
    got = _drive(teng)
    assert got == _drive(jeng)
    if not kw:                  # float32 weights and pools: target-only
        assert got == target_tokens
    teng.pager.pool.check()
    assert teng.pager.stats() == jeng.pager.stats()
    assert teng.spec.stats()["draft_accepted"] == \
        jeng.spec.stats()["draft_accepted"]


def test_verify_window_equals_sequential_plain_ticks(params):
    """The G-wide verify forward writes the caches the plain tick would
    write feeding the same tokens one at a time, and scores the same
    next tokens (the fused attention's rows are the plain tick's)."""
    from paddle_tpu_torch.models import transformer as ttr
    g, s = 4, 3
    rng = np.random.RandomState(2)
    toks = rng.randint(1, 64, (s, g)).astype("int64")
    base = np.array([0, 5, 17], "float32").reshape(s, 1, 1)
    outs = []
    for verify in (False, True):
        scope = _tscope(params)
        m, st = ptt.Program(), ptt.Program()
        with ptt.program_guard(m, st), ptt.unique_name.guard():
            if verify:
                ids, _, caches = ttr.transformer_lm_spec_verify_tick(
                    n_slots=s, gamma=g - 1, cache_prefix="w", **DIMS)
            else:
                ids, caches = ttr.transformer_lm_decode_tick(
                    n_slots=s, cache_prefix="w", **DIMS)
        exe = ptt.Executor(CPU)
        tmp = ptt.Scope()
        exe.run(st, scope=tmp)
        for n in tmp.local_var_names():
            if not scope.has_var(n):
                scope.set_var(n, tmp.get(n))
        if verify:
            got = exe.run(m, feed={"spec_tok": toks, "spec_pos": base},
                          fetch_list=[ids], scope=scope)[0]
        else:
            got = np.concatenate([
                exe.run(m, feed={"tick_tok": toks[:, j:j + 1],
                                 "tick_pos": base + j},
                        fetch_list=[ids], scope=scope)[0]
                for j in range(g)], axis=1)
        outs.append((got, [scope.get(c).numpy() for c in caches]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    for a, b in zip(outs[1][1], outs[0][1]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_rejection_sample_draws_the_jax_tokens(seed):
    rng = np.random.RandomState(seed)
    p = rng.dirichlet(np.ones(6) * 0.7)
    q = rng.dirichlet(np.ones(6) * 0.7)
    draws = rng.randint(0, 6, 300)
    jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
    want = [jreject(p, q, d, jr) for d in draws]
    got = [rejection_sample(p, q, d, tr) for d in draws]
    assert got == want
    # identical distributions always accept
    assert all(rejection_sample(p, p, d, tr)[1] for d in draws[:20])


def test_rejection_sample_preserves_the_target_distribution():
    p = np.array([0.5, 0.3, 0.15, 0.05])
    q = np.array([0.05, 0.15, 0.3, 0.5])        # adversarial draft
    rng = np.random.RandomState(0)
    counts = np.zeros(4)
    for _ in range(20000):
        d = int(rng.choice(4, p=q))
        tok, _ = rejection_sample(p, q, d, rng)
        counts[tok] += 1
    np.testing.assert_allclose(counts / counts.sum(), p, atol=0.015)


def test_sampling_mode_completes(params):
    eng = ContinuousBatchingEngine(
        n_slots=2, scope=_tscope(params), place=CPU,
        speculative=SpecConfig(gamma=3, draft="int8", sampling=True,
                               seed=11), **DIMS)
    toks = _drive(eng, n_requests=4, max_new=8)
    assert all(len(t) == 8 for t in toks)
    assert eng.spec.stats()["rounds"] > 0


def test_rollback_keeps_the_pool_whole_over_100_cycles(params,
                                                       monkeypatch):
    """int4 draft (real rejections, real rollbacks) on a small pool
    (prefix-cache eviction every cycle): the pool is checked every round
    (PTPU_SPEC_POOL_CHECK=1) and after every cycle."""
    monkeypatch.setenv("PTPU_SPEC_POOL_CHECK", "1")
    eng = PagedKVEngine(n_slots=2, scope=_tscope(params), block_size=4,
                        n_blocks=11, place=CPU,
                        speculative=SpecConfig(gamma=4, draft="int4"),
                        **DIMS)
    pool = eng.pager.pool
    rng = np.random.RandomState(3)
    for cycle in range(100):
        p = rng.randint(1, DIMS["vocab"], size=rng.randint(2, 6)).tolist()
        eng.submit(p, max_new=6)
        if cycle % 3 == 0:
            eng.submit(p, max_new=4)
        eng.run_until_idle(max_ticks=2000)
        pool.check()
        assert pool.n_used + pool.n_free == pool.n_blocks - 1
    assert eng.n_active == 0 and eng.n_pending == 0
    assert eng.spec.stats()["rolled_back_blocks"] > 0
    assert eng.pager.stats()["rolled_back_blocks"] == \
        eng.spec.stats()["rolled_back_blocks"]


def test_draft_census_and_subphases(params):
    eng = ContinuousBatchingEngine(
        n_slots=2, scope=_tscope(params), place=CPU,
        speculative=SpecConfig(gamma=2, draft="int8"), **DIMS)
    names = [n for n in eng.scope.local_var_names()
             if n.startswith("draft_")]
    assert any(n.endswith("@qparam") for n in names)
    assert {state_category(None, n) for n in names
            if "@q" in n} == {"params_draft"}
    assert eng.spec.draft_param_bytes() > 0
    req = eng.submit([3, 4, 5], 6)
    eng.run_until_idle()
    ph = req.phases(subphases=True)
    assert ph["spec_draft"] > 0 and ph["spec_verify"] > 0
    assert ph["spec_draft"] + ph["spec_verify"] <= \
        ph["prefill"] + ph["decode"] + 1e-6
    # the JAX package's four phases; transport is 0 without a server
    assert set(req.phases()) == {"queue_wait", "prefill", "decode",
                                 "transport"}
    assert req.phases()["transport"] == 0.0


def test_spec_config_validation():
    with pytest.raises(InvalidArgumentError):
        SpecConfig(gamma=0)
    with pytest.raises(InvalidArgumentError):
        SpecConfig(draft="int2")
    with pytest.raises(InvalidArgumentError):
        ContinuousBatchingEngine(n_slots=2, place=CPU, speculative=3,
                                 **DIMS)


def test_spec_engine_defaults_to_the_card():
    """Without a card the default place raises instead of dropping to the
    CPU; with one it is CUDAPlace(0)."""
    if torch.cuda.is_available():
        assert ptt.default_place() == ptt.CUDAPlace(0)
        return
    from paddle_tpu_torch.core.enforce import UnavailableError
    with pytest.raises(UnavailableError):
        PagedKVEngine(n_slots=2, speculative=SpecConfig(), **DIMS)
