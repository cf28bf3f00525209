"""The serving slice as a whole: the port's decode tick and continuous-
batching engine against the JAX package's.

Small model (vocab 97, d_model 64, d_inner 128, 4 heads, 2 layers, 4 slots,
max_len 32). Weights come from the JAX package's startup program and carry
across by name with `load_numpy_params`; feeds and cache contents come from
a numpy seed. Tolerances: float32 mode (use_bf16_matmul off in both
packages) at 1e-4 on logits and caches — the packages sum in different
orders; the default bfloat16 matmuls at 5e-2 on logits — the products
round to bfloat16 at different points of differently ordered sums.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.passes import apply_fusion_passes as jax_fuse
from paddle_tpu.models import transformer as jtr
from paddle_tpu.serving_engine import \
    ContinuousBatchingEngine as JaxEngine

import paddle_tpu_torch as ptt
from paddle_tpu_torch import kernels
from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                           UnavailableError)
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework.passes import apply_fusion_passes as port_fuse
from paddle_tpu_torch.framework.program import Program as PortProgram
from paddle_tpu_torch.models import transformer as ttr

from tests.port_env import port_jax_compile_cache  # noqa: F401

DIMS = dict(vocab=97, max_len=32, d_model=64, d_inner=128, num_heads=4,
            num_layers=2)
S = 4
LOGITS = "lm_head.tmp_1"


@pytest.fixture(autouse=True)
def fresh_port_state():
    """The port's counterpart of tests/conftest.py's fresh_state: fresh
    default programs, scope and name generator; flags restored."""
    saved = {n: (jflags.get_flag(n), tflags.get_flag(n))
             for n in ("use_bf16_matmul", "fuse_decode_attention")}
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    for n, (jv, tv) in saved.items():
        jflags.set_flag(n, jv)
        tflags.set_flag(n, tv)


def _set_bf16(on):
    jflags.set_flag("use_bf16_matmul", on)
    tflags.set_flag("use_bf16_matmul", on)


def _build_ticks():
    jprog, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jprog, jstart), pt.unique_name.guard():
        jids, jcaches = jtr.transformer_lm_decode_tick(
            n_slots=S, cache_prefix="srv", **DIMS)
    tprog, tstart = ptt.Program(), ptt.Program()
    with ptt.program_guard(tprog, tstart), ptt.unique_name.guard():
        tids, tcaches = ttr.transformer_lm_decode_tick(
            n_slots=S, cache_prefix="srv", **DIMS)
    assert jcaches == tcaches and jids.name == tids.name
    return (jprog, jstart, jids, jcaches), (tprog, tstart, tids, tcaches)


def test_program_matches_and_loads_from_jax_json():
    (jprog, jstart, jids, caches), (tprog, tstart, _, _) = _build_ticks()
    # same IR, same serialization, both programs
    assert tprog.to_json() == jprog.to_json()
    assert tstart.to_json() == jstart.to_json()
    # the JAX package's JSON loads in the port as the same program
    loaded = PortProgram.from_json(jprog.to_json())
    assert loaded.to_json() == tprog.to_json()
    # and both fuse the same way: one fused_decode_attention per layer
    protected = {jids.name, *caches}
    jtypes = [op.type for op in
              jax_fuse(jprog, protected).global_block().ops]
    ttypes = [op.type for op in
              port_fuse(tprog, protected).global_block().ops]
    assert ttypes == jtypes
    assert ttypes.count("fused_decode_attention") == DIMS["num_layers"]
    assert "softmax" not in ttypes


def test_card_executor_refuses_an_unfused_decode_chain():
    """On a CUDA device (require_fused) decode attention runs only through
    its kernel: a chain left unfused raises, whether the fusion flag is off
    or an intermediate of the chain is fetched. On the CPU both run."""
    _, (tprog, _, tids, caches) = _build_ticks()
    protected = {tids.name, *caches}
    fused = port_fuse(tprog, protected, require_fused=True)
    assert [op.type for op in fused.global_block().ops].count(
        "fused_decode_attention") == DIMS["num_layers"]
    tflags.set_flag("fuse_decode_attention", False)
    assert port_fuse(tprog, protected) is tprog
    with pytest.raises(InvalidArgumentError, match="flag is off"):
        port_fuse(tprog, protected, require_fused=True)
    tflags.set_flag("fuse_decode_attention", True)
    sm_out = next(op.outputs["Out"][0] for op in tprog.global_block().ops
                  if op.type == "softmax")
    partly = port_fuse(tprog, protected | {sm_out})
    assert [op.type for op in partly.global_block().ops].count(
        "fused_decode_attention") == DIMS["num_layers"] - 1
    with pytest.raises(InvalidArgumentError, match="fetched or read"):
        port_fuse(tprog, protected | {sm_out}, require_fused=True)


def _tick_pair(bf16, seed=0):
    """One tick through both executors from the same weights, caches and
    feeds; returns (jax fetches, port fetches) as numpy."""
    _set_bf16(bf16)
    (jprog, jstart, jids, caches), (tprog, _, tids, _) = _build_ticks()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    rng = np.random.RandomState(seed)
    params = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    for n in caches:       # non-trivial cache contents in every slot
        params[n] = (rng.randn(*params[n].shape) * 0.5).astype("float32")
        jscope.set_var(n, jnp.asarray(params[n]))
    tscope = ptt.load_numpy_params(params, ptt.Scope(), ptt.CPUPlace())
    feed = {"tick_tok": rng.randint(0, DIMS["vocab"], (S, 1)).astype("int64"),
            # slot 0 at the first position, slot 3 at the last
            "tick_pos": np.array([0, 5, 17, 31], "float32").reshape(S, 1, 1)}
    fetch = [LOGITS, jids.name] + caches
    jout = pt.Executor().run(jprog, feed=feed, fetch_list=fetch,
                             scope=jscope)
    tout = ptt.Executor(ptt.CPUPlace()).run(tprog, feed=feed,
                                            fetch_list=fetch, scope=tscope)
    return [np.asarray(a, dtype="float32") for a in jout], \
        [np.asarray(a, dtype="float32") for a in tout]


def test_one_tick_f32_matches_jax():
    jout, tout = _tick_pair(bf16=False)
    np.testing.assert_allclose(tout[0], jout[0], atol=1e-4, rtol=0,
                               err_msg="logits")
    np.testing.assert_array_equal(tout[1], jout[1])        # next ids
    for i, (a, b) in enumerate(zip(tout[2:], jout[2:])):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0,
                                   err_msg=f"cache {i}")


def test_one_tick_bf16_matches_jax():
    jout, tout = _tick_pair(bf16=True)
    np.testing.assert_allclose(tout[0], jout[0], atol=5e-2, rtol=0,
                               err_msg="logits")


def _prompts():
    rng = np.random.RandomState(11)
    return [rng.randint(0, DIMS["vocab"], n).tolist()
            for n in (3, 9, 1, 14, 6, 11)]


def _jax_engine_and_params():
    jscope = pt.Scope()
    jeng = JaxEngine(n_slots=S, scope=jscope, **DIMS)
    names = [p.name for p in jeng._program.all_parameters()]
    return jeng, {n: np.asarray(jscope.get(n)) for n in names}


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_engine_tokens_identical_to_jax_f32(policy):
    """Six requests through four slots (slots are reused mid-run): every
    request generates exactly the JAX engine's tokens."""
    _set_bf16(False)
    jeng, params = _jax_engine_and_params()
    jeng.policy = policy
    teng = ptt.ContinuousBatchingEngine(
        n_slots=S, policy=policy, place=ptt.CPUPlace(),
        scope=ptt.load_numpy_params(params, ptt.Scope(), ptt.CPUPlace()),
        **DIMS)
    jreqs = [jeng.submit(p, 8) for p in _prompts()]
    treqs = [teng.submit(p, 8) for p in _prompts()]
    jeng.run_until_idle()
    kernels.reset_launch_counts()
    teng.run_until_idle()
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert all(len(r.tokens) == 8 for r in treqs)
    assert teng.n_ticks == jeng.n_ticks
    assert teng.stats()["tokens_out"] == 6 * 8
    # a CPU engine runs the plain version: no kernel launch
    assert kernels.LAUNCHES["decode_attention"] == 0


def test_engine_admission_and_slot_reuse():
    teng = ptt.ContinuousBatchingEngine(n_slots=2, place=ptt.CPUPlace(),
                                        **DIMS)
    reqs = [teng.submit([1, 2, 3], 2) for _ in range(3)]
    teng.step()
    assert teng.n_active == 2 and teng.n_pending == 1
    done = teng.run_until_idle()
    assert {r.rid for r in done} == {r.rid for r in reqs}
    assert all(r.done and r.phases()["queue_wait"] >= 0 for r in reqs)
    assert reqs[2].slot in (0, 1)          # the third request reused a slot
    with pytest.raises(InvalidArgumentError):
        teng.submit([1] * 30, 5)           # beyond the slot's KV row


def test_requests_carry_the_jax_wall_clock_stamps():
    """Each request keeps the JAX package's wall-clock fields beside the
    perf_counter ones, stamped at the same boundaries in order."""
    teng = ptt.ContinuousBatchingEngine(n_slots=2, place=ptt.CPUPlace(),
                                        **DIMS)
    reqs = [teng.submit([1, 2, 3], 2) for _ in range(3)]
    teng.run_until_idle()
    for r in reqs:
        assert (r.submitted_at <= r.admitted_at <= r.first_token_at
                <= r.done_at), r.rid
        assert r.sent_at is None          # no server: nothing was sent
    teng.report_sent(reqs[0], reqs[0].done_pc)
    assert reqs[0].sent_at >= reqs[0].done_at


def test_default_place_is_the_card_and_never_the_cpu():
    """Without a card the default place raises instead of dropping to the
    CPU; with one it is CUDAPlace(0)."""
    if torch.cuda.is_available():
        assert ptt.default_place() == ptt.CUDAPlace(0)
        return
    with pytest.raises(UnavailableError):
        ptt.Executor()
    with pytest.raises(UnavailableError):
        ptt.load_numpy_params({"w": np.zeros(2, "float32")})
