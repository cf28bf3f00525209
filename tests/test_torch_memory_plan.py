"""The static memory planner (`framework/memory_plan.py`) and its
execution in the port, against the JAX package.

- With the port's hardware constants set to the JAX package's (TPU v5e)
  values, no host cost a lowering and the JAX package's budget rule,
  `memory_plan_pass` gives each zoo program's JAX plan exactly:
  `to_json` of the planned program (op order, `buffer_slot`,
  `remat_segments`, `live_out`) and `plan_report` are equal. With the
  H100 defaults the plan is the port's own: recorded, never a larger
  predicted peak than the unplanned program's, and its recompute priced
  at the eager step's host cost and held to the budget.
- The planned LM trains as the unplanned one: fetches and updated state
  after 2 Adam steps equal at float32 1e-6 (the same ops in another
  order and under checkpointed segments), and both equal a run that
  keeps every intermediate. Every plan, planned or not, drops each
  transient at its last use (`_release_schedule`).
- A fetched parameter, a fetched intermediate and `run_steps`' stacked
  fetches survive the release.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.framework import costs as jcosts
from paddle_tpu.framework import memory_plan as jmp
from paddle_tpu.framework.passes import get_pass as jget_pass

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import costs as tcosts
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import memory_plan as tmp
from paddle_tpu_torch.framework.passes import get_pass as tget_pass

from test_torch_analysis import build, build_pair  # noqa: F401
from test_torch_analysis import fresh_port_state  # noqa: F401

from tests.port_env import port_jax_compile_cache  # noqa: F401

#: the port's constant -> the JAX package's
JAX_CONSTANTS = {"H100_PEAK_FLOPS": "V5E_PEAK_TFLOPS",
                 "H100_HBM_BPS": "V5E_HBM_BPS",
                 "H100_HBM_BYTES": "V5E_HBM_BYTES",
                 "H100_NVLINK_BPS": "V5E_ICI_BPS",
                 "H100_PCIE_BPS": "V5E_PCIE_BPS"}


@pytest.fixture
def jax_constants(monkeypatch):
    """The JAX package's constants and pricing: no host cost a lowering
    (XLA runs one compiled step), and the prevent_cse=False recompute
    advisory (XLA's CSE may fold it back)."""
    for port, jax_name in JAX_CONSTANTS.items():
        monkeypatch.setattr(tcosts, port, getattr(jcosts, jax_name))
    monkeypatch.setattr(tcosts, "H100_HOST_OP_S", 0.0)
    monkeypatch.setattr(tmp, "RECOMPUTE_ALWAYS_RUNS", False)


@pytest.mark.parametrize("name", ["lm", "nmt", "resnet8", "deepfm", "crf"])
def test_plan_equals_jax_under_jax_constants(name, jax_constants):
    j, t = build_pair(name)
    jp = jget_pass("memory_plan_pass")(j)
    tp = tget_pass("memory_plan_pass")(t)
    assert tp.to_json() == jp.to_json()
    assert tmp.plan_report(tp) == jmp.plan_report(jp)
    if name == "lm":
        region = next(op for op in tp.global_block().ops
                      if op.type == "vjp_region")
        assert region.attrs.get("remat_segments")


def test_h100_plan_is_recorded():
    t = build(ptt, "lm")[0]
    tp = tget_pass("memory_plan_pass")(t)
    rep = tmp.plan_report(tp)
    assert rep["predicted_peak_after"] <= rep["predicted_peak_before"]
    assert rep["remat"]["time_budget_s"] > 0
    assert tmp.plan_report(tget_pass("memory_plan_pass")(tp)) == rep
    with pytest.raises(Exception, match="no memory plan"):
        tmp.plan_report(t)


def test_h100_recompute_is_held_to_the_budget():
    """Recompute re-runs eager lowerings at no less than H100_HOST_OP_S
    each: at the default 2% of the step no segmentation of the LM's
    forward fits, so the plan keeps the stash; every candidate is held,
    prevent_cse or not. A caller's larger budget admits the segments."""
    t = build(ptt, "lm")[0]
    remat = tmp.plan_report(tget_pass("memory_plan_pass")(t))["remat"]
    assert remat["chosen"] == "stash"
    assert remat["candidates"] and not any(
        c["fits_budget"] for c in remat["candidates"])
    n_fwd = len(next(op for op in t.global_block().ops
                     if op.type == "vjp_region").attrs["fwd_ops"])
    assert remat["time_budget_s"] < n_fwd * tcosts.H100_HOST_OP_S
    for c in remat["candidates"]:
        assert c["extra_seconds_bound"] >= tcosts.H100_HOST_OP_S
    wide = tmp.plan_report(tget_pass("memory_plan_pass",
                                     time_budget_s=10.0)(t))["remat"]
    assert wide["chosen"] == "remat" and wide["segments"] >= 2


# -- execution ---------------------------------------------------------------

def _lm_feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, 64, (4, 9))
        out.append({"tokens": toks[:, :-1].astype("int64"),
                    "tokens@SEQLEN": np.array([8, 5, 8, 3], "int32"),
                    "targets": toks[:, 1:].astype("int64")})
    return out


def _train(planned, fetch_extra=(), steps=2, run_steps=False,
           budget=10.0):
    """2 Adam steps of the small LM from the startup program's seed;
    returns (fetches per step, the scope's state, the executor). The
    plan's `budget` (seconds) admits the remat segments by default."""
    ptt.reset_global_scope()
    main, start = build(ptt, "lm")
    loss = next(op for op in main.global_block().ops
                if op.type == "vjp_region").attrs["loss"]
    if planned:
        main = tget_pass("memory_plan_pass", protected=[loss],
                         time_budget_s=budget)(main)
    exe = ptt.Executor(place=ptt.CPUPlace())
    exe.run(start)
    fetch = [loss, *fetch_extra]
    feeds = _lm_feeds(steps)
    if run_steps:
        outs = exe.run_steps(feeds, fetch_list=fetch, program=main)
    else:
        outs = [exe.run(main, feed=f, fetch_list=fetch) for f in feeds]
    scope = ptt.global_scope()
    state = {n: texecutor.as_numpy(scope.get(n))
             for n in scope.local_var_names()}
    return outs, state, exe


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                               atol=1e-6)


def test_planned_lm_trains_as_the_unplanned_one():
    outs_u, state_u, exe_u = _train(False)
    outs_p, state_p, exe = _train(True)
    for a, b in zip(outs_p, outs_u):
        for x, y in zip(a, b):
            _close(x, y)
    assert sorted(state_p) == sorted(state_u)
    for n in state_u:
        _close(state_p[n], state_u[n])
    assert any(op.type == "vjp_region" and op.attrs.get("remat_segments")
               for p in exe._cache.values() for op in p.ops)
    # every plan drops its transients, the unplanned main program's too
    for e in (exe_u, exe):
        assert len(e._cache) == 2
        assert all(p.release is not None for p in e._cache.values())
        assert max(sum(len(r) for r in p.release)
                   for p in e._cache.values()) > 20


@pytest.mark.parametrize("planned", [False, True])
def test_release_equals_keeping_every_intermediate(planned, monkeypatch):
    """The reference keeps every intermediate until the step ends."""
    outs, state, _ = _train(planned)
    monkeypatch.setattr(texecutor, "_release_schedule",
                        lambda program, plan_ops, keep: None)
    outs_k, state_k, exe = _train(planned)
    assert all(p.release is None for p in exe._cache.values())
    for a, b in zip(outs, outs_k):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for n in state_k:
        np.testing.assert_array_equal(state[n], state_k[n])


def test_release_schedule_ignores_the_flag():
    tflags.set_flag("memory_plan", False)
    try:
        _, _, exe = _train(False, steps=1)
    finally:
        tflags.set_flag("memory_plan", True)
    assert all(p.release is not None for p in exe._cache.values())


def test_fetches_survive_release_at_last_use():
    """A parameter, an intermediate the plan would drop after its last
    reader, and run_steps' stacked fetches all come back whole."""
    main = build(ptt, "lm")[0]
    block = main.global_block()
    param = block.all_parameters()[0].name
    mid = next(op for op in block.ops if op.type == "layer_norm"
               ).output_names()[0]
    extra = (param, mid)
    for run_steps in (False, True):
        outs_u, _, _ = _train(False, extra, run_steps=run_steps)
        outs_p, _, _ = _train(True, extra, run_steps=run_steps)
        for a, b in zip(outs_p, outs_u):
            for x, y in zip(a, b):
                _close(x, y)
    # the parameter fetched at step 1 keeps its step-1 value
    outs_p, state_p, _ = _train(True, extra)
    assert not np.array_equal(outs_p[0][1], state_p[param])


# -- the plan on the program as ParallelExecutor rewrites it ------------------

def _lm_mean(pkg, tp):
    """The zoo LM with the mean loss the manual modes need, tp-annotated
    when `tp`."""
    loss, _ = pkg.models.transformer.transformer_lm(
        vocab=64, max_len=8, d_model=32, d_inner=64, num_heads=4,
        num_layers=2, mean_loss=True)
    if tp:
        assert pkg.parallel.annotate_tp()
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)


#: case -> (mesh axes, BuildStrategy fields, tp-annotated)
REWRITTEN = {
    "allreduce_dp4": ({"dp": 4}, {}, False),
    "reduce_dp4": ({"dp": 4}, {"reduce_strategy": "Reduce"}, False),
    "rs_int8_dp4": ({"dp": 4}, {"reduce_strategy": "ReduceScatter",
                                "quant_comm": "int8",
                                "comm_error_feedback": True}, False),
    "tp2_dp2": ({"dp": 2, "tp": 2}, {}, True),
    "pp2": ({"pp": 2}, {"pipeline_stages": 2, "num_microbatches": 2},
            False),
}


@pytest.mark.parametrize("case", sorted(REWRITTEN))
def test_plan_of_the_rewritten_program_equals_jax(case, jax_constants):
    """ParallelExecutor(memory_plan=True) plans the program after the tp,
    dp-comm and pipeline rewrites: its planned JSON and report equal the
    JAX ParallelExecutor's `_apply_memory_plan` on the same rewritten
    program."""
    import jax

    from paddle_tpu.framework.program import Program as JProgram
    from paddle_tpu.parallel import BuildStrategy as JBS
    from paddle_tpu.parallel import ParallelExecutor as JPE
    from paddle_tpu.parallel import ReduceStrategy as JRS
    from paddle_tpu.parallel.mesh import DeviceMesh as JMesh
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy)
    axes, fields, tp = REWRITTEN[case]
    n = int(np.prod(list(axes.values())))
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        _lm_mean(ptt, tp)

    def strategy(bs_cls, rs_cls):
        kw = dict(fields)
        if "reduce_strategy" in kw:
            kw["reduce_strategy"] = getattr(rs_cls, kw["reduce_strategy"])
        return bs_cls(memory_plan=True, **kw)

    tpe = ParallelExecutor(use_cuda=False, main_program=main,
                           mesh=DeviceMesh(ranks=range(n), axes=axes),
                           build_strategy=strategy(BuildStrategy,
                                                   ReduceStrategy))
    rewritten = tpe._prepare_parallel(main, tpe.scope)
    planned = tpe.prepare_program(main)
    assert getattr(planned, "_memory_plan_applied", False)
    assert planned is not rewritten and tpe.prepare_program(main) is planned
    jpe = JPE(mesh=JMesh(jax.devices()[:n], axes),
              build_strategy=strategy(JBS, JRS))
    jprog = JProgram.from_json(rewritten.to_json())
    jplanned = jpe._apply_memory_plan(jprog)
    assert planned.to_json() == jplanned.to_json()
    assert tmp.plan_report(planned) == jmp.plan_report(jplanned)
