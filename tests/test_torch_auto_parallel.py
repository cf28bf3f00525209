"""The port's auto-parallel planner and the parallel half of its cost
model, against the JAX package, with no world.

- Each named rejection code of `costs.strategy_is_feasible` equals the
  JAX package's (code and message), one case per branch, as
  tests/test_auto_parallel.py:77-217.
- `costs.predict` reports equal the JAX package's for tp-, dp-comm- and
  pipeline-rewritten programs, with the port's constants set to the JAX
  package's.
- `auto_parallel.plan` is deterministic for a seed and, under the JAX
  package's constants, chooses the JAX package's point (and ranking) for
  the MLP and the tp-annotated LM on 1, 4 and 8 devices; the HBM-budget
  rejection and the pinned mesh behave as in the JAX package.
- The three HLO-text functions (`hlo_shape_bytes`, `collective_census`,
  `hlo_liveness_temp_bytes`) agree with the JAX package's on HLO that the
  JAX package compiles here.
"""

import numpy as np
import pytest

import jax
import paddle_tpu as pt
from paddle_tpu.framework import auto_parallel as jauto
from paddle_tpu.framework import costs as jcosts
from paddle_tpu.parallel import strategy as jstrategy

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import auto_parallel as tauto
from paddle_tpu_torch.framework import costs as tcosts
from paddle_tpu_torch.framework import memory_plan as tmp
from paddle_tpu_torch.parallel import strategy as tstrategy

JAX_CONSTANTS = {"H100_PEAK_FLOPS": "V5E_PEAK_TFLOPS",
                 "H100_HBM_BPS": "V5E_HBM_BPS",
                 "H100_HBM_BYTES": "V5E_HBM_BYTES",
                 "H100_NVLINK_BPS": "V5E_ICI_BPS",
                 "H100_PCIE_BPS": "V5E_PCIE_BPS"}


@pytest.fixture(autouse=True)
def _fresh_port():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


@pytest.fixture
def jax_constants(monkeypatch):
    for port, jax_name in JAX_CONSTANTS.items():
        monkeypatch.setattr(tcosts, port, getattr(jcosts, jax_name))
    monkeypatch.setattr(tcosts, "H100_HOST_OP_S", 0.0)
    monkeypatch.setattr(tmp, "RECOMPUTE_ALWAYS_RUNS", False)


def _mod(pkg):
    return jstrategy if pkg is pt else tstrategy


def _guard(pkg):
    return (pkg.unique_name.guard() if pkg is ptt
            else pkg.core.unique_name.guard())


def _both(make):
    """make(pkg) -> program built in each package, JSON equal."""
    out = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), _guard(pkg):
            make(pkg)
        out.append(main)
    assert out[1].to_json() == out[0].to_json()
    return out


def _mlp(pkg, in_dim=64):
    L = pkg.layers
    x = L.data("x", shape=[in_dim])
    label = L.data("label", shape=[1], dtype="int64")
    h = L.fc(x, size=128, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))
    pkg.optimizer.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)


def _lm(pkg, annotate=False):
    loss, _ = pkg.models.transformer.transformer_lm(
        vocab=128, max_len=32, d_model=64, d_inner=128, num_heads=4,
        num_layers=2, dropout=0.0, mean_loss=True)
    if annotate:
        assert pkg.parallel.annotate_tp()
    pkg.optimizer.AdamOptimizer(1e-3).minimize(loss)


def _bn(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    loss = L.mean(L.batch_norm(L.fc(x, size=8)))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)


def _sum_loss(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    pkg.optimizer.SGD(learning_rate=0.1).minimize(
        L.reduce_sum(L.fc(x, size=4)))


def _two_losses(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    l1 = L.mean(L.fc(x, size=4))
    l2 = L.mean(L.fc(x, size=4))
    pkg.optimizer.SGD(learning_rate=0.1).minimize(l1)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(l2)


def _one_fc(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    pkg.optimizer.SGD(learning_rate=0.1).minimize(L.mean(L.fc(x, size=4)))


def _branches(pkg):
    L = pkg.layers
    x = L.data("x", shape=[16])
    branches = [L.fc(x, size=4, act="relu") for _ in range(20)]
    acc = branches[0]
    for b in branches[1:]:
        acc = L.elementwise_add(acc, b)
    pkg.optimizer.SGD(learning_rate=0.1).minimize(L.mean(acc))


def _tp_indivisible(pkg):
    L = pkg.layers
    x = L.data("x", shape=[6])
    h = L.fc(x, size=6, act="relu")
    pkg.optimizer.SGD(learning_rate=0.1).minimize(L.mean(L.fc(h, size=3)))
    prog = pkg.default_main_program()
    for b in prog.blocks:
        for v in b.vars.values():
            if getattr(v, "trainable", False) and tuple(v.shape) == (6, 6):
                v.sharding_spec = (None, "tp")


def _dp_sharded_param(pkg):
    _mlp(pkg)
    for v in pkg.default_main_program().global_block().vars.values():
        if getattr(v, "trainable", False) and v.shape and \
                len(v.shape) == 2:
            v.sharding_spec = ("dp", None)
            break


def _rs(mod, **kw):
    return mod.BuildStrategy(
        reduce_strategy=mod.ReduceStrategy.ReduceScatter, **kw)


def _pp(mod, k=2, m=4):
    return mod.BuildStrategy(pipeline_stages=k, num_microbatches=m)


# case -> (program, strategy(mod), mesh axes, nominal batch, deep)
FEASIBILITY = {
    "feasible_deep": (_mlp, _rs, {"dp": 4}, 16, True),
    "feasible_shallow": (_mlp, _rs, {"dp": 4}, 16, False),
    "feasible_pipeline": (_mlp, lambda m: _pp(m), {"dp": 2, "pp": 2}, 16,
                          True),
    "quant_invalid": (_mlp, lambda m: m.BuildStrategy(quant_comm="fp4"),
                      {"dp": 2}, 8, True),
    "gradient_scale": (_mlp, lambda m: m.BuildStrategy(
        gradient_scale_strategy=m.GradientScaleStrategy.CoeffNumDevice),
        {"dp": 2}, 8, True),
    "mesh_mismatch_pp": (_mlp, lambda m: _pp(m), {"dp": 4}, 16, True),
    "mesh_mismatch_extra_pp": (_mlp, lambda m: m.BuildStrategy(),
                               {"dp": 2, "pp": 2}, 8, True),
    "mesh_mismatch_schedule": (_mlp, lambda m: m.BuildStrategy(
        pipeline_stages=2, num_microbatches=4, pipeline_schedule="zz"),
        {"pp": 2}, 16, True),
    "mesh_mismatch_no_dp": (_mlp, _rs, {"pp": 1, "tp": 1}, 8, True),
    "batch_indivisible_explicit": (_mlp, _rs, {"dp": 4}, 6, True),
    "batch_indivisible_pipeline": (_mlp, lambda m: _pp(m),
                                   {"dp": 2, "pp": 2}, 12, True),
    "batch_norm": (_bn, _rs, {"dp": 2}, 8, True),
    "non_mean_loss": (_sum_loss, _rs, {"dp": 2}, 8, True),
    "sp_manual_conflict": (_mlp, lambda m: _rs(
        m, enable_sequence_parallel=True), {"dp": 2}, 8, True),
    "multi_region": (_two_losses, lambda m: _pp(m), {"dp": 1, "pp": 2},
                     16, True),
    "pp_too_few_ops": (_one_fc, lambda m: _pp(m, k=4),
                       {"dp": 1, "pp": 4}, 16, True),
    "narrow_cut": (_branches, lambda m: _pp(m), {"dp": 1, "pp": 2}, 16,
                   True),
    "tp_unannotated": (_mlp, _rs, {"dp": 2, "tp": 2}, 8, True),
    "tp_indivisible": (_tp_indivisible, _rs, {"dp": 1, "tp": 4}, 8, True),
    "tp_feasible": (lambda pkg: _lm(pkg, annotate=True), _rs,
                    {"dp": 2, "tp": 2}, 8, True),
    "non_tp_sharded_param": (_dp_sharded_param, _rs, {"dp": 2}, 8, True),
}


@pytest.mark.parametrize("case", sorted(FEASIBILITY))
def test_feasibility_codes_equal_jax(case, jax_constants):
    make, strat, axes, batch, deep = FEASIBILITY[case]
    jprog, tprog = _both(make)
    jf = jcosts.strategy_is_feasible(jprog, strat(jstrategy),
                                     mesh_axes=axes, nominal_batch=batch,
                                     deep=deep)
    tf = tcosts.strategy_is_feasible(tprog, strat(tstrategy),
                                     mesh_axes=axes, nominal_batch=batch,
                                     deep=deep)
    assert tf.ok == jf.ok
    assert tf.reason_codes() == jf.reason_codes()
    assert [r["message"] for r in tf.reasons] == \
        [r["message"] for r in jf.reasons]
    assert (tf.program is None) == (jf.program is None)
    if tf.program is not None:
        assert tf.program.to_json() == jf.program.to_json()
        for marker in ("_tp_applied", "_dp_comm_applied", "_pp_applied"):
            assert bool(getattr(tf.program, marker, False)) == \
                bool(getattr(jf.program, marker, False))


# program, strategy, mesh axes: the rewritten programs predict prices
PREDICT = {
    "rs_dp4": (_mlp, _rs, {"dp": 4}),
    "rs_int8_dp4": (_mlp, lambda m: _rs(m, quant_comm="int8",
                                        comm_error_feedback=True),
                    {"dp": 4}),
    "pp2_dp2": (_mlp, lambda m: _pp(m), {"dp": 2, "pp": 2}),
    "pp2_rs_dp2": (_mlp, lambda m: _rs(m, pipeline_stages=2,
                                       num_microbatches=4),
                   {"dp": 2, "pp": 2}),
    "tp2_rs_dp2": (lambda pkg: _lm(pkg, annotate=True), _rs,
                   {"dp": 2, "tp": 2}),
    "tp2_pp2": (lambda pkg: _lm(pkg, annotate=True),
                lambda m: _rs(m, pipeline_stages=2, num_microbatches=2),
                {"dp": 1, "pp": 2, "tp": 2}),
    "lm_dp4": (_lm, lambda m: m.BuildStrategy(), {"dp": 4}),
    "lm_zero1_dp4": (_lm, lambda m: m.BuildStrategy(
        reduce_strategy=m.ReduceStrategy.Reduce), {"dp": 4}),
}


def _prediction(costs, prog, strategy, axes):
    f = costs.strategy_is_feasible(prog, strategy, mesh_axes=axes,
                                   nominal_batch=16)
    assert f.ok, f.reasons
    rep = costs.predict(f.program, strategy, dp=axes.get("dp", 1),
                        tp=axes.get("tp", 1), nominal_batch=16)
    return (rep, costs.predicted_step_seconds(rep, mesh_axes=axes,
                                              strategy=strategy),
            costs.predicted_wire_bytes(rep),
            costs.predicted_device_bytes(rep))


@pytest.mark.parametrize("case", sorted(PREDICT))
def test_predict_equals_jax_on_rewritten_programs(case, jax_constants):
    make, strat, axes = PREDICT[case]
    jprog, tprog = _both(make)
    jrep, jsec, jwire, jdev = _prediction(jcosts, jprog, strat(jstrategy),
                                          axes)
    trep, tsec, twire, tdev = _prediction(tcosts, tprog, strat(tstrategy),
                                          axes)
    for sec in ("compute", "dp_comm", "tp_comm", "pipeline", "offload"):
        assert trep[sec] == jrep[sec], sec
    tdevc, jdevc = (dict(r["memory"]["per_device"]) for r in (trep, jrep))
    # int64 feeds count 8 bytes an element in the port (ROADMAP.md §3,
    # 64-bit types), 4 in the JAX package with x64 off
    tfeeds, jfeeds = tdevc.pop("feeds"), jdevc.pop("feeds")
    assert tdevc == jdevc
    assert tsec == pytest.approx(jsec, rel=1e-12)
    assert twire == jwire
    assert tdev - tfeeds == jdev - jfeeds


PLANS = [("mlp", 1), ("mlp", 4), ("mlp", 8), ("lm_tp", 4), ("lm_tp", 8)]


def _plan_program(name):
    return _both(_mlp if name == "mlp" else
                 (lambda pkg: _lm(pkg, annotate=True)))


@pytest.mark.parametrize("name,n", PLANS)
def test_plan_chooses_the_jax_point(name, n, jax_constants):
    jprog, tprog = _plan_program(name)
    kw = dict(nominal_batch=16, seed=0, anneal_iters=32)
    jr = jauto.plan(jprog, n, **kw)
    tr = tauto.plan(tprog, n, **kw)
    assert tr.point == tauto.StrategyPoint(**jr.point.__dict__)
    assert tr.point.describe() == jr.point.describe()
    assert tr.mesh_axes == jr.mesh_axes
    assert tr.predicted_step_s == pytest.approx(jr.predicted_step_s,
                                                rel=1e-12)
    assert tr.device_bytes - tr.predicted["memory"]["per_device"][
        "feeds"] == jr.device_bytes - jr.predicted["memory"]["per_device"][
        "feeds"]
    assert [r["point"].describe() for r in tr.ranking] == \
        [r["point"].describe() for r in jr.ranking]
    assert tr.rejections == jr.rejections
    assert (tr.n_enumerated, tr.n_feasible, tr.n_annealed) == \
        (jr.n_enumerated, jr.n_feasible, jr.n_annealed)


def test_plan_is_deterministic_for_a_seed():
    _, tprog = _plan_program("mlp")
    a = tauto.plan(tprog, 8, nominal_batch=16, seed=7)
    b = tauto.plan(tprog, 8, nominal_batch=16, seed=7)
    assert a.point == b.point
    assert [r["point"] for r in a.ranking] == [r["point"] for r in b.ranking]
    assert a.summary()["frontier"] == b.summary()["frontier"]
    # the chosen strategy is feasible and adoptable
    f = tcosts.strategy_is_feasible(tprog, a.strategy,
                                    mesh_axes=a.mesh_axes, nominal_batch=16)
    assert f.ok


def test_hbm_budget_rejection_equals_jax(jax_constants):
    jprog, tprog = _plan_program("mlp")
    errs = []
    for auto, prog in ((jauto, jprog), (tauto, tprog)):
        with pytest.raises(Exception) as e:
            auto.plan(prog, 4, nominal_batch=16, hbm_bytes=1024)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] == "InvalidArgumentError" and "hbm-budget" in errs[1][1]


def test_pinned_mesh_searches_only_the_other_knobs(jax_constants):
    jprog, tprog = _plan_program("mlp")
    axes = {"dp": 2, "pp": 2}
    jr = jauto.plan(jprog, axes, nominal_batch=16)
    tr = tauto.plan(tprog, axes, nominal_batch=16)
    assert tr.mesh_axes == jr.mesh_axes == axes
    assert tr.point.describe() == jr.point.describe()


def test_the_default_budget_is_the_cards():
    _, tprog = _plan_program("mlp")
    r = tauto.plan(tprog, 4, nominal_batch=16)
    assert r.device_bytes <= tcosts.H100_HBM_BYTES
    assert tauto.mesh_factorizations(8) == jauto.mesh_factorizations(8)
    assert tauto.numerics_preserving_space(
        tstrategy.BuildStrategy(quant_comm="int8")).quant_modes == ("int8",)
    assert tauto._describe_strategy(tstrategy.BuildStrategy(),
                                    {"dp": 4}) == \
        jauto._describe_strategy(jstrategy.BuildStrategy(), {"dp": 4})


def test_replan_on_restore_waits_for_elasticity():
    """No longer waits: elasticity is ported, and replan_on_restore takes
    the JAX package's arguments (its decision record is held to the JAX
    one in tests/test_torch_elastic_world.py)."""
    import inspect
    assert inspect.signature(tauto.replan_on_restore) == \
        inspect.signature(jauto.replan_on_restore)


def test_auto_parallel_flag_off_keeps_the_users_strategy():
    """With PTPU_AUTO_PARALLEL=0 the executor plans nothing (no world
    needed: a mesh of one rank)."""
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor)
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        _mlp(ptt)
    ptt.Executor(ptt.CPUPlace()).run(start)
    bst = BuildStrategy(auto_parallel=True)
    ptt.flags.set_flag("auto_parallel", False)
    try:
        pe = ParallelExecutor(use_cuda=False, main_program=main,
                              mesh=DeviceMesh(axes={"dp": 1}),
                              build_strategy=bst)
        pe.prepare_program()
        assert pe.auto_plan_report() is None and pe.build_strategy is bst
    finally:
        ptt.flags.set_flag("auto_parallel", True)
    pe.prepare_program()
    rep = pe.auto_plan_report()
    assert rep is not None and rep.mesh_axes == {"dp": 1}
    assert pe.cost_report(nominal_batch=16)["compute"]["flops"] > 0
    feed = {"x": np.random.RandomState(0).rand(8, 64).astype("f4"),
            "label": np.zeros((8, 1), "int64")}
    mem = pe.memory_report(feed, nominal_batch=8)
    assert mem["predicted"]["per_device"]["params"] > 0
    assert mem["measured"]["peak_bytes"] > 0


# ---------------------------------------------------------------------------
# the HLO-text functions, on HLO the JAX package compiles
# ---------------------------------------------------------------------------


def _compiled_hlo():
    """A small sharded jax step over 4 virtual devices: an all-reduce
    (psum), an all-gather and a collective-permute, as text."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("d",))

    def f(x, w):
        y = jax.numpy.tanh(x @ w)
        return y.sum(), jax.numpy.roll(y, 1, axis=0)

    xs = NamedSharding(mesh, P("d", None))
    ws = NamedSharding(mesh, P(None, None))
    x = jax.device_put(np.ones((8, 16), np.float32), xs)
    w = jax.device_put(np.ones((16, 4), np.float32), ws)
    return jax.jit(f, out_shardings=(NamedSharding(mesh, P()), xs)).lower(
        x, w).compile().as_text()


def test_hlo_text_functions_equal_jax():
    hlo = _compiled_hlo()
    assert tcosts.collective_census(hlo) == jcosts.collective_census(hlo)
    assert tcosts.hlo_liveness_temp_bytes(hlo) == \
        jcosts.hlo_liveness_temp_bytes(hlo)
    for sh in ("f32[8,16]", "(bf16[4], s8[2,2]{1,0})", "pred[]", "token[]",
               "(f32[2]{0:T(8,128)}, u4[6])"):
        assert tcosts.hlo_shape_bytes(sh) == jcosts.hlo_shape_bytes(sh)
    for bad in ("q7[3]", "f32[?]"):
        errs = []
        for c in (jcosts, tcosts):
            with pytest.raises(ValueError) as e:
                c.hlo_shape_bytes(bad)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    census = tcosts.collective_census(hlo)
    assert census, "the compiled step holds collectives"
    assert tcosts.census_wire_bytes(census, 4) == \
        jcosts.census_wire_bytes(jcosts.collective_census(hlo), 4)


@pytest.mark.parametrize("name,n", [("mlp", 4), ("lm_tp", 4)])
def test_executor_space_with_memory_plans_chooses_the_jax_point(
        name, n, jax_constants):
    """The space ParallelExecutor adopts from (`numerics_preserving_space`)
    searches memory plans, as the JAX package's does, and chooses its
    point."""
    jprog, tprog = _plan_program(name)
    kw = dict(nominal_batch=16, seed=0, anneal_iters=32)
    tspace = tauto.numerics_preserving_space(tstrategy.BuildStrategy())
    assert tspace.memory_plan == (False, True)
    jr = jauto.plan(jprog, n, space=jauto.numerics_preserving_space(
        jstrategy.BuildStrategy()), **kw)
    tr = tauto.plan(tprog, n, space=tspace, **kw)
    assert tr.point.describe() == jr.point.describe()
    assert tr.mesh_axes == jr.mesh_axes
    assert [r["point"].describe() for r in tr.ranking] == \
        [r["point"].describe() for r in jr.ranking]
