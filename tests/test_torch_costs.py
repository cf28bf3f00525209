"""The cost model (`framework/costs.py`) and the executor's analyses
against the JAX package.

- With the port's constants set to the JAX package's (TPU v5e) values:
  `predict` (dp 1 / 2, tp 0 / 2), `program_flops_bytes`,
  `memory_categories`, `op_cost_flops_bytes` per op, the scalarized
  `predicted_device_bytes` / `predicted_step_seconds` /
  `predicted_wire_bytes` and `speculative_expectation` equal the JAX
  package's numbers on the LM, ResNet-8 and DeepFM, but for one mapped
  difference: the port keeps 64-bit types, so each int64 / float64 var
  counts 4 more bytes an element in the categories the JAX package
  narrows (feeds and state).
- The wire arithmetic (`collective_wire_bytes`, `census_wire_bytes`,
  `reshard_wire_bytes`) is equal.
- With the H100 defaults, `op_time_cost`, `roofline_fields` and `mfu`
  give hand-computed values from 989 TFLOP/s and 3.35 TB/s.
- `strategy_is_feasible` names the JAX package's reasons, and plans a
  single-card program that asks for the memory plan.
- `Executor.cost_analysis` / `memory_analysis` / `memory_census` return
  the JAX package's keys; the census feeds a `LedgerRow`.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.framework import costs as jc
from paddle_tpu.parallel.strategy import BuildStrategy

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework import costs as tc

from test_torch_analysis import build, build_pair  # noqa: F401
from test_torch_analysis import fresh_port_state  # noqa: F401
from test_torch_memory_plan import jax_constants  # noqa: F401

from tests.port_env import port_jax_compile_cache  # noqa: F401

_WIDE = ("torch.int64", "torch.float64")


def _wide_extra(program, dp, nominal_batch):
    """Bytes the port's memory_categories counts beyond the JAX
    package's: 4 an element of each 64-bit var, by category."""
    extra = {"feeds": 0, "params": 0, "optimizer_state": 0,
             "other_state": 0}
    seen = set()
    for b in program.blocks:
        for name, v in b.vars.items():
            if name in seen or str(v.dtype) not in _WIDE:
                continue
            seen.add(name)
            n = 4
            for d in v.shape or ():
                n *= nominal_batch if d == -1 else int(d)
            if v.persistable:
                extra[tc.state_category(v, name)] += n
            elif v.is_data:
                shape = list(v.shape or ())
                extra["feeds"] += n // dp if shape and shape[0] == -1 \
                    and dp > 1 else n
    return extra


@pytest.mark.parametrize("dp,tp", [(1, 0), (2, 0), (1, 2), (2, 2)])
@pytest.mark.parametrize("name", ["lm", "resnet8", "deepfm"])
def test_predict_equals_jax(name, dp, tp, jax_constants):
    j, t = build_pair(name)
    jr = jc.predict(j, dp=dp, tp=tp, nominal_batch=8)
    tr = tc.predict(t, dp=dp, tp=tp, nominal_batch=8)
    jcat = jr["memory"].pop("per_device")
    tcat = tr["memory"].pop("per_device")
    assert tr == jr
    extra = _wide_extra(t, dp, 8)
    assert {k: v - extra.get(k, 0) for k, v in tcat.items()} == jcat
    assert tc.memory_categories(t, dp=dp, tp=tp) == tcat
    assert tc.program_flops_bytes(t) == jc.program_flops_bytes(j)
    for jo, to in zip(j.global_block().ops, t.global_block().ops):
        assert tc.op_cost_flops_bytes(to, t.global_block()) == \
            jc.op_cost_flops_bytes(jo, j.global_block())
    jr["memory"]["per_device"] = jcat
    tr["memory"]["per_device"] = {k: v - extra.get(k, 0)
                                  for k, v in tcat.items()}
    assert tc.predicted_device_bytes(tr) == jc.predicted_device_bytes(jr)
    axes = {"dp": dp, "tp": max(tp, 1)}
    assert tc.predicted_step_seconds(tr, mesh_axes=axes) == \
        jc.predicted_step_seconds(jr, mesh_axes=axes)
    assert tc.predicted_wire_bytes(tr) == jc.predicted_wire_bytes(jr)


def test_speculative_and_wire_arithmetic_equal_jax():
    for kw in ({"gamma": 4, "acceptance": 0.7},
               {"gamma": 2, "acceptance": lambda: 1.0, "draft_layers": 1,
                "num_layers": 6, "draft_bits": 8}):
        assert tc.speculative_expectation(**kw) == \
            jc.speculative_expectation(**kw)
    for kind in ("all-reduce", "reduce-scatter", "all-gather",
                 "all-to-all", "collective-permute"):
        for n in (2, 4, 8):
            assert tc.collective_wire_bytes(kind, 4096, n) == \
                jc.collective_wire_bytes(kind, 4096, n)
    census = {"all-reduce": [(4, "loss"), (1 << 20, "g")],
              "all-gather": [(4096, "p")]}
    for mb in (0, 8):
        assert tc.census_wire_bytes(census, 4, mb) == \
            jc.census_wire_bytes(census, 4, mb)
    for old, new in (((1, 2), (2, 2)), ((4, 1), (2, 2)), ((2, 2), (1, 1))):
        assert tc.reshard_wire_bytes(1 << 16, old, new) == \
            jc.reshard_wire_bytes(1 << 16, old, new)


def test_h100_constants_give_hand_values():
    assert tc.H100_PEAK_FLOPS == 989e12 and tc.H100_HBM_BPS == 3.35e12
    assert tc.op_time_cost(989e9, 0) == pytest.approx(1e-3)
    assert tc.op_time_cost(0, 3.35e9) == pytest.approx(1e-3)
    # an eager op costs its step at least one host lowering
    assert tc.op_step_cost(0, 0) == tc.H100_HOST_OP_S == 129e-6
    assert tc.op_step_cost(989e9, 0) == pytest.approx(1e-3)
    assert tc.mfu(989e12 * 0.25, 1.0) == pytest.approx(0.25)
    f = tc.roofline_fields(0.01, 989e10, 3.35e9)
    assert f["ideal_mxu_ms"] == pytest.approx(10.0)
    assert f["ideal_hbm_ms"] == pytest.approx(1.0)
    assert f["mfu"] == pytest.approx(1.0)
    assert f["intensity_flops_per_byte"] == pytest.approx(2952.2, abs=0.1)


def test_strategy_feasibility_names_the_jax_reasons():
    j, t = build_pair("lm")
    bad = BuildStrategy()
    bad.quant_comm = "int4"
    jf = jc.strategy_is_feasible(j, bad, mesh_axes={"dp": 2}, deep=False)
    tf = tc.strategy_is_feasible(t, bad, mesh_axes={"dp": 2}, deep=False)
    assert not tf.ok and tf.reason_codes() == jf.reason_codes()
    planned = BuildStrategy()
    planned.memory_plan = True
    tf = tc.strategy_is_feasible(t, planned, mesh_axes={"dp": 1})
    assert tf.ok and tf.program._memory_plan_applied
    assert repr(tf).startswith("Feasibility(ok=True")


def _lm_run():
    main, start = build(ptt, "lm")
    loss = next(op for op in main.global_block().ops
                if op.type == "vjp_region").attrs["loss"]
    exe = ptt.Executor(place=ptt.CPUPlace())
    exe.run(start)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, 64, (4, 9))
    feed = {"tokens": toks[:, :-1].astype("int64"),
            "tokens@SEQLEN": np.array([8, 5, 8, 3], "int32"),
            "targets": toks[:, 1:].astype("int64")}
    exe.run(main, feed=feed, fetch_list=[loss])
    return exe, main, feed, loss


def _keys(d):
    return {k: (_keys(v) if isinstance(v, dict) and k != "per_var"
                and k != "per_feed" else None) for k, v in d.items()}


def _jax_analyses():
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        x = pt.layers.data("x", [4])
        loss = pt.layers.mean(pt.layers.fc(x, 3))
        pt.optimizer.SGD(0.1).minimize(loss)
    exe, scope = pt.Executor(), pt.Scope()
    exe.run(start, scope=scope)
    feed = {"x": np.ones((2, 4), "float32")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return (exe.cost_analysis(main, feed, [loss], scope),
            exe.memory_analysis(main, feed, [loss], scope),
            exe.memory_census(feed, main, scope))


def test_executor_analyses_return_the_jax_keys():
    jca, jma, jcen = _jax_analyses()
    exe, main, feed, loss = _lm_run()
    scope = ptt.global_scope()
    before = {n: scope.get(n).clone() for n in scope.local_var_names()}
    ca = exe.cost_analysis(main, feed, [loss])
    assert {k for k in jca if "{" not in k} <= set(ca)
    assert ca["flops"] > 0 and ca["bytes accessed"] > 0
    ma = exe.memory_analysis(main, feed, [loss])
    assert set(ma) == set(jma)
    assert ma["temp_source"] == "lifetime_walk" and ma["temp_bytes"] > 0
    cen = exe.memory_census(feed, main)
    jk, tk = _keys(jcen), _keys(cen)
    assert set(tk) == set(jk)
    for k, v in jk.items():
        if isinstance(v, dict):
            assert set(v) <= set(tk[k]), k
    assert cen["xla"]["argument_bytes"] == round(
        cen["state"]["categories"]["state_total"]
        + cen["feeds"]["per_device_bytes"] + cen["seed_bytes"])
    # measuring left the scope as it was
    for n, v in before.items():
        assert bool((scope.get(n) == v).all()), n
    for f in ("cost_analysis", "memory_analysis", "memory_census"):
        for mod in (ptt, ptt.io, ptt.trainer, ptt.inferencer):
            assert callable(getattr(mod.Executor, f))
    row = ptt.observability.CostLedger("t").row("lm", batch=4)
    row.set_prediction(tc.predict(main, nominal_batch=4))
    row.set_memory_census(cen)
    rec = row.check_memory_identity(0.1)
    assert {c["what"] for c in row.checks} >= {
        "memory_params", "memory_feeds", "memory_args_balance",
        "memory_residual_bound"}
    assert rec["measured_total"] > 0
    assert next(c for c in row.checks
                if c["what"] == "memory_args_balance")["ok"]


def test_allocator_census_copies_the_state_before_its_window(monkeypatch):
    """On a card, `memory_analysis` reads the allocator around one step run
    on copies of the read-write state. The copies stand in for the state
    and are made before the window opens, so a step with no transients (an
    in-place add) reads temp 0. The allocator is stood in for by a ledger
    of the copies' bytes, the executor's device by a CUDA one."""
    import torch
    from paddle_tpu_torch.observability import memory as tmem
    main = ptt.Program()
    with ptt.program_guard(main, ptt.Program()):
        w = main.global_block().create_var(name="w", shape=[1024],
                                           dtype="float32", persistable=True)
        ptt.layers.increment(w, in_place=True)
    scope = ptt.Scope()
    scope.set_var("w", torch.zeros(1024))
    exe = ptt.Executor(place=ptt.CPUPlace())
    exe.device = torch.device("cuda")
    held = {"now": 0, "peak": 0, "events": []}
    real_copies = tmem._state_copies

    def copies(plan, scope):
        out = real_copies(plan, scope)
        held["now"] += sum(t.numel() * t.element_size() for t in out[1])
        held["peak"] = max(held["peak"], held["now"])
        held["events"].append("copy")
        return out

    def reset(*_):
        held["peak"] = held["now"]
        held["events"].append("reset")

    monkeypatch.setattr(tmem, "_state_copies", copies)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *_: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda *_: held["now"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *_: held["peak"])
    ma = exe.memory_analysis(main, {}, [], scope)
    assert held["events"] == ["copy", "reset"]
    assert ma["temp_source"] == "cuda_allocator"
    assert ma["alias_bytes"] == ma["output_bytes"] == 4096
    assert ma["temp_bytes"] == 0
    assert float(scope.get("w")[0]) == 0.0
