"""Pipeline parallelism in the port against the JAX package, with no world.

- The schedule tables and `schedule_census` equal the JAX package's for
  gpipe and 1f1b at M in {1, 2, 3, 4, 8} and K in {1, 2, 3, 4}.
- `pipeline_partition_pass` gives the JAX package's program (`to_json`
  equal) for the MLP of tests/test_pipeline_parallel.py at K 2 and (depth
  6) K 4, its conv net, and a 4-layer LM at K 2 and 4, with the port's
  cost constants set to the JAX package's (the stage balance reads them);
  each refusal raises the JAX package's exception type and message.
- `pp_boundary_wire_bytes`, the memory planner's per-stage decisions and
  `costs.predict`'s pipeline section equal the JAX package's.
- The analyzers find no error in the partitioned programs.
- The one-process engine (`pipeline.run_one_process`: every stage in this
  process, the tables' stashes, recompute and accumulation) trains the
  MLP and the conv net under both schedules, and the small LM in float32,
  to the JAX ParallelExecutor's losses and parameters on 2 and 4 virtual
  devices and to the one-device Executor's, at 1e-5.
- `pipeline_apply` at pp 1 equals the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax
import paddle_tpu as pt
from paddle_tpu.framework import costs as jcosts
from paddle_tpu.framework import memory_plan as jmp
from paddle_tpu.framework.passes import get_pass as jget_pass
from paddle_tpu.parallel import pipeline as jpipe

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import analysis as tanalysis
from paddle_tpu_torch.framework import costs as tcosts
from paddle_tpu_torch.framework import dataflow as tdataflow
from paddle_tpu_torch.framework import memory_plan as tmp
from paddle_tpu_torch.framework.passes import get_pass as tget_pass
from paddle_tpu_torch.parallel import pipeline as tpipe

from tests.port_env import port_jax_compile_cache  # noqa: F401

#: the port's constant -> the JAX package's
JAX_CONSTANTS = {"H100_PEAK_FLOPS": "V5E_PEAK_TFLOPS",
                 "H100_HBM_BPS": "V5E_HBM_BPS",
                 "H100_HBM_BYTES": "V5E_HBM_BYTES",
                 "H100_NVLINK_BPS": "V5E_ICI_BPS",
                 "H100_PCIE_BPS": "V5E_PCIE_BPS"}
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _fresh_port():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


@pytest.fixture
def jax_constants(monkeypatch):
    """The JAX package's constants and pricing: no host cost a lowering,
    and the planner's advisory recompute rule."""
    for port, jax_name in JAX_CONSTANTS.items():
        monkeypatch.setattr(tcosts, port, getattr(jcosts, jax_name))
    monkeypatch.setattr(tcosts, "H100_HOST_OP_S", 0.0)
    monkeypatch.setattr(tmp, "RECOMPUTE_ALWAYS_RUNS", False)


@pytest.fixture
def f32_matmuls():
    olds = [pkg.flags.get_flag("use_bf16_matmul") for pkg in (pt.core, ptt)]
    pt.core.flags.set_flag("use_bf16_matmul", False)
    ptt.flags.set_flag("use_bf16_matmul", False)
    yield
    pt.core.flags.set_flag("use_bf16_matmul", olds[0])
    ptt.flags.set_flag("use_bf16_matmul", olds[1])


# ---------------------------------------------------------------------------
# programs, built the same way in both packages
# ---------------------------------------------------------------------------

LM = dict(vocab=64, max_len=8, d_model=32, d_inner=64, num_heads=4)


def mlp(pkg, depth=4):
    L = pkg.layers
    x = L.data("x", shape=[32])
    label = L.data("label", shape=[1], dtype="int64")
    h = x
    for _ in range(depth):
        h = L.fc(h, size=64, act="relu")
    logits = L.fc(h, size=10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)
    return loss


def conv(pkg):
    L = pkg.layers
    img = L.data("img", shape=[8, 8, 3])
    label = L.data("label", shape=[1], dtype="int64")
    h = L.conv2d(img, 8, 3, padding=1, act="relu", data_format="NHWC")
    h = L.pool2d(h, 2, "max", 2, data_format="NHWC")
    h = L.conv2d(h, 16, 3, padding=1, act="relu", data_format="NHWC")
    h = L.pool2d(h, 2, "max", 2, data_format="NHWC")
    h = L.fc(h, size=32, act="relu", num_flatten_dims=1)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return loss


def lm(pkg, layers=4):
    loss, _ = pkg.models.transformer.transformer_lm(
        num_layers=layers, mean_loss=True, **LM)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


MODELS = {"mlp": mlp, "mlp6": lambda pkg: mlp(pkg, depth=6), "conv": conv,
          "lm": lm, "lm2": lambda pkg: lm(pkg, layers=2)}


def _guard(pkg):
    return (pkg.unique_name.guard() if pkg is ptt
            else pkg.core.unique_name.guard())


def build(pkg, name):
    """(main, startup, loss name) of model `name` built in `pkg`."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), _guard(pkg):
        loss = MODELS[name](pkg)
    return main, start, loss.name


def feeds(name, n=3, bs=16):
    rng = np.random.RandomState({"mlp": 1, "mlp6": 2, "conv": 3,
                                 "lm": 4, "lm2": 5}[name])
    out = []
    for _ in range(n):
        if name.startswith("mlp"):
            f = {"x": rng.rand(bs, 32).astype("f4")}
        elif name == "conv":
            f = {"img": rng.rand(bs, 8, 8, 3).astype("f4")}
        else:
            f = {"tokens": rng.randint(0, LM["vocab"], (bs, LM["max_len"]))
                 .astype("int64"),
                 "tokens@SEQLEN": np.full((bs,), LM["max_len"], "int32"),
                 "targets": rng.randint(0, LM["vocab"],
                                        (bs, LM["max_len"])).astype("int64")}
        if not name.startswith("lm"):
            f["label"] = rng.randint(0, 10, (bs, 1)).astype("int64")
        out.append(f)
    return out


def partition(pkg, prog, k, m=4, schedule="1f1b", **kw):
    get = tget_pass if pkg is ptt else jget_pass
    return get("pipeline_partition_pass", num_stages=k, num_microbatches=m,
               schedule=schedule, dp_axis="", reduce_dp=False, **kw)(prog)


# ---------------------------------------------------------------------------
# the schedule tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gpipe", "1f1b"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_schedule_tables_and_census_equal_jax(name, k, m):
    js, ts = jpipe.build_schedule(name, m, k), tpipe.build_schedule(name, m, k)
    for attr in ("fwd_mb", "bwd_mb", "arr_act", "arr_grad"):
        np.testing.assert_array_equal(getattr(ts, attr), getattr(js, attr))
    assert (ts.ticks, ts.act_stash_depth, ts.grad_stash_depth) == \
        (js.ticks, js.act_stash_depth, js.grad_stash_depth)
    assert tpipe.schedule_census(name, m, k) == \
        jpipe.schedule_census(name, m, k)


def test_schedule_refusals_equal_jax():
    for args in (("zigzag", 4, 2), ("1f1b", 0, 2), ("gpipe", 2, 0)):
        with pytest.raises(Exception) as je:
            jpipe.build_schedule(*args)
        with pytest.raises(Exception) as te:
            tpipe.build_schedule(*args)
        assert (type(te.value).__name__, str(te.value)) == \
            (type(je.value).__name__, str(je.value))


def test_pipeline_config_equals_jax():
    from paddle_tpu.parallel.strategy import BuildStrategy as JB
    from paddle_tpu_torch.parallel.strategy import BuildStrategy as TB
    for kw in ({}, {"pipeline_stages": 1}, {"pipeline_stages": 2},
               {"pipeline_stages": 4, "num_microbatches": 8,
                "pipeline_schedule": "gpipe"}):
        assert tpipe.pipeline_config(TB(**kw)) == \
            jpipe.pipeline_config(JB(**kw))
    ptt.flags.set_flag("pipeline", False)
    try:
        assert tpipe.pipeline_config(TB(pipeline_stages=2)) is None
    finally:
        ptt.flags.set_flag("pipeline", True)


# ---------------------------------------------------------------------------
# the partition pass
# ---------------------------------------------------------------------------

CASES = [("mlp", 2), ("mlp6", 4), ("conv", 2), ("lm", 2), ("lm", 4)]


@pytest.mark.parametrize("name,k", CASES)
def test_partition_equals_jax(name, k, jax_constants):
    j, t = build(pt, name)[0], build(ptt, name)[0]
    assert t.to_json() == j.to_json()
    jp, tp = partition(pt, j, k), partition(ptt, t, k)
    assert tp.to_json() == jp.to_json()
    for marker in ("_pp_applied", "_pp_hidden", "_pp_microbatches",
                   "_pp_stages"):
        assert getattr(tp, marker) == getattr(jp, marker)
    # the caller's program is untouched
    assert any(op.type == "vjp_region" for op in t.global_block().ops)


@pytest.mark.parametrize("name,k", CASES)
def test_boundary_bytes_stage_decisions_and_predict_equal_jax(
        name, k, jax_constants):
    j, t = build(pt, name)[0], build(ptt, name)[0]
    jp, tp = partition(pt, j, k), partition(ptt, t, k)
    for rows in (1, 4):
        assert tpipe.pp_boundary_wire_bytes(tp, rows) == \
            jpipe.pp_boundary_wire_bytes(jp, rows)
    jr = next(op for op in jp.global_block().ops
              if op.type == "pp_pipeline_region")
    tr = next(op for op in tp.global_block().ops
              if op.type == "pp_pipeline_region")
    assert tmp._pp_stage_decisions(tp, tr, nominal_batch=16) == \
        jmp._pp_stage_decisions(jp, jr, nominal_batch=16)
    tpred = tcosts.predict(tp, nominal_batch=16)
    jpred = jcosts.predict(jp, nominal_batch=16)
    assert tpred["pipeline"] == jpred["pipeline"]
    assert tcosts.predicted_wire_bytes(tpred) == \
        jcosts.predicted_wire_bytes(jpred)
    assert tpred["memory"]["per_device"]["pp_working_set"] == \
        jpred["memory"]["per_device"]["pp_working_set"]


def test_memory_plan_of_a_partitioned_program_equals_jax(jax_constants):
    j, t = build(pt, "lm")[0], build(ptt, "lm")[0]
    jp = jget_pass("memory_plan_pass", nominal_batch=16)(partition(pt, j, 2))
    tp = tget_pass("memory_plan_pass", nominal_batch=16)(partition(ptt, t, 2))
    assert tmp.plan_report(tp)["pp_stages"] == \
        jmp.plan_report(jp)["pp_stages"]
    assert tp.to_json() == jp.to_json()


def test_partition_on_the_card_constants_is_recorded():
    """With the H100's constants the stage balance is the port's own:
    contiguous non-empty stages, one send/recv pair per cut."""
    t, _, _ = build(ptt, "lm")
    tp = partition(ptt, t, 4)
    region = next(op for op in tp.global_block().ops
                  if op.type == "pp_pipeline_region")
    assert len(region.attrs["stages"]) == 4
    assert all(region.attrs["stages"])
    ops = tp.global_block().ops
    assert sum(op.type == "pp_send" for op in ops) == 3
    assert sum(op.type == "pp_recv" for op in ops) == 3


def _raise_both(make):
    """The exception each package raises for `make(pkg)`."""
    out = []
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        with _guard(pkg):
            with pytest.raises(Exception) as e:
                make(pkg)
        out.append((type(e.value).__name__, str(e.value)))
    return out


def _bn_net(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4, 4, 3])
    label = L.data("label", shape=[1], dtype="int64")
    h = L.conv2d(x, 4, 3, padding=1, data_format="NHWC")
    h = L.batch_norm(h, data_layout="NHWC")
    h = L.fc(h, size=16, act="relu", num_flatten_dims=1)
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return partition(pkg, pkg.default_main_program(), 2)


def _sum_loss(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    h = L.fc(L.fc(x, size=8, act="relu"), size=1)
    loss = L.reduce_sum(h)
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return partition(pkg, pkg.default_main_program(), 2)


def _two_regions(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    h = L.fc(x, size=8, act="relu")
    l1 = L.mean(L.fc(h, size=1))
    l2 = L.mean(L.fc(h, size=1))
    pkg.optimizer.SGDOptimizer(0.1).minimize(l1)
    pkg.optimizer.SGDOptimizer(0.1).minimize(l2)
    return partition(pkg, pkg.default_main_program(), 2)


def _too_few_ops(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    loss = L.mean(L.fc(x, size=4))
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return partition(pkg, pkg.default_main_program(), 16)


def _wide_cut(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    hs = [L.fc(x, size=8) for _ in range(4)]
    s = hs[0]
    for h in hs[1:]:
        s = s + h
    loss = L.mean(L.fc(s, size=1))
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return partition(pkg, pkg.default_main_program(), 2,
                     max_boundary_vars=1)


def _int_cut(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    h = L.fc(x, size=8, act="relu")
    idx = L.argmax(h, axis=1)
    h2 = L.fc(h, size=8, act="relu")
    h3 = L.fc(h2, size=8, act="relu")
    h4 = L.fc(h3, size=8)
    oh = L.cast(L.one_hot(L.reshape(idx, [-1, 1]), depth=8), "float32")
    loss = L.mean(h4 * oh)
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    return partition(pkg, pkg.default_main_program(), 2)


def _optimizer_reads_activation(pkg):
    L = pkg.layers
    x = L.data("x", shape=[8])
    h = L.fc(x, size=8, act="relu")
    h2 = L.fc(h, size=8)
    loss = L.mean(h2)
    pkg.optimizer.SGDOptimizer(0.1).minimize(loss)
    prog = pkg.default_main_program()
    blk = prog.global_block()
    # a load-bearing (optimize-role) reader of a forward activation
    out = blk.create_var(name="act_scaled", shape=[-1, 8],
                         dtype="float32")
    blk.append_op(type="scale", inputs={"X": [h.name]},
                  outputs={"Out": [out.name]},
                  attrs={"scale": 2.0, "op_role": "optimize"})
    return partition(pkg, prog, 2)


REFUSALS = {"batch_norm": _bn_net, "sum_loss": _sum_loss,
            "two_regions": _two_regions, "too_few_ops": _too_few_ops,
            "wide_cut": _wide_cut, "int_cut": _int_cut,
            "load_bearing_reader": _optimizer_reads_activation}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_partition_refusals_equal_jax(case):
    (jt, jm), (tt, tm) = _raise_both(REFUSALS[case])
    assert tt == jt == "InvalidArgumentError"
    assert tm == jm


def test_partition_refuses_one_stage_as_jax():
    def make(pkg):
        return partition(pkg, build(pkg, "mlp")[0], 1)
    (jt, jm), (tt, tm) = _raise_both(make)
    assert (tt, tm) == (jt, jm)


@pytest.mark.parametrize("name,k", CASES)
def test_analyzers_are_clean_on_the_partitioned_program(name, k):
    t, _, _ = build(ptt, name)
    tp = partition(ptt, t, k)
    errors = [d for d in tanalysis.verify_program(tp)
              if d.severity == "error"]
    assert errors == []
    assert [d for d in tdataflow.dataflow_checks(tp)
            if d.severity == "error"] == []


def test_metric_head_is_pruned_and_its_fetch_refused():
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        L = ptt.layers
        x = L.data("x", shape=[32])
        label = L.data("label", shape=[1], dtype="int64")
        h = L.fc(L.fc(x, size=64, act="relu"), size=64, act="relu")
        logits = L.fc(h, size=10)
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        ptt.optimizer.SGDOptimizer(0.1).minimize(loss)
        acc = L.accuracy(input=L.softmax(logits), label=label)
    tp = partition(ptt, main, 2)
    assert acc.name in tp._pp_hidden
    assert not any(acc.name in op.output_names()
                   for op in tp.global_block().ops)


# ---------------------------------------------------------------------------
# the one-process engine against the JAX package
# ---------------------------------------------------------------------------


def _jax_init(name):
    """The JAX startup program's parameters, and the JAX one-device
    Executor's losses and parameters over `feeds(name)`."""
    pt.reset_default_programs()
    pt.reset_global_scope()
    main, start, loss = build(pt, name)
    exe = pt.Executor()
    exe.run(start)
    scope = pt.global_scope()
    names = [v.name for v in main.global_block().vars.values()
             if v.persistable and scope.has_var(v.name)]
    init = {n: np.asarray(scope.get(n)).copy() for n in names}
    losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0])
                    .ravel()[0]) for f in feeds(name)]
    params = {n: np.asarray(scope.get(n)).copy() for n in names}
    return init, losses, params


def _jax_pipeline(name, k, m, schedule, init):
    from paddle_tpu.parallel import (BuildStrategy, DeviceMesh,
                                     ParallelExecutor)
    pt.reset_default_programs()
    pt.reset_global_scope()
    main, start, loss = build(pt, name)
    pt.Executor().run(start)
    scope = pt.global_scope()
    for n, v in init.items():
        scope.set_var(n, jax.numpy.asarray(v))
    mesh = DeviceMesh(jax.devices()[:k], {"pp": k})
    pe = ParallelExecutor(loss_name=loss, main_program=main, mesh=mesh,
                          build_strategy=BuildStrategy(
                              pipeline_stages=k, num_microbatches=m,
                              pipeline_schedule=schedule))
    losses = [float(np.asarray(pe.run(feed=f, fetch_list=[loss])[0])
                    .ravel()[0]) for f in feeds(name)]
    return losses, {n: np.asarray(scope.get(n)).copy() for n in init}


def _port_one_process(name, k, m, schedule, init):
    ptt.reset_global_scope()
    main, start, loss = build(ptt, name)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    ptt.io.load_numpy_params(init, place=ptt.CPUPlace())
    prog = partition(ptt, main, k, m=m, schedule=schedule)
    losses = [float(np.asarray(tpipe.run_one_process(
        exe, prog, feed=f, fetch_list=[loss])[0]).ravel()[0])
        for f in feeds(name)]
    scope = ptt.global_scope()
    return losses, {n: np.asarray(scope.get(n)).copy() for n in init}


def _close(got, want):
    losses, params = got
    wl, wp = want
    np.testing.assert_allclose(losses, wl, **TOL)
    for n in wp:
        np.testing.assert_allclose(params[n], wp[n], err_msg=n, **TOL)


# the JAX ParallelExecutor references, each a small compile
ENGINE = [("mlp", 2, 4, "1f1b"), ("mlp", 2, 4, "gpipe"),
          ("mlp6", 4, 8, "1f1b"), ("conv", 2, 2, "gpipe"),
          ("conv", 2, 4, "1f1b")]


@pytest.mark.parametrize("name,k,m,schedule", ENGINE)
def test_one_process_engine_equals_jax_parallel_executor(name, k, m,
                                                         schedule):
    init, base_l, base_p = _jax_init(name)
    got = _port_one_process(name, k, m, schedule, init)
    _close(got, _jax_pipeline(name, k, m, schedule, init))
    _close(got, (base_l, base_p))
    c = tpipe.schedule_census(schedule, m, k)
    assert tpipe.LAST_STEP["peak_stash_per_stage"] == \
        c["peak_stash_per_stage"]


def _grad_names(main):
    return sorted(v.name + "@GRAD" for v in main.global_block().vars.values()
                  if getattr(v, "trainable", False))


@pytest.mark.parametrize("k,schedule", [(2, "gpipe"), (2, "1f1b"),
                                        (4, "1f1b")])
def test_one_process_engine_trains_the_lm_as_jax(k, schedule, f32_matmuls):
    """Each of 3 Adam steps from the JAX Executor's state before it (Adam
    turns float32 rounding of near-zero gradients into lr-sized moves, so
    the states are re-aligned a step): the loss and every parameter
    gradient at 1e-5."""
    pt.reset_default_programs()
    pt.reset_global_scope()
    jmain, jstart, loss = build(pt, "lm")
    jexe = pt.Executor()
    jexe.run(jstart)
    jscope = pt.global_scope()
    state = [v.name for v in jmain.global_block().vars.values()
             if v.persistable and jscope.has_var(v.name)]
    grads = _grad_names(jmain)
    main, start, _ = build(ptt, "lm")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    prog = partition(ptt, main, k, m=4, schedule=schedule)
    for f in feeds("lm"):
        before = {n: np.asarray(jscope.get(n)).copy() for n in state}
        want = jexe.run(jmain, feed=f, fetch_list=[loss] + grads)
        ptt.io.load_numpy_params(before, place=ptt.CPUPlace())
        got = tpipe.run_one_process(exe, prog, feed=f,
                                    fetch_list=[loss] + grads)
        for n, g, w in zip([loss] + grads, got, want):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       err_msg=n, **TOL)


def test_one_process_engine_lm_equals_jax_parallel_executor(f32_matmuls):
    init, _, _ = _jax_init("lm2")
    got = _port_one_process("lm2", 2, 2, "1f1b", init)
    _close(got, _jax_pipeline("lm2", 2, 2, "1f1b", init))


def test_engine_moves_the_tables_boundary_bytes():
    init, _, _ = _jax_init("mlp6")
    _port_one_process("mlp6", 4, 8, "1f1b", init)
    main = build(ptt, "mlp6")[0]
    tp = partition(ptt, main, 4, m=8)
    s = tpipe.build_schedule("1f1b", 8, 4)
    live = tpipe.pp_live_transfers(s, tpipe.cut_numels(
        tp.global_block(), 2))
    assert tpipe.LAST_STEP["moved_bytes"] == sum(x["send_bytes"]
                                                 for x in live)
    assert sum(x["sends"] for x in live) == sum(x["recvs"] for x in live) \
        == 2 * 8 * 3


def test_partitioned_program_outside_an_engine_raises():
    main, start, loss = build(ptt, "mlp")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    with pytest.raises(InvalidArgumentError,
                       match="one_process"):
        exe.run(partition(ptt, main, 2), feed=feeds("mlp")[0],
                fetch_list=[loss])


def test_batch_not_divisible_by_microbatches_raises():
    main, start, loss = build(ptt, "mlp")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start)
    with pytest.raises(InvalidArgumentError,
                       match="num_microbatches"):
        tpipe.run_one_process(exe, partition(ptt, main, 2, m=3),
                              feed=feeds("mlp", bs=16)[0],
                              fetch_list=[loss])


def test_pipeline_apply_at_one_stage_equals_jax():
    from paddle_tpu.parallel import DeviceMesh as JMesh
    rng = np.random.RandomState(0)
    w = rng.rand(1, 6, 6).astype("f4")
    x = rng.rand(8, 6).astype("f4")
    jy = jpipe.pipeline_apply(
        JMesh(jax.devices()[:1], {"pp": 1}),
        lambda p, h: jax.numpy.tanh(h @ p["w"]), {"w": w}, x, 4)
    ty = tpipe.pipeline_apply(
        ptt.parallel.DeviceMesh(axes={"pp": 1}),
        lambda p, h: torch.tanh(h @ p["w"]), {"w": torch.tensor(w)},
        torch.tensor(x), 4)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    with pytest.raises(InvalidArgumentError):
        tpipe.pipeline_apply(ptt.parallel.DeviceMesh(axes={"pp": 1}),
                             lambda p, h: h, {"w": torch.tensor(w)},
                             torch.tensor(x), 3)
