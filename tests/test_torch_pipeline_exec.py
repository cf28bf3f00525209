"""Pipeline-parallel training through the port's ParallelExecutor in a
gloo world of 4 CPU processes, against the JAX ParallelExecutor on 4
virtual devices.

One world (a module-scoped fixture over `paddle_tpu_torch.distributed.
launch`, file store under tmp_path, 120 s collective timeout) runs every
scenario; each rank writes its results to rank<r>.npz. The JAX side runs
in this process from the same startup parameters:

- a {"pp": 4} mesh: the depth-6 MLP of tests/test_pipeline_parallel.py at
  M 8 under 1F1B, 3 Momentum steps, and `run_steps` over the same feeds;
- {"dp": 2, "pp": 2} under AllReduce (the region averages over dp) and
  under ReduceScatter (grad_comm's rewrite owns the dp reduction);
- the hidden-fetch refusal (the JAX package's message), and the
  `pipeline` flag off (the program runs unpartitioned, the one-device
  losses, as tests/test_zpipeline_exec.py);
- one profiled step's measured census (`costs.measured_collective_
  census`): each rank's point-to-point sends equal the engine's tables
  (`pipeline.pp_live_transfers`) in count and bytes, and its gradient
  all-reduces equal `costs.predict`'s wire bytes;
- `BuildStrategy.auto_parallel` with the cost constants set to the JAX
  package's: the adopted point is the JAX planner's, its losses the
  one-device Executor's, its census the prediction;
- `pipeline_apply` over pp 4 against the JAX package's.

Float32 throughout, held at 1e-5 relative (atol 1e-6). The mesh-size
refusal needs no world (it raises before any collective).
"""

import json
import os
import traceback

import numpy as np
import pytest

import paddle_tpu_torch as ptt

from tests.port_env import port_jax_compile_cache  # noqa: F401

WORLD = 4
STEPS = 3
BS = 16
TOL = dict(rtol=1e-5, atol=1e-6)
#: the port's cost constant -> the JAX package's
JAX_CONSTANTS = {"H100_PEAK_FLOPS": "V5E_PEAK_TFLOPS",
                 "H100_HBM_BPS": "V5E_HBM_BPS",
                 "H100_HBM_BYTES": "V5E_HBM_BYTES",
                 "H100_NVLINK_BPS": "V5E_ICI_BPS",
                 "H100_PCIE_BPS": "V5E_PCIE_BPS"}
#: scenario -> (model depth, mesh axes, microbatches, reduce mode)
SCENARIOS = {"pp4": (6, {"pp": 4}, 8, "AllReduce"),
             "dp2pp2_ar": (4, {"dp": 2, "pp": 2}, 4, "AllReduce"),
             "dp2pp2_rs": (4, {"dp": 2, "pp": 2}, 4, "ReduceScatter")}


# ---------------------------------------------------------------------------
# the program, built the same way in both packages
# ---------------------------------------------------------------------------


def _mlp(pkg, depth):
    L = pkg.layers
    x = L.data("x", shape=[32])
    label = L.data("label", shape=[1], dtype="int64")
    h = x
    for _ in range(depth):
        h = L.fc(h, size=64, act="relu")
    logits = L.fc(h, size=10)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    pkg.optimizer.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)
    return loss, h


def _build(pkg, depth):
    pkg.reset_default_programs()
    pkg.reset_global_scope()
    guard = (pkg.unique_name.guard() if pkg is ptt
             else pkg.core.unique_name.guard())
    with guard:
        return _mlp(pkg, depth)


def _feeds(n=STEPS):
    rng = np.random.RandomState(11)
    return [{"x": rng.rand(BS, 32).astype("f4"),
             "label": rng.randint(0, 10, (BS, 1)).astype("int64")}
            for _ in range(n)]


def _params(scope, program):
    return {v.name: np.asarray(scope.get(v.name)).copy()
            for v in program.global_block().vars.values()
            if getattr(v, "trainable", False) and scope.has_var(v.name)}


def _strategy(mod, m, reduce, **kw):
    return mod.BuildStrategy(pipeline_stages=kw.pop("stages", 2),
                             num_microbatches=m, pipeline_schedule="1f1b",
                             reduce_strategy=getattr(mod.ReduceStrategy,
                                                     reduce), **kw)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _port_pe(depth, mesh, init, bst):
    from paddle_tpu_torch.parallel import ParallelExecutor
    loss, hidden = _build(ptt, depth)
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    ptt.io.load_numpy_params(init, place=ptt.CPUPlace())
    return ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                            build_strategy=bst), loss, hidden


def _census(pe, loss, feed, out, key):
    """One profiled step: its measured census against the engine's tables
    and the prediction."""
    import torch

    from paddle_tpu_torch.framework import costs
    from paddle_tpu_torch.parallel import pipeline
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        pe.run(fetch_list=[loss], feed=feed)
    census = costs.measured_collective_census(prof)
    sends = census.get("collective-permute", [])
    out[key + "p2p"] = np.array([len(sends), sum(b for b, _ in sends)])
    prog = pe.prepare_program()
    k = pe.mesh.axis_index("pp")
    if getattr(prog, "_pp_applied", False):
        region = next(op for op in prog.global_block().ops
                      if op.type == "pp_pipeline_region")
        sched = pipeline.build_schedule(region.attrs["schedule"],
                                        region.attrs["num_microbatches"],
                                        region.attrs["num_stages"])
        rows = BS // pe._dp // region.attrs["num_microbatches"]
        live = pipeline.pp_live_transfers(
            sched, pipeline.cut_numels(prog.global_block(), rows))[k]
        out[key + "tables"] = np.array([live["sends"], live["send_bytes"]])
        out[key + "engine"] = np.array(
            [pipeline.LAST_STEP["transfers"]["sends"],
             pipeline.LAST_STEP["transfers"]["send_bytes"]])
        out[key + "peak_stash"] = np.array(
            pipeline.LAST_STEP["peak_stash_per_stage"])
    grads = {kind: v for kind, v in census.items()
             if kind != "collective-permute"}
    n = max(pe.mesh.axis_size(a) for a in pe.mesh.axes)
    out[key + "wire"] = np.array([
        costs.census_wire_bytes(grads, n, min_bytes=16),
        costs.predicted_wire_bytes(pe.cost_report(nominal_batch=BS))])


def _pipeline_job(rank, name, inits, out):
    from paddle_tpu_torch import parallel as P
    depth, axes, m, reduce = SCENARIOS[name]
    mesh = P.DeviceMesh(axes=axes)
    pe, loss, _ = _port_pe(depth, mesh, inits[f"mlp{depth}"],
                           _strategy(P, m, reduce,
                                     stages=axes["pp"]))
    out[name + "_loss"] = np.array(
        [float(np.asarray(pe.run(fetch_list=[loss], feed=f)[0]).ravel()[0])
         for f in _feeds()])
    for n, v in _params(ptt.global_scope(),
                        ptt.default_main_program()).items():
        out[name + "_p:" + n] = v
    _census(pe, loss, _feeds(1)[0], out, name + "_census_")


def _run_steps_job(rank, inits, out):
    from paddle_tpu_torch import parallel as P
    depth, axes, m, reduce = SCENARIOS["pp4"]
    pe, loss, _ = _port_pe(depth, P.DeviceMesh(axes=axes),
                           inits[f"mlp{depth}"],
                           _strategy(P, m, reduce, stages=4))
    out["run_steps_loss"] = np.asarray(
        pe.run_steps(_feeds(), fetch_list=[loss])[0]).ravel()


def _refusal_and_flag_job(rank, inits, out):
    from paddle_tpu_torch import parallel as P
    mesh = P.DeviceMesh(axes={"pp": 4})
    pe, loss, hidden = _port_pe(6, mesh, inits["mlp6"],
                                _strategy(P, 8, "AllReduce", stages=4))
    try:
        pe.run(fetch_list=[loss, hidden], feed=_feeds(1)[0])
        out["hidden_refused"] = np.array(["", ""])
    except Exception as e:  # noqa: BLE001 — compared in the parent
        out["hidden_refused"] = np.array([type(e).__name__, str(e)])
    ptt.flags.set_flag("pipeline", False)
    try:
        pe, loss, _ = _port_pe(6, mesh, inits["mlp6"],
                               _strategy(P, 8, "AllReduce", stages=4))
        out["flag_off_loss"] = np.array(
            [float(np.asarray(pe.run(fetch_list=[loss], feed=f)[0])
                   .ravel()[0]) for f in _feeds()])
        out["flag_off_pp"] = np.array(
            bool(getattr(pe.prepare_program(), "_pp_applied", False)))
    finally:
        ptt.flags.set_flag("pipeline", True)


def _auto_parallel_job(rank, inits, out):
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.framework import costs
    for port, value in inits["constants"].items():
        setattr(costs, port, value)
    costs.H100_HOST_OP_S = 0.0
    pe, loss, _ = _port_pe(4, P.DeviceMesh(axes={"dp": WORLD}),
                           inits["mlp4"],
                           P.BuildStrategy(auto_parallel=True))
    out["auto_loss"] = np.array(
        [float(np.asarray(pe.run(fetch_list=[loss], feed=f)[0]).ravel()[0])
         for f in _feeds()])
    rep = pe.auto_plan_report()
    out["auto_point"] = np.array(rep.point.describe())
    out["auto_axes"] = np.array(json.dumps(dict(pe.mesh.axes)))
    _census(pe, loss, _feeds(1)[0], out, "auto_census_")


def _pipeline_apply_job(rank, inits, out):
    import torch

    from paddle_tpu_torch import parallel as P
    w, x = inits["apply"]["w"], inits["apply"]["x"]
    y = P.pipeline.pipeline_apply(
        P.DeviceMesh(axes={"pp": WORLD}),
        lambda p, h: torch.tanh(h @ p["w"]), {"w": torch.tensor(w)},
        torch.tensor(x), 4)
    out["apply_y"] = y.numpy()


def _world(rank, world, outdir):
    inits = np.load(os.path.join(outdir, "inits.npz"),
                    allow_pickle=True)["inits"].item()
    out, errors = {}, {}
    jobs = [(n, _pipeline_job, (n,)) for n in SCENARIOS]
    jobs += [("run_steps", _run_steps_job, ()),
             ("refusal_flag", _refusal_and_flag_job, ()),
             ("pipeline_apply", _pipeline_apply_job, ()),
             ("auto", _auto_parallel_job, ())]
    for name, fn, args in jobs:
        try:
            fn(rank, *args, inits, out)
        except Exception:
            errors[name] = traceback.format_exc()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"errors{rank}.json"), "w") as f:
        json.dump(errors, f)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_init(depth):
    import paddle_tpu as pt
    _build(pt, depth)
    pt.Executor().run(pt.default_startup_program())
    return {v.name: np.asarray(pt.global_scope().get(v.name)).copy()
            for v in pt.default_main_program().global_block().vars.values()
            if v.persistable and pt.global_scope().has_var(v.name)}


def _jax_run(depth, init, axes=None, bst=None):
    """Losses and trainable parameters after STEPS steps: the JAX
    ParallelExecutor on `axes` over virtual devices, or (axes None) the
    one-device Executor."""
    import jax

    import paddle_tpu as pt
    from paddle_tpu.parallel import DeviceMesh, ParallelExecutor
    loss, hidden = _build(pt, depth)
    pt.Executor().run(pt.default_startup_program())
    scope = pt.global_scope()
    for n, v in init.items():
        scope.set_var(n, jax.numpy.asarray(v))
    if axes is None:
        exe = pt.Executor()
        run = lambda f: exe.run(feed=f, fetch_list=[loss])  # noqa: E731
    else:
        n = int(np.prod(list(axes.values())))
        pe = ParallelExecutor(loss_name=loss.name,
                              mesh=DeviceMesh(jax.devices()[:n], axes),
                              build_strategy=bst)
        run = lambda f: pe.run(feed=f, fetch_list=[loss])  # noqa: E731
    losses = [float(np.asarray(run(f)[0]).ravel()[0]) for f in _feeds()]
    return np.array(losses), _params(scope, pt.default_main_program())


def _jax_hidden_refusal(init):
    import jax

    import paddle_tpu as pt
    from paddle_tpu import parallel as P
    loss, hidden = _build(pt, 6)
    pt.Executor().run(pt.default_startup_program())
    pe = P.ParallelExecutor(loss_name=loss.name,
                            mesh=P.DeviceMesh(jax.devices()[:4], {"pp": 4}),
                            build_strategy=_strategy(P, 8, "AllReduce",
                                                     stages=4))
    with pytest.raises(Exception) as e:
        pe.run(feed=_feeds(1)[0], fetch_list=[loss, hidden])
    return type(e.value).__name__, str(e.value)


def _jax_plan():
    import paddle_tpu as pt
    from paddle_tpu.framework import auto_parallel
    loss, _ = _build(pt, 4)
    # the space ParallelExecutor searches (memory plans off: the port
    # runs none on a rewritten program yet)
    return auto_parallel.plan(pt.default_main_program(), WORLD,
                              nominal_batch=BS, space=auto_parallel.
                              SearchSpace(quant_modes=("",),
                                          memory_plan=(False,)))


def _jax_pipeline_apply(w, x):
    import jax

    from paddle_tpu.parallel import DeviceMesh
    from paddle_tpu.parallel.pipeline import pipeline_apply
    return np.asarray(pipeline_apply(
        DeviceMesh(jax.devices()[:WORLD], {"pp": WORLD}),
        lambda p, h: jax.numpy.tanh(h @ p["w"]), {"w": w}, x, 4))


@pytest.fixture(scope="module")
def refs():
    from paddle_tpu import parallel as P
    from paddle_tpu.framework import costs as jcosts
    inits = {"mlp6": _jax_init(6), "mlp4": _jax_init(4)}
    out = {"one_device6": _jax_run(6, inits["mlp6"]),
           "one_device4": _jax_run(4, inits["mlp4"])}
    for name, (depth, axes, m, reduce) in SCENARIOS.items():
        out[name] = _jax_run(depth, inits[f"mlp{depth}"], axes,
                             _strategy(P, m, reduce, stages=axes["pp"]))
    out["hidden"] = _jax_hidden_refusal(inits["mlp6"])
    out["plan"] = _jax_plan()
    rng = np.random.RandomState(3)
    w = (rng.rand(WORLD, 6, 6).astype("f4") - 0.5)
    x = rng.rand(8, 6).astype("f4")
    inits["apply"] = {"w": w, "x": x}
    out["apply"] = _jax_pipeline_apply(w, x)
    inits["constants"] = {p: getattr(jcosts, j)
                          for p, j in JAX_CONSTANTS.items()}
    return inits, out


@pytest.fixture(scope="module")
def world(refs, tmp_path_factory):
    d = tmp_path_factory.mktemp("pp_world")
    np.savez(os.path.join(d, "inits.npz"),
             inits=np.array(refs[0], dtype=object))
    ptt.distributed.launch(f"{os.path.abspath(__file__)}:_world", WORLD,
                           args=[str(d)], timeout_s=120, store_dir=str(d),
                           place="cpu")
    res, errs = [], []
    for r in range(WORLD):
        res.append(dict(np.load(os.path.join(d, f"rank{r}.npz"))))
        errs.append(json.load(open(os.path.join(d, f"errors{r}.json"))))
    return res, errs


def _rank(world, r, job):
    res, errs = world
    assert job not in errs[r], errs[r][job]
    return res[r]


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pipeline_matches_the_jax_parallel_executor(world, refs, name):
    want_l, want_p = refs[1][name]
    depth = SCENARIOS[name][0]
    one_l, _ = refs[1][f"one_device{depth}"]
    np.testing.assert_allclose(want_l, one_l, **TOL)
    for r in range(WORLD):
        got = _rank(world, r, name)
        np.testing.assert_allclose(got[name + "_loss"], want_l, **TOL)
        for n, w in want_p.items():
            np.testing.assert_allclose(got[name + "_p:" + n], w,
                                       err_msg=n, **TOL)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_measured_census_equals_the_engine_tables(world, name):
    """Each rank's point-to-point sends in one profiled step equal the
    tables' count and bytes (and the engine's own tally); its gradient
    all-reduces put the predicted bytes on the wire; its peak stash is the
    census's for its stage."""
    from paddle_tpu_torch.parallel.pipeline import schedule_census
    _, axes, m, _ = SCENARIOS[name]
    c = schedule_census("1f1b", m, axes["pp"])
    key = name + "_census_"
    for r in range(WORLD):
        got = _rank(world, r, name)
        np.testing.assert_array_equal(got[key + "p2p"], got[key + "tables"])
        np.testing.assert_array_equal(got[key + "engine"],
                                      got[key + "tables"])
        assert got[key + "p2p"][0] == 2 * m or got[key + "p2p"][0] == m
        k = r % axes["pp"]
        assert list(got[key + "peak_stash"]) == \
            [c["peak_stash_per_stage"][k]]
        measured, predicted = got[key + "wire"]
        assert predicted > 0
        assert abs(measured - predicted) <= 1.0, (measured, predicted)


def test_run_steps_gives_the_run_losses(world, refs):
    for r in range(WORLD):
        got = _rank(world, r, "run_steps")
        np.testing.assert_allclose(got["run_steps_loss"], refs[1]["pp4"][0],
                                   **TOL)


def test_hidden_fetch_refused_and_flag_off_unpartitioned(world, refs):
    one_l, _ = refs[1]["one_device6"]
    for r in range(WORLD):
        got = _rank(world, r, "refusal_flag")
        assert tuple(got["hidden_refused"]) == refs[1]["hidden"]
        np.testing.assert_allclose(got["flag_off_loss"], one_l, **TOL)
        assert not bool(got["flag_off_pp"])


def test_auto_parallel_adopts_the_jax_plan(world, refs):
    plan = refs[1]["plan"]
    one_l, _ = refs[1]["one_device4"]
    for r in range(WORLD):
        got = _rank(world, r, "auto")
        assert str(got["auto_point"]) == plan.point.describe()
        assert json.loads(str(got["auto_axes"])) == dict(plan.mesh_axes)
        np.testing.assert_allclose(got["auto_loss"], one_l, **TOL)
        measured, predicted = got["auto_census_wire"]
        assert abs(measured - predicted) <= 1.0, (measured, predicted)


def test_pipeline_apply_matches_jax(world, refs):
    for r in range(WORLD):
        got = _rank(world, r, "pipeline_apply")
        np.testing.assert_allclose(got["apply_y"], refs[1]["apply"], **TOL)


def test_mesh_size_refusal_is_the_jax_packages():
    """pipeline_stages=2 on a mesh with no pp axis of 2: both packages
    raise the same InvalidArgumentError before any collective."""
    import jax

    import paddle_tpu as pt
    from paddle_tpu import parallel as JP
    from paddle_tpu_torch import parallel as TP
    errs = []
    for pkg, mod in ((pt, JP), (ptt, TP)):
        loss, _ = _build(pkg, 4)
        if pkg is pt:
            pt.Executor().run(pt.default_startup_program())
            pe = JP.ParallelExecutor(
                loss_name=loss.name,
                mesh=JP.DeviceMesh(jax.devices()[:4], {"dp": 4}),
                build_strategy=_strategy(JP, 4, "AllReduce"))
        else:
            ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
            pe = TP.ParallelExecutor(
                use_cuda=False, loss_name=loss.name,
                mesh=TP.DeviceMesh(ranks=range(4), axes={"dp": 4}),
                build_strategy=_strategy(TP, 4, "AllReduce"))
        with pytest.raises(Exception) as e:
            pe.run(fetch_list=[loss], feed=_feeds(1)[0])
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[0] == errs[1]
    assert errs[1][0] == "InvalidArgumentError"
