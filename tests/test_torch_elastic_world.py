"""Elastic training and checkpoints of the port in a gloo world of 4 CPU
processes, held against the JAX package on virtual devices.

- The non-sharded checkpoint of a ZeRO-1 world (Reduce, Adam) and of a
  ReduceScatter world on the int8 wire with error feedback, over ranks
  [0, 1]: the files equal the JAX ParallelExecutor's `save_checkpoint` on
  2 devices (names, shapes, values at 1e-6), a plain Executor continues
  from them with the JAX package's losses, and the same files loaded back
  into the ParallelExecutor's scope are cut to each rank's block.
- A multi-writer snapshot of the small LM at dp2 x tp2 (ReduceScatter,
  Adam): one manifest a rank and one COMMIT; restored as dp 4 and as dp 2
  over ranks [0, 1], the next 2 losses equal the JAX package's
  `restore_train_state` runs within 1e-5, each rank reading what the
  reshard plan says it reads.
- A rank dropped at the ack phase: the barrier aborts on every rank, no
  snapshot commits, `ptpu_ckpt_barrier_aborts_total` counts it.
- `replan_on_restore`'s decision record equals the JAX package's under
  its cost constants (one process: a mesh of 4 unjoined ranks).

One world for the file (60 s collective timeout); the JAX references
run in the parent on virtual devices.
"""

import json
import os
import traceback

import numpy as np
import pytest

import paddle_tpu_torch as ptt

from tests.port_env import port_jax_compile_cache  # noqa: F401

WORLD = 4
VOCAB, T, D, HEADS, LAYERS = 32, 4, 16, 2, 2
SNAP_STEP = 3


@pytest.fixture(autouse=True)
def _f32_matmuls():
    import paddle_tpu as pt
    olds = [pkg.flags.get_flag("use_bf16_matmul")
            for pkg in (pt.core, ptt)]
    pt.core.flags.set_flag("use_bf16_matmul", False)
    ptt.flags.set_flag("use_bf16_matmul", False)
    yield
    pt.core.flags.set_flag("use_bf16_matmul", olds[0])
    ptt.flags.set_flag("use_bf16_matmul", olds[1])


def _fc(pkg):
    L = pkg.layers
    x = L.data("img", shape=[16])
    label = L.data("label", shape=[1], dtype="int64")
    h = L.fc(x, size=32, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))
    pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    return loss


def _lm(pkg):
    loss, _ = pkg.models.transformer.transformer_lm(
        vocab=VOCAB, max_len=T, d_model=D, d_inner=2 * D, num_heads=HEADS,
        num_layers=LAYERS, mean_loss=True)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _fc_feeds(n=3):
    rng = np.random.RandomState(11)
    return [{"img": rng.rand(8, 16).astype("float32"),
             "label": rng.randint(0, 10, (8, 1)).astype("int64")}
            for _ in range(n)]


def _lm_feeds(n=SNAP_STEP + 2):
    rng = np.random.RandomState(5)
    return [{"tokens": rng.randint(0, VOCAB, (8, T)).astype("int64"),
             "tokens@SEQLEN": np.full((8,), T, dtype="int32"),
             "targets": rng.randint(0, VOCAB, (8, T)).astype("int64")}
            for _ in range(n)]


def _strategy(mod, mode, quant=""):
    return mod.BuildStrategy(
        reduce_strategy=getattr(mod.ReduceStrategy, mode), quant_comm=quant,
        comm_error_feedback=bool(quant), quant_comm_block=64)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _port_build(make, init):
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        loss = make(ptt)
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    ptt.io.load_numpy_params(init, place=ptt.CPUPlace())
    return loss


def _loss(pe, loss, feed):
    return float(np.asarray(pe.run(fetch_list=[loss], feed=feed)[0])
                 .ravel()[0])


def _zero1(rank, mesh, case, outdir, inits, out):
    """One step, a non-sharded save_checkpoint over the mesh, then the
    files loaded back into the executor's scope and one more step."""
    from paddle_tpu_torch.parallel import ParallelExecutor, strategy
    mode, quant = {"reduce": ("Reduce", ""),
                   "rs8": ("ReduceScatter", "int8")}[case]
    loss = _port_build(_fc, inits["fc"])
    main = ptt.default_main_program()
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                          build_strategy=_strategy(strategy, mode, quant))
    feeds = _fc_feeds()
    out[f"{case}_loss0"] = np.array(_loss(pe, loss, feeds[0]))
    scope = ptt.global_scope()
    prog = pe.prepare_program()
    split = sorted(n for n in scope.local_var_names()
                   if not pe.state_sharding(prog, n).is_replicated
                   and not n.startswith("dp_comm_err"))
    out[f"{case}_split"] = np.array(json.dumps(split))
    blocks = {n: scope.get(n).clone() for n in split}
    ptt.trainer.save_checkpoint(pe, os.path.join(outdir, case), main,
                                trainer_args={"step": 1}, scope=scope)
    # the same files back into this scope: whole values, cut at the run
    ptt.trainer.load_checkpoint(pe, os.path.join(outdir, case), main,
                                scope=scope)
    out[f"{case}_whole_after_load"] = np.array(all(
        tuple(scope.get(n).shape) == tuple(prog.global_block().var(n).shape)
        for n in split))
    out[f"{case}_loss1"] = np.array(_loss(pe, loss, feeds[1]))
    out[f"{case}_cut_after_run"] = np.array(all(
        tuple(scope.get(n).shape) == tuple(blocks[n].shape) for n in split))


def _snapshot(rank, mesh, outdir, inits, out):
    from paddle_tpu_torch.parallel import (ParallelExecutor, annotate_tp,
                                           elastic, strategy)
    loss = _port_build(_lm, inits["lm"])
    annotate_tp()
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                          build_strategy=_strategy(strategy,
                                                   "ReduceScatter"))
    feeds = _lm_feeds()
    out["snap_loss"] = np.array([_loss(pe, loss, f)
                                 for f in feeds[:SNAP_STEP]])
    path = elastic.save_train_state(os.path.join(outdir, "snap"),
                                    executor=pe, step=SNAP_STEP)
    out["snap_path"] = np.array(str(path))
    # a rank dropped at the ack phase: the barrier aborts everywhere
    os.environ["PTPU_FAULT_INJECT"] = "drop_rank:1@ack"
    try:
        got = elastic.save_train_state(os.path.join(outdir, "drop"),
                                       executor=pe, step=SNAP_STEP,
                                       barrier_deadline_s=2.0)
    finally:
        del os.environ["PTPU_FAULT_INJECT"]
    out["drop_path"] = np.array(str(got))
    out["drop_aborts"] = np.array(elastic.metrics_registry().get(
        "ptpu_ckpt_barrier_aborts_total").value)


def _restore(rank, mesh, name, outdir, inits, out):
    from paddle_tpu_torch.parallel import (ParallelExecutor, elastic,
                                           strategy)
    loss = _port_build(_lm, inits["lm"])
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                          build_strategy=_strategy(strategy,
                                                   "ReduceScatter"))
    meta = elastic.restore_train_state(os.path.join(outdir, "snap"),
                                       executor=pe)
    out[f"{name}_reshard"] = np.array(json.dumps(meta["reshard"]))
    out[f"{name}_read"] = np.array(meta["restore_read_bytes"])
    feeds = _lm_feeds()
    out[f"{name}_loss"] = np.array([_loss(pe, loss, f)
                                    for f in feeds[SNAP_STEP:]])


def _world(rank, world, outdir):
    import torch

    from paddle_tpu_torch.parallel import DeviceMesh
    ptt.flags.set_flag("use_bf16_matmul", False)
    inits = {k: dict(v) for k, v in np.load(
        os.path.join(outdir, "inits.npz"), allow_pickle=True)[
            "inits"].item().items()}
    # every rank builds every mesh, in one order (new_group is collective)
    pair = DeviceMesh(ranks=[0, 1], axes={"dp": 2})
    dptp = DeviceMesh(axes={"dp": 2, "tp": 2})
    dp4 = DeviceMesh(axes={"dp": 4})
    out, errors = {}, {}

    def run(name, fn, *args):
        try:
            fn(rank, *args, outdir, inits, out)
        except Exception:
            errors[name] = traceback.format_exc()

    if pair.in_mesh:
        for case in ("reduce", "rs8"):
            run(case, _zero1, pair, case)
    # no rank runs ahead into a job its peers have not reached
    torch.distributed.barrier()
    run("snap", _snapshot, dptp)
    run("dp4", _restore, dp4, "dp4")
    if pair.in_mesh:
        run("dp2", _restore, pair, "dp2")
    torch.distributed.barrier()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"errors{rank}.json"), "w") as f:
        json.dump(errors, f)


# ---------------------------------------------------------------------------
# the JAX side, on virtual devices
# ---------------------------------------------------------------------------


def _jax_build(make):
    import paddle_tpu as pt
    pt.reset_default_programs()
    pt.reset_global_scope()
    with pt.core.unique_name.guard():
        loss = make(pt)
    pt.Executor().run(pt.default_startup_program())
    return pt, loss


def _trainable(pt, scope):
    return {v.name: np.asarray(scope.get(v.name)).copy()
            for v in pt.default_main_program().global_block().vars.values()
            if getattr(v, "trainable", False) and scope.has_var(v.name)}


def _jax_pe(pt, loss, axes, mode, quant="", annotate=False):
    import jax

    from paddle_tpu.parallel import ParallelExecutor, annotate_tp, strategy
    from paddle_tpu.parallel.mesh import DeviceMesh
    if annotate:
        assert annotate_tp()
    n = int(np.prod(list(axes.values())))
    return ParallelExecutor(loss_name=loss.name,
                            build_strategy=_strategy(strategy, mode, quant),
                            mesh=DeviceMesh(jax.devices()[:n], axes))


def _jax_continue(pt, dirname, make, feeds):
    """A plain JAX Executor from a checkpoint dir: the next steps' loss."""
    pt, loss = _jax_build(make)
    exe = pt.Executor()
    pt.trainer.load_checkpoint(exe, dirname, pt.default_main_program())
    return [float(np.asarray(exe.run(feed=f, fetch_list=[loss])[0]))
            for f in feeds]


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    import paddle_tpu as pt
    from paddle_tpu.core import flags
    from paddle_tpu.parallel import elastic as jelastic
    d = tmp_path_factory.mktemp("jax_elastic")
    old = flags.get_flag("use_bf16_matmul")
    flags.set_flag("use_bf16_matmul", False)
    try:
        out = {"inits": {}}
        for case, mode, quant in (("reduce", "Reduce", ""),
                                  ("rs8", "ReduceScatter", "int8")):
            pt, loss = _jax_build(_fc)
            out["inits"]["fc"] = _trainable(pt, pt.global_scope())
            pe = _jax_pe(pt, loss, {"dp": 2}, mode, quant)
            out[case + "_loss0"] = float(np.asarray(pe.run(
                fetch_list=[loss], feed=_fc_feeds()[0])[0]).ravel()[0])
            pt.trainer.save_checkpoint(pe, str(d / case),
                                       pt.default_main_program(),
                                       trainer_args={"step": 1})
            out[case + "_dir"] = str(d / case / "checkpoint_0")
            out[case + "_next"] = _jax_continue(
                pt, str(d / case), _fc, _fc_feeds()[1:])
        pt, loss = _jax_build(_lm)
        out["inits"]["lm"] = _trainable(pt, pt.global_scope())
        pe = _jax_pe(pt, loss, {"dp": 2, "tp": 2}, "ReduceScatter",
                     annotate=True)
        feeds = _lm_feeds()
        out["snap_loss"] = [float(np.asarray(pe.run(
            fetch_list=[loss], feed=f)[0])) for f in feeds[:SNAP_STEP]]
        jelastic.save_train_state(str(d / "snap"), executor=pe,
                                  step=SNAP_STEP)
        out["snap_dir"] = str(d / "snap")
        for name, axes in (("dp4", {"dp": 4}), ("dp2", {"dp": 2})):
            pt, loss = _jax_build(_lm)
            pe = _jax_pe(pt, loss, axes, "ReduceScatter")
            meta = jelastic.restore_train_state(str(d / "snap"),
                                                executor=pe)
            out[name + "_reshard"] = meta["reshard"]
            out[name + "_loss"] = [float(np.asarray(pe.run(
                fetch_list=[loss], feed=f)[0])) for f in feeds[SNAP_STEP:]]
    finally:
        flags.set_flag("use_bf16_matmul", old)
    return out


@pytest.fixture(scope="module")
def world(refs, tmp_path_factory):
    """The world's directory, each rank's outputs and errors, and the
    launch's own error (a rank that died or hung): a test reads what the
    ranks left on disk before it needs their outputs."""
    d = tmp_path_factory.mktemp("elastic_world")
    np.savez(os.path.join(d, "inits.npz"),
             inits=np.array(refs["inits"], dtype=object))
    try:
        ptt.distributed.launch(f"{os.path.abspath(__file__)}:_world", WORLD,
                               args=[str(d)], timeout_s=60,
                               store_dir=str(d), place="cpu")
        launch_error = None
    except RuntimeError as e:
        launch_error = str(e)[-4000:]
    res, errs = [], []
    for r in range(WORLD):
        path = os.path.join(d, f"rank{r}.npz")
        res.append(dict(np.load(path)) if os.path.exists(path) else None)
        path = os.path.join(d, f"errors{r}.json")
        errs.append(json.load(open(path)) if os.path.exists(path) else {})
    return str(d), res, errs, launch_error


def _rank(world, r, job):
    _, res, errs, launch_error = world
    assert res[r] is not None, launch_error
    assert job not in errs[r], errs[r][job]
    return res[r]


# ---------------------------------------------------------------------------
# the non-sharded checkpoint of a split world
# ---------------------------------------------------------------------------


def _npy_dir(path):
    return {f[:-4]: np.load(os.path.join(path, f))
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


@pytest.mark.parametrize("case", ["reduce", "rs8"])
def test_split_state_checkpoint_is_whole_and_equals_jax(world, refs, case):
    """Every split state var (ZeRO-1 Adam moments; in the explicit mode
    too) is written whole, with the JAX ParallelExecutor's names, shapes
    and values (1e-6), and the loss of the saved step agrees."""
    # the files first: a world that failed after writing them still shows
    # what it wrote
    port = _npy_dir(os.path.join(world[0], case, "checkpoint_0"))
    jax_files = _npy_dir(refs[case + "_dir"])
    assert sorted(port) == sorted(jax_files)
    for n, want in jax_files.items():
        assert port[n].shape == want.shape, (n, port[n].shape, want.shape)
        np.testing.assert_allclose(port[n], want, rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    assert os.path.exists(os.path.join(world[0], case, "checkpoint_0",
                                       "_SUCCESS"))
    for r in (0, 1):
        got = _rank(world, r, case)
        np.testing.assert_allclose(got[f"{case}_loss0"],
                                   refs[case + "_loss0"], rtol=1e-6)
    split = json.loads(str(_rank(world, 0, case)[f"{case}_split"]))
    assert any("moment1" in n for n in split), split


@pytest.mark.parametrize("case", ["reduce", "rs8"])
def test_plain_executor_continues_from_the_port_files(world, refs, case):
    """A plain Executor loads the port's files and runs the next steps
    with the losses a plain JAX Executor gets from the JAX files."""
    _rank(world, 0, case)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        loss = _fc(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    args = ptt.trainer.load_checkpoint(exe, os.path.join(world[0], case),
                                       ptt.default_main_program())
    assert args == {"step": 1}
    got = [float(np.asarray(exe.run(feed=f, fetch_list=[loss])[0]))
           for f in _fc_feeds()[1:]]
    np.testing.assert_allclose(got, refs[case + "_next"], rtol=1e-5)


@pytest.mark.parametrize("case", ["reduce", "rs8"])
def test_whole_values_loaded_into_the_executor_are_cut(world, case):
    """The saved files loaded back into the ParallelExecutor's scope hold
    whole values until the next run cuts them to each rank's block; that
    run's loss equals the uninterrupted executor's on both ranks."""
    for r in (0, 1):
        got = _rank(world, r, case)
        assert bool(got[f"{case}_whole_after_load"])
        assert bool(got[f"{case}_cut_after_run"])
    np.testing.assert_allclose(_rank(world, 0, case)[f"{case}_loss1"],
                               _rank(world, 1, case)[f"{case}_loss1"])


# ---------------------------------------------------------------------------
# multi-writer snapshots and restores across mesh changes
# ---------------------------------------------------------------------------


def test_multi_writer_snapshot_commits_once(world, refs):
    from paddle_tpu_torch.parallel import elastic
    for r in range(WORLD):
        got = _rank(world, r, "snap")
        np.testing.assert_allclose(got["snap_loss"], refs["snap_loss"],
                                   atol=1e-5)
    paths = {str(_rank(world, r, "snap")["snap_path"])
             for r in range(WORLD)}
    assert len(paths) == 1
    path = paths.pop()
    assert elastic.is_committed(path)
    elastic.validate_snapshot(path)
    names = sorted(os.listdir(path))
    assert [n for n in names if n.startswith("manifest-")] == \
        [f"manifest-{r}.json" for r in range(WORLD)]
    assert [n for n in names if n.startswith("shard-")] == \
        [f"shard-{r}.pts" for r in range(WORLD)]
    assert names.count("COMMIT") == 1
    meta = elastic.read_meta(path)
    assert meta["world"] == {"dp": 2, "tp": 2} and meta["world_size"] == 4
    snaps = elastic.list_snapshots(os.path.dirname(path),
                                   committed_only=False)
    assert len(snaps) == 1 and not any(
        n.startswith(".tmp-") for n in os.listdir(os.path.dirname(path)))


@pytest.mark.parametrize("name,ranks", [("dp4", range(4)),
                                        ("dp2", range(2))])
def test_restore_across_a_mesh_change_matches_jax(world, refs, name,
                                                  ranks):
    """dp2 x tp2 -> dp 4 and -> dp 2 over ranks [0, 1]: the next 2 losses
    equal the JAX package's restore within 1e-5; the reshard summary's
    wire bytes equal JAX's, and each rank read exactly the bytes the plan
    gives its block."""
    want = refs[name + "_loss"]
    jsum = refs[name + "_reshard"]
    for r in ranks:
        got = _rank(world, r, name)
        np.testing.assert_allclose(got[f"{name}_loss"], want, atol=1e-5)
        rs = json.loads(str(got[f"{name}_reshard"]))
        assert rs["new_world"] == jsum["new_world"]
        assert rs["old_world"] == jsum["old_world"] == {"dp": 2, "tp": 2}
        assert rs["wire_bytes"] == jsum["wire_bytes"]
        assert rs["steps"] == jsum["steps"]
        assert rs["n_vars"] == jsum["n_vars"]
        assert int(got[f"{name}_read"]) == rs["rank_read_bytes"]


def test_dropped_rank_aborts_without_a_commit(world):
    from paddle_tpu_torch.parallel import elastic
    root = os.path.join(world[0], "drop")
    for r in range(WORLD):
        got = _rank(world, r, "snap")
        assert str(got["drop_path"]) == "None"
    assert float(_rank(world, 0, "snap")["drop_aborts"]) == 1.0
    assert elastic.latest_snapshot(root) is None
    assert not any(elastic.is_committed(os.path.join(root, n))
                   for n in os.listdir(root))


# ---------------------------------------------------------------------------
# replan on restore
# ---------------------------------------------------------------------------


def test_replan_on_restore_record_equals_jax(refs, monkeypatch):
    """A dp2 x tp2 snapshot restored into an auto-parallel executor on 4
    ranks re-plans; with the port's cost constants set to the JAX
    package's, the decision record is the JAX one (search time aside)."""
    import jax

    import paddle_tpu as pt
    from paddle_tpu.core import flags as jflags
    from paddle_tpu.framework import costs as jcosts
    from paddle_tpu.parallel import ParallelExecutor as JPE
    from paddle_tpu.parallel import elastic as jelastic
    from paddle_tpu.parallel.mesh import DeviceMesh as JMesh
    from paddle_tpu_torch.framework import costs as tcosts
    from paddle_tpu_torch.framework import memory_plan as tmp
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, elastic)
    for port, jname in (("H100_PEAK_FLOPS", "V5E_PEAK_TFLOPS"),
                        ("H100_HBM_BPS", "V5E_HBM_BPS"),
                        ("H100_HBM_BYTES", "V5E_HBM_BYTES"),
                        ("H100_NVLINK_BPS", "V5E_ICI_BPS"),
                        ("H100_PCIE_BPS", "V5E_PCIE_BPS")):
        monkeypatch.setattr(tcosts, port, getattr(jcosts, jname))
    monkeypatch.setattr(tcosts, "H100_HOST_OP_S", 0.0)
    monkeypatch.setattr(tmp, "RECOMPUTE_ALWAYS_RUNS", False)
    # the JAX package's dp2 x tp2 snapshot (same program, same names)
    jflags.set_flag("use_bf16_matmul", False)
    snap = refs["snap_dir"]
    pt.reset_default_programs()
    pt.reset_global_scope()
    with pt.core.unique_name.guard():
        jloss = _lm(pt)
    pt.Executor().run(pt.default_startup_program())
    jpe = JPE(loss_name=jloss.name,
              build_strategy=pt.parallel.BuildStrategy(auto_parallel=True),
              mesh=JMesh(jax.devices()[:4], {"dp": 4}))
    jrec = jelastic.restore_train_state(snap, executor=jpe)["replan"]

    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        loss = _lm(ptt)
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                          build_strategy=BuildStrategy(auto_parallel=True),
                          mesh=DeviceMesh(ranks=range(4), axes={"dp": 4}))
    trec = elastic.restore_train_state(snap, executor=pe,
                                       verify=False)["replan"]
    jrec.pop("search_s")
    trec.pop("search_s")
    jplan, tplan = jrec.pop("plan"), trec.pop("plan")
    assert trec == jrec
    assert trec["replanned"] and trec["kept"]["axes"] == {"dp": 4}
    # the search: memory plans are in the port's space too (the executor
    # plans the rewritten program), so the whole frontier is the JAX one
    for k in ("chosen", "mesh_axes", "predicted_step_ms", "breakdown_us",
              "rejections", "n_annealed", "seed", "nominal_batch",
              "frontier", "n_enumerated", "n_feasible"):
        assert tplan[k] == jplan[k], k
    assert any(p["point"].endswith("-memplan") for p in tplan["frontier"])
