"""Tensor parallelism in the port against the JAX package: annotate_tp,
sharding propagation, tp_shard_pass, the wire-byte models, and the small
LM trained at tp 2 and dp 2 x tp 2 in a gloo world of 4 CPU processes.

As tests/test_ztp_exec.py pins the JAX tp path to one device, the
training reference is the JAX package's one-device Executor (float32
matmuls in both), from the JAX startup program's parameters; losses at
atol 1e-5 (the JAX suite's) and the parameters after 3 Adam steps at
atol 1e-5 too (Adam turns a float32 rounding difference of a gradient
near zero into a move of up to lr = 1e-3; the largest seen is 2.6e-6),
a tp-split parameter held block by block. One world per file (120 s
collective timeout); its tp-2 mesh is ranks [0, 1].
"""

import json
import os
import traceback

import numpy as np
import pytest

import paddle_tpu_torch as ptt

from tests.port_env import port_jax_compile_cache  # noqa: F401

WORLD = 4
VOCAB, T, D, HEADS, LAYERS = 64, 8, 32, 4, 2
MESHES = {"tp2": {"dp": 1, "tp": 2}, "dp2tp2": {"dp": 2, "tp": 2}}
MODES = ("ReduceScatter", "AllReduce")


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


def _build(pkg, opt=True):
    pkg.reset_default_programs()
    pkg.reset_global_scope()
    guard = (pkg.unique_name.guard() if pkg is ptt
             else pkg.core.unique_name.guard())
    with guard:
        loss, _ = pkg.models.transformer.transformer_lm(
            vocab=VOCAB, max_len=T, d_model=D, d_inner=2 * D,
            num_heads=HEADS, num_layers=LAYERS, mean_loss=True)
        if opt:
            pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def _feeds(n=3, bs=8):
    rng = np.random.RandomState(7)
    return [{"tokens": rng.randint(0, VOCAB, (bs, T)).astype("int64"),
             "tokens@SEQLEN": np.full((bs,), T, dtype="int32"),
             "targets": rng.randint(0, VOCAB, (bs, T)).astype("int64")}
            for _ in range(n)]


def _params(scope, program):
    return {v.name: np.asarray(scope.get(v.name)).copy()
            for v in program.global_block().vars.values()
            if getattr(v, "trainable", False) and scope.has_var(v.name)}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _train(rank, mesh, name, mode, init, out):
    from paddle_tpu_torch.parallel import (BuildStrategy, ParallelExecutor,
                                           ReduceStrategy, annotate_tp)
    if not mesh.in_mesh:
        return
    loss = _build(ptt)
    annotate_tp()
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    ptt.io.load_numpy_params(init, place=ptt.CPUPlace())
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                          build_strategy=BuildStrategy(
                              reduce_strategy=getattr(ReduceStrategy, mode)))
    key = f"{name}_{mode}_"
    out[key + "loss"] = np.array(
        [float(np.asarray(pe.run(fetch_list=[loss], feed=f)[0]).ravel()[0])
         for f in _feeds()])
    prog = pe.prepare_program()
    out[key + "tp_applied"] = np.array(bool(prog._tp_applied))
    for n, v in _params(ptt.global_scope(), prog).items():
        out[key + "p:" + n] = v
        out[key + "s:" + n] = np.array(json.dumps(
            list(pe.state_sharding(prog, n))))
    out[key + "coords"] = np.array(json.dumps(mesh.coords()))


def _world(rank, world, outdir):
    from paddle_tpu_torch.parallel import DeviceMesh
    ptt.flags.set_flag("use_bf16_matmul", False)
    init = dict(np.load(os.path.join(outdir, "init.npz")))
    meshes = {"tp2": DeviceMesh(ranks=[0, 1], axes=MESHES["tp2"]),
              "dp2tp2": DeviceMesh(axes=MESHES["dp2tp2"])}
    out, errors = {}, {}
    for name, mesh in meshes.items():
        for mode in MODES:
            try:
                _train(rank, mesh, name, mode, init, out)
            except Exception:
                errors[f"{name}_{mode}"] = traceback.format_exc()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"errors{rank}.json"), "w") as f:
        json.dump(errors, f)


@pytest.fixture(scope="module")
def baseline():
    import paddle_tpu as pt
    pt.core.flags.set_flag("use_bf16_matmul", False)
    try:
        loss = _build(pt)
        exe = pt.Executor()
        exe.run(pt.default_startup_program())
        scope = pt.global_scope()
        init = _params(scope, pt.default_main_program())
        init.update({v.name: np.asarray(scope.get(v.name)) for v in
                     pt.default_main_program().global_block().vars.values()
                     if v.persistable and scope.has_var(v.name)})
        losses = [float(exe.run(feed=f, fetch_list=[loss])[0])
                  for f in _feeds()]
        return init, np.array(losses), _params(scope,
                                               pt.default_main_program())
    finally:
        pt.core.flags.set_flag("use_bf16_matmul", True)


@pytest.fixture(scope="module")
def world(baseline, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_world")
    np.savez(os.path.join(d, "init.npz"), **baseline[0])
    ptt.distributed.launch(f"{os.path.abspath(__file__)}:_world", WORLD,
                           args=[str(d)], timeout_s=120, store_dir=str(d),
                           place="cpu")
    res, errs = [], []
    for r in range(WORLD):
        res.append(dict(np.load(os.path.join(d, f"rank{r}.npz"))))
        errs.append(json.load(open(os.path.join(d, f"errors{r}.json"))))
    return res, errs


# ---------------------------------------------------------------------------
# the program side (no world needed)
# ---------------------------------------------------------------------------


def _both(opt=True):
    import paddle_tpu as pt
    from paddle_tpu.parallel import annotate_tp as j_annotate
    from paddle_tpu_torch.parallel import annotate_tp as t_annotate
    jloss = _build(pt, opt)
    jprog = pt.default_main_program()
    ja = j_annotate(jprog)
    tloss = _build(ptt, opt)
    tprog = ptt.default_main_program()
    ta = t_annotate(tprog)
    return (jprog, ja, jloss), (tprog, ta, tloss)


def test_annotate_tp_and_propagation_equal_the_jax_packages():
    from paddle_tpu.framework.sharding import propagate_sharding as jprop
    from paddle_tpu_torch.framework.sharding import \
        propagate_sharding as tprop
    (jprog, ja, _), (tprog, ta, _) = _both()
    assert ta == ja and ta
    for size in (None, 2, 4):
        jr, tr = jprop(jprog, tp_size=size), tprop(tprog, tp_size=size)
        assert tr.specs == jr.specs
        assert tr.seeded == jr.seeded
        assert [str(d) for d in tr.diagnostics] == \
            [str(d) for d in jr.diagnostics]
        assert [vars(a) for a in tr.actions] == [vars(a) for a in jr.actions]
    assert ptt.analyze_program(tprog, tp_size=2) is not None


def test_tp_shard_pass_program_equals_the_jax_packages():
    from paddle_tpu.framework.passes import get_pass as jget
    from paddle_tpu_torch.framework.passes import get_pass as tget
    (jprog, _, _), (tprog, _, _) = _both()
    for tp in (2, 4):
        j = jget("tp_shard_pass", tp=tp)(jprog)
        t = tget("tp_shard_pass", tp=tp)(tprog)
        assert t.to_json() == j.to_json()
        assert (t._tp_applied, t._tp_size, t._tp_n_collectives) == \
            (j._tp_applied, j._tp_size, j._tp_n_collectives)
        assert {n: getattr(v, "tp_spec", None)
                for n, v in t.global_block().vars.items()} == \
            {n: getattr(v, "tp_spec", None)
             for n, v in j.global_block().vars.items()}


def test_wire_byte_models_equal_the_jax_packages():
    from paddle_tpu.framework.passes import get_pass as jget
    from paddle_tpu.framework.sharding import tp_analytic_wire_bytes as jtp
    from paddle_tpu.parallel import grad_comm as jgc
    from paddle_tpu_torch.framework.passes import get_pass as tget
    from paddle_tpu_torch.framework.sharding import \
        tp_analytic_wire_bytes as ttp
    from paddle_tpu_torch.parallel import grad_comm as tgc
    (jprog, _, _), (tprog, _, _) = _both()
    jt, tt = jget("tp_shard_pass", tp=2)(jprog), tget("tp_shard_pass",
                                                     tp=2)(tprog)
    for nb in (8, 16):
        assert ttp(tt, 2, nominal_batch=nb) == jtp(jt, 2, nominal_batch=nb)
    for dp in (2, 4):
        assert tgc.spmd_allreduce_wire_bytes(tprog, dp) == \
            jgc.spmd_allreduce_wire_bytes(jprog, dp)
        assert tgc.spmd_zero1_wire_bytes(tprog, dp) == \
            jgc.spmd_zero1_wire_bytes(jprog, dp)
        for quant, ef in (("", False), ("int8", True), ("bf16", False)):
            cfg = {"shard_update": True, "quant": quant, "block": 64,
                   "error_feedback": ef, "bucket_bytes": 4096}
            for src_j, src_t in ((jprog, tprog), (jt, tt)):
                j = jgc.comm_optimize_pass(src_j, dp, cfg)
                t = tgc.comm_optimize_pass(src_t, dp, cfg)
                assert t.to_json() == j.to_json()
                assert tgc.analytic_wire_bytes(t, dp) == \
                    jgc.analytic_wire_bytes(j, dp)
        assert tgc.explicit_comm_config(ptt.parallel.BuildStrategy(
            quant_comm="int8")) == jgc.explicit_comm_config(
            __import__("paddle_tpu").parallel.BuildStrategy(
                quant_comm="int8"))


# ---------------------------------------------------------------------------
# training at tp 2 and dp 2 x tp 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MESHES))
def test_tp_training_matches_one_jax_device(world, baseline, name, mode):
    _, base_loss, base_params = baseline
    res, errs = world
    axes = MESHES[name]
    n = axes["dp"] * axes["tp"]
    key = f"{name}_{mode}_"
    for r in range(n):
        assert f"{name}_{mode}" not in errs[r], errs[r][f"{name}_{mode}"]
        got = res[r]
        assert bool(got[key + "tp_applied"])
        np.testing.assert_allclose(got[key + "loss"], base_loss, rtol=0,
                                   atol=1e-5)
        coords = json.loads(str(got[key + "coords"]))
        split = 0
        for p, want in base_params.items():
            place = json.loads(str(got[key + "s:" + p]))
            for d, s in enumerate(place):
                if s == "tp":
                    c = want.shape[d] // axes["tp"]
                    want = np.take(want, range(coords["tp"] * c,
                                               (coords["tp"] + 1) * c), d)
                    split += 1
            np.testing.assert_allclose(got[key + "p:" + p], want,
                                       rtol=1e-5, atol=1e-5, err_msg=p)
        assert split >= 4 * LAYERS
