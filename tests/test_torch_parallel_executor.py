"""The port's ParallelExecutor against the JAX package, in a gloo world
of 4 CPU processes (dp 4; the sequence-parallel LM on dp 2 x sp 2, sp 4
and tp 2 x sp 2 in the same world).

The references follow the JAX suite's own pins: where it holds its
ParallelExecutor equal to one device (the AllReduce and Reduce modes,
tests/test_parallel.py, test_parallel_models.py, test_uneven_batch.py),
the reference is the JAX package's one-device Executor; the explicit
modes (ReduceScatter on a float32, bfloat16 or int8 wire with error
feedback) are held to the JAX ParallelExecutor in the same mode over 4
virtual devices. Both start from the JAX startup program's parameters.

One world per file (a module-scoped fixture over
`paddle_tpu_torch.distributed.launch`, file store under tmp_path, 120 s
collective timeout) runs every scenario. Tolerances: float32 paths 1e-5
relative (atol 1e-6), the bf16 and int8 wires too (both packages
quantize alike); the conv / batch-norm net 5e-3, the JAX suite's own.
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
NETS = ("fc", "conv_bn", "masked")
WIRES = ("", "bf16", "int8")
# ops that mix rows along the split batch dim (each was refused, or
# silently computed on the rank's own rows, before the gather rule)
FAULTS = ("gram", "softmax0", "cumsum0", "argsort0", "auc", "prec",
          "prod0", "max0")
SP_MESHES = {"dp2sp2": {"dp": 2, "sp": 2}, "sp4": {"sp": 4},
             "tp2sp2": {"tp": 2, "sp": 2}}
SP_MODES = ("AllReduce", "Reduce")
SP_LR = 0.5
SP_GRADS = ("tok_emb@GRAD", "l0_attn_q.w_0@GRAD", "l1_ffn_fc2.w_0@GRAD",
            "l1_ln2.scale@GRAD", "lm_head.w_0@GRAD")


# ---------------------------------------------------------------------------
# programs, built the same way in both packages
# ---------------------------------------------------------------------------


def _net(pkg, kind, opt="momentum"):
    L = pkg.layers
    if kind == "conv_bn":
        x = L.data("img", shape=[1, 8, 8])
        h = L.conv2d(x, num_filters=4, filter_size=3, padding=1, act="relu")
        h = L.batch_norm(h)
        h = L.pool2d(h, pool_size=2, pool_stride=2)
    else:
        x = L.data("img", shape=[16])
        h = L.fc(x, size=32, act="relu")
    label = L.data("label", shape=[1], dtype="int64")
    logits = L.fc(h, size=10)
    per_ex = L.softmax_with_cross_entropy(logits, label)
    if kind == "masked":
        m = L.reshape(L.batch_row_mask(), shape=[-1, 1])
        loss = L.reduce_sum(per_ex * m) / L.reduce_sum(m)
    elif kind == "sum":
        loss = L.reduce_sum(per_ex)
    else:
        loss = L.mean(per_ex)
    if opt is None:
        pass
    elif opt == "sgd":
        pkg.optimizer.SGDOptimizer(learning_rate=0.1).minimize(loss)
    elif opt == "adam":
        pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    else:
        pkg.optimizer.MomentumOptimizer(learning_rate=0.05,
                                        momentum=0.9).minimize(loss)
    return loss, logits


def _metrics(pkg, logits, label_name="label"):
    """Batch-spanning fetches beside the loss: accuracy, the largest
    logit and the mean logit (forward only: built after minimize)."""
    L = pkg.layers
    label = pkg.default_main_program().global_block().var(label_name)
    acc = L.accuracy(input=L.softmax(logits), label=label)
    return [acc, L.reduce_max(logits), L.reduce_mean(logits, dim=0)]


def _opt(kind):
    return "sgd" if kind == "masked" else "momentum"


def _raw(pkg, type_, inputs, outs, attrs):
    """Append a registered op with no layer of its own."""
    h = pkg.layer_helper.LayerHelper(type_)
    o = {slot: [h.create_tmp_variable(dtype=dt, shape=sh) for dt, sh in v]
         for slot, v in outs.items()}
    h.append_op(type=type_, inputs=inputs, outputs=o, attrs=attrs)
    return o


def _fault_net(pkg, case):
    """fc(img[16], size=4) and one op that mixes the batch rows; SGD at
    learning rate 0. Returns (the op's output, the loss)."""
    L = pkg.layers
    x = L.data("img", shape=[16])
    label = L.data("label", shape=[1], dtype="int64")
    logits = L.fc(x, size=4)
    if case == "gram":
        y = L.matmul(logits, logits, transpose_x=True)
    elif case == "softmax0":
        y = L.softmax(logits, axis=0)
    elif case == "cumsum0":
        y = _raw(pkg, "cumsum", {"X": [logits]},
                 {"Out": [("float32", [-1, 4])]}, {"axis": 0})["Out"][0]
    elif case == "argsort0":
        o = _raw(pkg, "argsort", {"X": [logits]},
                 {"Out": [("float32", [-1, 4])],
                  "Indices": [("int64", [-1, 4])]}, {"axis": 0})
        y = L.elementwise_mul(o["Out"][0], L.cast(o["Indices"][0],
                                                  "float32"))
    elif case == "auc":
        y = L.auc(input=L.softmax(logits), label=label)[0]
    elif case == "prec":
        probs = L.softmax(logits)
        idx = L.reshape(L.argmax(probs, axis=1), shape=[-1, 1])
        y = _raw(pkg, "precision_recall",
                 {"MaxProbs": [L.reduce_max(probs, dim=1, keep_dim=True)],
                  "Indices": [idx], "Labels": [label]},
                 {"BatchMetrics": [("float32", [6])],
                  "AccumMetrics": [("float32", [6])],
                  "AccumStatesInfo": [("float32", [4, 4])]},
                 {"class_number": 4})["BatchMetrics"][0]
    elif case == "prod0":
        y = L.reduce_prod(L.sigmoid(logits), dim=0)
    else:
        y = L.reduce_max(logits, dim=0)
    loss = L.mean(logits) if case in ("auc", "prec") else L.mean(y)
    pkg.optimizer.SGDOptimizer(learning_rate=0.0).minimize(loss)
    return y, loss


def _fault_feed():
    rng = np.random.RandomState(6)
    return {"img": rng.rand(16, 16).astype("float32"),
            "label": rng.randint(0, 4, (16, 1)).astype("int64")}


def _sp_lm(pkg, annotate=False):
    """The LM at test width (2 layers, d_model 32, T 16) with SGD (built
    with the use_bf16_matmul flag off: float32 matmuls in both
    packages)."""
    loss, logits = pkg.models.transformer.transformer_lm(
        vocab=50, max_len=16, d_model=32, d_inner=64, num_heads=4,
        num_layers=2, dropout=0.0)
    if annotate:
        assert pkg.parallel.annotate_tp()
    pkg.optimizer.SGDOptimizer(learning_rate=SP_LR).minimize(loss)
    return loss, logits


def _sp_feeds(steps=2):
    rng = np.random.RandomState(7)
    return [{"tokens": rng.randint(0, 50, (4, 16)).astype("int64"),
             "tokens@SEQLEN": np.array([16, 11, 7, 14], "int32"),
             "targets": rng.randint(0, 50, (4, 16)).astype("int64")}
            for _ in range(steps)]


def _feeds(kind, steps=STEPS):
    rng = np.random.RandomState({"fc": 1, "conv_bn": 2, "masked": 3,
                                 "rs": 4, "trainer": 5}[kind])
    b = {"fc": 16, "conv_bn": 8, "masked": 5, "rs": 16, "trainer": 8}[kind]
    shape = (b, 1, 8, 8) if kind == "conv_bn" else (b, 16)
    return [{"img": rng.rand(*shape).astype("float32"),
             "label": rng.randint(0, 10, (b, 1)).astype("int64")}
            for _ in range(steps)]


def _params(scope, program):
    return {v.name: np.asarray(scope.get(v.name)).copy()
            for v in program.global_block().vars.values()
            if v.persistable and scope.has_var(v.name)
            and not v.name.startswith(("dp_comm_err", "@"))}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------


def _port_setup(kind, init, opt=None):
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        loss, logits = _net(ptt, "fc" if kind == "rs" else kind,
                            opt or _opt(kind))
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    ptt.io.load_numpy_params(init, place=ptt.CPUPlace())
    return loss, logits


def _spmd(rank, mesh, kind, mode, inits, out):
    from paddle_tpu_torch.parallel import (BuildStrategy, ParallelExecutor,
                                           ReduceStrategy)
    loss, logits = _port_setup(kind, inits[kind])
    rs = ReduceStrategy.AllReduce if mode == "allreduce" \
        else ReduceStrategy.Reduce
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                          build_strategy=BuildStrategy(reduce_strategy=rs))
    feeds = _feeds(kind)
    key = f"{kind}_{mode}_"
    if mode == "reduce" and kind == "fc":
        l, = pe.run_steps(feeds, fetch_list=[loss])
        out[key + "loss"] = np.asarray(l).ravel()
    else:
        ls, lg = [], None
        for f in feeds:
            l, lg = pe.run(fetch_list=[loss, logits], feed=f)
            ls.append(float(np.asarray(l).ravel()[0]))
        out[key + "loss"] = np.array(ls)
        out[key + "logits"] = lg
    prog = pe.prepare_program()
    for n, v in _params(ptt.global_scope(), prog).items():
        out[key + "p:" + n] = v
        place = pe.state_sharding(prog, n)
        out[key + "s:" + n] = np.array(json.dumps(list(place)))


def _explicit(rank, mesh, wire, inits, out):
    from paddle_tpu_torch.parallel import (BuildStrategy, ParallelExecutor,
                                           ReduceStrategy)
    loss, _ = _port_setup("rs", inits["rs"])
    bst = BuildStrategy(reduce_strategy=ReduceStrategy.ReduceScatter,
                        quant_comm=wire, comm_error_feedback=bool(wire),
                        quant_comm_block=64)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh,
                          build_strategy=bst)
    key = f"rs{wire}_"
    out[key + "loss"] = np.array(
        [float(np.asarray(pe.run(fetch_list=[loss], feed=f)[0]).ravel()[0])
         for f in _feeds("rs")])
    scope = ptt.global_scope()
    for n in scope.local_var_names():
        v = scope.get(n)
        if hasattr(v, "numpy"):
            out[key + "p:" + n] = v.numpy().copy()


def _global_fetches(rank, mesh, inits, out):
    from paddle_tpu_torch.parallel import ParallelExecutor
    loss, logits = _port_setup("fc", inits["fc"])
    mets = _metrics(ptt, logits)
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh)
    vals = pe.run(fetch_list=[loss] + mets, feed=_feeds("fc")[0])
    for i, v in enumerate(vals):
        out[f"metrics_{i}"] = np.asarray(v)
    # a metric whose state spans the batch: every rank's accumulators
    # update alike, over the gathered batch
    ptt.reset_default_programs()
    with ptt.unique_name.guard():
        loss, logits = _net(ptt, "fc", None)
        au = ptt.layers.auc(input=ptt.layers.softmax(logits),
                            label=ptt.default_main_program().global_block()
                            .var("label"))
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    ptt.io.load_numpy_params(inits["fc"], place=ptt.CPUPlace())
    pe = ParallelExecutor(use_cuda=False, loss_name=loss.name, mesh=mesh)
    out["auc"] = np.asarray(pe.run(fetch_list=[au[0]],
                                   feed=_feeds("fc")[0])[0])


def _faults(rank, mesh, inits, out):
    from paddle_tpu_torch.parallel import ParallelExecutor
    for case in FAULTS:
        ptt.reset_default_programs()
        ptt.reset_global_scope()
        with ptt.unique_name.guard():
            y, loss = _fault_net(ptt, case)
        ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
        ptt.io.load_numpy_params(inits["faults"], place=ptt.CPUPlace())
        pe = ParallelExecutor(use_cuda=False, loss_name=loss.name,
                              mesh=mesh)
        vals = pe.run(fetch_list=[y, loss, "fc_0.w_0@GRAD"],
                      feed=_fault_feed())
        for name, v in zip(("y", "loss", "grad"), vals):
            out[f"fault_{case}_{name}"] = np.asarray(v)


def _sp(rank, mesh, inits, out):
    """The LM under sequence parallelism, each mesh over the same world:
    losses and gradients (AllReduce: the fetched @GRAD; Reduce, where the
    fetched name is the rank's own pre-reduction part: the parameters'
    moves over the steps) and the gathered logits."""
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy)
    ptt.core.flags.set_flag("use_bf16_matmul", False)
    for mname, axes in SP_MESHES.items():
        sp_mesh = DeviceMesh(axes=axes)
        for mode in SP_MODES:
            key = f"sp_{mname}_{mode}_"
            ptt.reset_default_programs()
            ptt.reset_global_scope()
            with ptt.unique_name.guard():
                loss, logits = _sp_lm(ptt, annotate="tp" in axes)
            ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
            ptt.io.load_numpy_params(inits["sp"], place=ptt.CPUPlace())
            pe = ParallelExecutor(
                use_cuda=False, loss_name=loss.name, mesh=sp_mesh,
                build_strategy=BuildStrategy(
                    reduce_strategy=getattr(ReduceStrategy, mode),
                    enable_sequence_parallel=True))
            grads = list(SP_GRADS) if mode == "AllReduce" else []
            for s, f in enumerate(_sp_feeds()):
                vals = pe.run(fetch_list=[loss, logits] + grads, feed=f)
                out[key + f"loss{s}"] = np.asarray(vals[0])
                out[key + f"logits{s}"] = np.asarray(vals[1])
                for g, v in zip(grads, vals[2:]):
                    out[key + f"{g}{s}"] = np.asarray(v)
            if mode == "Reduce":
                from paddle_tpu_torch.io import _global_value
                for g in SP_GRADS:
                    p = g[:-len("@GRAD")]
                    out[key + "p:" + p] = np.asarray(
                        _global_value(ptt.global_scope(), p))


def _trainer(rank, mesh, inits, out):
    from paddle_tpu_torch.data import batch
    losses = []
    feeds = _feeds("trainer")

    def reader():
        for f in feeds:
            yield [(x, y) for x, y in zip(f["img"], f["label"])]

    def handler(ev):
        if isinstance(ev, ptt.trainer.EndStepEvent):
            losses.append(float(np.asarray(ev.metrics[0]).ravel()[0]))

    with ptt.unique_name.guard():
        tr = ptt.Trainer(lambda: _net(ptt, "fc", None)[0],
                         lambda: ptt.optimizer.MomentumOptimizer(
                             learning_rate=0.05, momentum=0.9),
                         place=ptt.CPUPlace(), parallel=True)
    ptt.io.load_numpy_params(inits["trainer"], scope=tr.scope,
                             place=ptt.CPUPlace())
    tr.train(num_epochs=1, event_handler=handler, reader=reader,
             feed_order=["img", "label"])
    out["trainer_loss"] = np.array(losses)
    for n, v in _params(tr.scope, tr.train_program).items():
        out["trainer_p:" + n] = v
    del batch


def _world(rank, world, outdir):
    from paddle_tpu_torch.parallel import DeviceMesh, set_default_mesh
    inits = {k: dict(v) for k, v in np.load(
        os.path.join(outdir, "inits.npz"), allow_pickle=True)[
            "inits"].item().items()}
    mesh = DeviceMesh(axes={"dp": WORLD})
    set_default_mesh(mesh)
    out, errors = {}, {}
    jobs = [(f"{k}_{m}", _spmd, (k, m)) for k in NETS
            for m in ("allreduce", "reduce")]
    jobs += [(f"rs{w}", _explicit, (w,)) for w in WIRES]
    jobs += [("trainer", _trainer, ()), ("metrics", _global_fetches, ()),
             ("faults", _faults, ()), ("sp", _sp, ())]
    for name, fn, args in jobs:
        try:
            fn(rank, mesh, *args, inits, out)
        except Exception:
            errors[name] = traceback.format_exc()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"errors{rank}.json"), "w") as f:
        json.dump(errors, f)


# ---------------------------------------------------------------------------
# the JAX side
# ---------------------------------------------------------------------------


def _jax_build(kind, opt):
    import paddle_tpu as pt
    pt.reset_default_programs()
    pt.reset_global_scope()
    with pt.core.unique_name.guard():
        loss, logits = _net(pt, kind, opt)
    pt.Executor().run(pt.default_startup_program())
    return pt, loss, logits


def _jax_single(kind):
    pt, loss, logits = _jax_build(kind, _opt(kind))
    scope = pt.global_scope()
    init = _params(scope, pt.default_main_program())
    exe = pt.Executor()
    ls, lg = [], None
    for f in _feeds(kind):
        l, lg = exe.run(feed=f, fetch_list=[loss, logits])
        ls.append(float(np.asarray(l).ravel()[0]))
    return init, {"loss": np.array(ls), "logits": np.asarray(lg),
                  "params": _params(scope, pt.default_main_program())}


def _jax_metrics():
    pt, loss, logits = _jax_build("fc", _opt("fc"))
    mets = _metrics(pt, logits)
    return [np.asarray(v) for v in pt.Executor().run(
        feed=_feeds("fc")[0], fetch_list=[loss] + mets)]


def _jax_mesh(n=WORLD):
    import jax

    from paddle_tpu.parallel.mesh import DeviceMesh
    return DeviceMesh(jax.devices()[:n], {"dp": n})


def _jax_explicit(wire):
    from paddle_tpu.parallel import (BuildStrategy, ParallelExecutor,
                                     ReduceStrategy)
    pt, loss, _ = _jax_build("fc", "momentum")
    scope = pt.global_scope()
    init = _params(scope, pt.default_main_program())
    bst = BuildStrategy(reduce_strategy=ReduceStrategy.ReduceScatter,
                        quant_comm=wire, comm_error_feedback=bool(wire),
                        quant_comm_block=64)
    pe = ParallelExecutor(loss_name=loss.name, mesh=_jax_mesh(),
                          build_strategy=bst)
    ls = [float(np.asarray(pe.run(fetch_list=[loss], feed=f)[0]).ravel()[0])
          for f in _feeds("rs")]
    state = {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}
    return init, {"loss": np.array(ls), "state": state}


def _jax_trainer():
    from paddle_tpu.parallel import ParallelExecutor
    pt, loss, _ = _jax_build("fc", "momentum")
    scope = pt.global_scope()
    init = _params(scope, pt.default_main_program())
    pe = ParallelExecutor(loss_name=loss.name, mesh=_jax_mesh())
    ls = [float(np.asarray(pe.run(fetch_list=[loss], feed=f)[0]).ravel()[0])
          for f in _feeds("trainer")]
    return init, {"loss": np.array(ls),
                  "params": _params(scope, pt.default_main_program())}


def _jax_auc(init):
    import paddle_tpu as pt
    pt.reset_default_programs()
    pt.reset_global_scope()
    with pt.core.unique_name.guard():
        _, logits = _net(pt, "fc", None)
        au = pt.layers.auc(input=pt.layers.softmax(logits),
                           label=pt.default_main_program().global_block()
                           .var("label"))
    pt.Executor().run(pt.default_startup_program())
    for n, v in init.items():
        if pt.global_scope().has_var(n):
            pt.global_scope().set_var(n, v)
    return np.asarray(pt.Executor().run(feed=_feeds("fc")[0],
                                        fetch_list=[au[0]])[0])


def _jax_faults():
    """Each fault scenario on one JAX device, from one init."""
    import paddle_tpu as pt
    init, out = None, {}
    for case in FAULTS:
        pt.reset_default_programs()
        pt.reset_global_scope()
        with pt.core.unique_name.guard():
            y, loss = _fault_net(pt, case)
        pt.Executor().run(pt.default_startup_program())
        scope = pt.global_scope()
        if init is None:
            init = {n: np.asarray(scope.get(n))
                    for n in scope.local_var_names() if n.startswith("fc_0")}
        for n, v in init.items():
            scope.set_var(n, v)
        vals = pt.Executor().run(feed=_fault_feed(),
                                 fetch_list=[y, loss, "fc_0.w_0@GRAD"])
        out[case] = [np.asarray(v) for v in vals]
    return init, out


def _jax_sp_run(init, axes=None, mode="AllReduce"):
    """The sp LM's 2 steps on the JAX package: one device (axes None), or
    its ParallelExecutor with enable_sequence_parallel on a mesh of 4
    virtual devices."""
    import jax

    import paddle_tpu as pt
    from paddle_tpu.parallel import (BuildStrategy, ParallelExecutor,
                                     ReduceStrategy)
    from paddle_tpu.parallel.mesh import DeviceMesh
    pt.reset_default_programs()
    pt.reset_global_scope()
    with pt.core.unique_name.guard():
        loss, logits = _sp_lm(pt, annotate=bool(axes) and "tp" in axes)
    pt.Executor().run(pt.default_startup_program())
    scope = pt.global_scope()
    if init is None:
        init = _params(scope, pt.default_main_program())
    for n, v in init.items():
        scope.set_var(n, v)
    if axes is None:
        exe = pt.Executor()

        def run(f, fetch):
            return exe.run(feed=f, fetch_list=fetch)
    else:
        pe = ParallelExecutor(
            loss_name=loss.name, mesh=DeviceMesh(jax.devices()[:WORLD], axes),
            build_strategy=BuildStrategy(
                reduce_strategy=getattr(ReduceStrategy, mode),
                enable_sequence_parallel=True))

        def run(f, fetch):
            return pe.run(fetch_list=fetch, feed=f)
    out = {}
    for s, f in enumerate(_sp_feeds()):
        vals = run(f, [loss, logits] + list(SP_GRADS))
        out[f"loss{s}"] = np.asarray(vals[0])
        out[f"logits{s}"] = np.asarray(vals[1])
        for g, v in zip(SP_GRADS, vals[2:]):
            out[f"{g}{s}"] = np.asarray(v)
    for g in SP_GRADS:
        p = g[:-len("@GRAD")]
        out["p:" + p] = np.asarray(scope.get(p))
    return init, out


@pytest.fixture(scope="module")
def refs():
    from paddle_tpu.core import flags as jflags
    inits, out = {}, {}
    for k in NETS:
        inits[k], out[k] = _jax_single(k)
    for w in WIRES:
        inits["rs"], out["rs" + w] = _jax_explicit(w)
    inits["trainer"], out["trainer"] = _jax_trainer()
    out["metrics"] = _jax_metrics()
    out["auc"] = _jax_auc(inits["fc"])
    inits["faults"], out["faults"] = _jax_faults()
    saved = jflags.get_flag("use_bf16_matmul")
    jflags.set_flag("use_bf16_matmul", False)
    try:
        inits["sp"], out["sp"] = _jax_sp_run(None)
        # one JAX reference a mesh: its Reduce mode only shards the
        # optimizer state over dp, so its values are AllReduce's
        for mname, axes in SP_MESHES.items():
            out[f"sp_{mname}"] = _jax_sp_run(inits["sp"], axes)[1]
    finally:
        jflags.set_flag("use_bf16_matmul", saved)
    return inits, out


@pytest.fixture(scope="module")
def world(refs, tmp_path_factory):
    d = tmp_path_factory.mktemp("pe_world")
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


def _tol(kind):
    return dict(rtol=5e-3, atol=5e-4) if kind == "conv_bn" \
        else dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# AllReduce and Reduce (ZeRO-1): global-batch semantics = one device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["allreduce", "reduce"])
@pytest.mark.parametrize("kind", NETS)
def test_spmd_modes_match_one_jax_device(world, refs, kind, mode):
    ref = refs[1][kind]
    key = f"{kind}_{mode}_"
    r0 = _rank(world, 0, key[:-1])
    for r in range(WORLD):
        got = _rank(world, r, key[:-1])
        np.testing.assert_allclose(got[key + "loss"], ref["loss"],
                                   **_tol(kind))
        assert np.isfinite(got[key + "loss"]).all()
        if key + "logits" in got:
            # batch-led fetches come back whole, pad rows stripped
            assert got[key + "logits"].shape == ref["logits"].shape
            np.testing.assert_allclose(got[key + "logits"], ref["logits"],
                                       **_tol(kind))
        for n, want in ref["params"].items():
            place = json.loads(str(got[key + "s:" + n]))
            p = got[key + "p:" + n]
            if place and place[0] == "dp":
                # a ZeRO-1 accumulator: this rank's rows of dim 0
                c = want.shape[0] // WORLD
                want = want[r * c:(r + 1) * c]
                assert mode == "reduce" and "velocity" in n
            else:
                # replicated state is bitwise equal on every rank
                np.testing.assert_array_equal(p, r0[key + "p:" + n])
            np.testing.assert_allclose(p, want, **_tol(kind), err_msg=n)
    if mode == "reduce" and _opt(kind) == "momentum":
        # the velocities of dp-divisible parameters live split on dim 0
        assert any(json.loads(str(v)) == ["dp", None] or
                   json.loads(str(v)) == ["dp"]
                   for k, v in r0.items() if k.startswith(key + "s:"))


def test_padded_batch_gives_no_nan_on_an_all_padding_rank(world, refs):
    """5 rows over 4 ranks: padded to 8, rank 3 holds two wrapped rows
    with mask 0; the loss is the JAX one-device loss on the 5 rows."""
    assert _feeds("masked")[0]["img"].shape[0] == 5
    got = _rank(world, 3, "masked_allreduce")
    assert np.isfinite(got["masked_allreduce_loss"]).all()
    np.testing.assert_allclose(got["masked_allreduce_loss"],
                               refs[1]["masked"]["loss"], rtol=1e-5)
    assert got["masked_allreduce_logits"].shape == (5, 10)


def test_batch_spanning_fetches_are_the_global_batchs(world, refs):
    """accuracy, reduce_max and a reduce_mean over dim 0 on 16 rows over 4
    ranks give the one-device values of the whole batch; so does `auc`,
    whose state spans the batch (its input gathered over dp)."""
    for r in range(WORLD):
        got = _rank(world, r, "metrics")
        for i, want in enumerate(refs[1]["metrics"]):
            np.testing.assert_allclose(got[f"metrics_{i}"], want,
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["auc"], refs[1]["auc"], rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# ops that mix the split rows: the gather rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", FAULTS)
def test_ops_that_mix_the_batch_rows_match_one_jax_device(world, refs,
                                                         case):
    """Each op over the dp-4 batch against the JAX one-device value at
    1e-5, forward and gradient: the Gram matrix contracting the batch,
    softmax / cumsum / argsort along it, auc and precision_recall over
    it, reduce_prod over it and reduce_max over it under a gradient."""
    want = refs[1]["faults"][case]
    for r in range(WORLD):
        got = _rank(world, r, "faults")
        for name, w in zip(("y", "loss", "grad"), want):
            g = got[f"fault_{case}_{name}"]
            assert g.shape == w.shape, (name, g.shape, w.shape)
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{case} {name}")


def test_every_registered_op_has_a_row_class():
    """An op added later cannot default either way: every op of the
    port's registry (both parallel packages' ops included) has a
    sharding-propagation rule, a cheap global form or a class in
    ROW_CLASS."""
    import paddle_tpu_torch.parallel  # noqa: F401
    from paddle_tpu_torch.framework.registry import lookup_shard_rule
    from paddle_tpu_torch.parallel.parallel_executor import (
        GLOBAL_BATCH_OPS, ROW_CLASS)
    ops = ptt.registered_ops()
    assert len(ops) >= 240
    missing = [t for t in ops if t not in ROW_CLASS
               and t not in GLOBAL_BATCH_OPS and lookup_shard_rule(t) is None]
    assert missing == []


# ---------------------------------------------------------------------------
# sequence parallelism: the LM on dp 2 x sp 2, sp 4 and tp 2 x sp 2
# ---------------------------------------------------------------------------


def _close(got, want, what):
    """1e-5 of the reference's largest entry."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=1e-5, atol=1e-5 * scale, err_msg=what)


@pytest.mark.parametrize("mode", SP_MODES)
@pytest.mark.parametrize("mesh", sorted(SP_MESHES))
def test_sequence_parallel_lm_matches_both_jax_references(world, refs,
                                                          mesh, mode):
    """Losses, the gathered [B, T, V] logits and the gradients of 2 SGD
    steps against the JAX ParallelExecutor with enable_sequence_parallel
    on the same mesh (AllReduce) and against the JAX one-device Executor,
    on every rank. In Reduce mode the gradients are read from the parameters'
    moves (the fetched @GRAD is the rank's pre-reduction part there)."""
    key = f"sp_{mesh}_{mode}_"
    for ref in (refs[1]["sp"], refs[1][f"sp_{mesh}"]):
        for r in range(WORLD):
            got = _rank(world, r, "sp")
            for s in range(2):
                _close(got[key + f"loss{s}"], ref[f"loss{s}"], "loss")
                _close(got[key + f"logits{s}"], ref[f"logits{s}"],
                       "logits")
                if mode == "AllReduce":
                    for g in SP_GRADS:
                        _close(got[key + f"{g}{s}"], ref[f"{g}{s}"], g)
            if mode == "Reduce":
                for g in SP_GRADS:
                    p = g[:-len("@GRAD")]
                    init = refs[0]["sp"][p]
                    _close((init - got[key + "p:" + p]) / SP_LR,
                           (init - ref["p:" + p]) / SP_LR, p)


# ---------------------------------------------------------------------------
# the explicit modes, against the JAX ParallelExecutor in the same mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", WIRES, ids=["fp32", "bf16", "int8"])
def test_reduce_scatter_matches_the_jax_explicit_mode(world, refs, wire):
    """Every wire at 1e-5 relative (atol 1e-6): the two packages quantize
    the same per-rank gradients with the same rule (blocks of 64, so the
    dp-divisible parameters take the sharded path), and the largest
    differences seen are 1.2e-7 (bf16) and 6.8e-8 (int8). A value within
    float32 rounding of a bfloat16 / int8 rounding boundary could flip to
    the next wire step (|g| 2^-8, or max|g|/127 of its block); these
    batches hold none."""
    ref = refs[1]["rs" + wire]
    key = f"rs{wire}_"
    tol = dict(rtol=1e-5, atol=1e-6)
    r0 = _rank(world, 0, key[:-1])
    for r in range(WORLD):
        got = _rank(world, r, key[:-1])
        np.testing.assert_allclose(got[key + "loss"], ref["loss"],
                                   rtol=1e-5)
        for n, want in ref["state"].items():
            p = got[key + "p:" + n]
            if n.startswith("dp_comm_err") or "velocity" in n and \
                    p.shape != want.shape:
                # per-rank rows: the residuals, the ZeRO-1 accumulators
                c = want.shape[0] // WORLD
                want = want[r * c:(r + 1) * c]
            elif not n.startswith("dp_comm_err"):
                np.testing.assert_array_equal(p, r0[key + "p:" + n])
            np.testing.assert_allclose(p, want, **tol, err_msg=n)
    if wire:
        assert any(k.startswith(key + "p:dp_comm_err") for k in r0)


# ---------------------------------------------------------------------------
# Trainer(parallel=True)
# ---------------------------------------------------------------------------


def test_parallel_trainer_matches_the_jax_parallel_executor(world, refs):
    """The JAX Trainer(parallel=True) calls DeviceMesh.default_data_
    parallel(), which its mesh module does not define; the reference is
    the JAX ParallelExecutor the Trainer means, on the same program."""
    ref = refs[1]["trainer"]
    for r in range(WORLD):
        got = _rank(world, r, "trainer")
        np.testing.assert_allclose(got["trainer_loss"], ref["loss"],
                                   rtol=1e-5, atol=1e-6)
        for n, want in ref["params"].items():
            np.testing.assert_allclose(got["trainer_p:" + n], want,
                                       rtol=1e-5, atol=1e-6, err_msg=n)


# ---------------------------------------------------------------------------
# the refusals (no world needed: they raise before the step)
# ---------------------------------------------------------------------------


def _both_raise(kind, mode, feed, fetch="loss", match="", sp=False):
    import paddle_tpu as pt
    from paddle_tpu.parallel import BuildStrategy as JBS
    from paddle_tpu.parallel import ParallelExecutor as JPE
    from paddle_tpu.parallel import ReduceStrategy as JRS
    from paddle_tpu_torch.parallel import BuildStrategy, DeviceMesh
    from paddle_tpu_torch.parallel import ParallelExecutor as TPE
    from paddle_tpu_torch.parallel import ReduceStrategy
    errs = []
    for pkg in (pt, ptt):
        pkg.reset_default_programs()
        pkg.reset_global_scope()
        if pkg is pt:
            with pt.core.unique_name.guard():
                loss, logits = _net(pt, kind, "sgd")
            pt.Executor().run(pt.default_startup_program())
            pe = JPE(loss_name=loss.name, mesh=_jax_mesh(),
                     build_strategy=JBS(
                         reduce_strategy=getattr(JRS, mode),
                         enable_sequence_parallel=sp))
        else:
            with ptt.unique_name.guard():
                loss, logits = _net(ptt, kind, "sgd")
            ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
            pe = TPE(use_cuda=False, loss_name=loss.name,
                     mesh=DeviceMesh(ranks=range(WORLD),
                                     axes={"dp": WORLD}),
                     build_strategy=BuildStrategy(
                         reduce_strategy=getattr(ReduceStrategy, mode),
                         enable_sequence_parallel=sp))
        fetches = [loss] if fetch == "loss" else [
            loss, pkg.layers.reduce_sum(logits)]
        with pytest.raises(Exception, match=match) as e:
            pe.run(fetch_list=fetches, feed=feed)
        errs.append(type(e.value).__name__)
    assert errs[0] == errs[1] == "InvalidArgumentError"


@pytest.mark.parametrize("case", ["uneven_without_mask", "sum_loss",
                                  "batch_norm", "indivisible", "sum_fetch",
                                  "sequence_parallel"])
def test_refusals_are_the_jax_packages(case):
    rs = "ReduceScatter"
    feed5 = _feeds("fc", 1)[0]
    feed5 = {k: v[:5] for k, v in feed5.items()}
    if case == "uneven_without_mask":
        _both_raise("fc", "AllReduce", feed5, match="batch_row_mask")
    elif case == "sum_loss":
        _both_raise("sum", rs, _feeds("fc", 1)[0], match="MEAN-reduced")
    elif case == "batch_norm":
        _both_raise("conv_bn", rs, _feeds("conv_bn", 1)[0],
                    match="batch_norm")
    elif case == "indivisible":
        _both_raise("fc", rs, feed5, match="divisible")
    elif case == "sequence_parallel":
        _both_raise("fc", rs, _feeds("fc", 1)[0], match="sequence",
                    sp=True)
    else:
        _both_raise("fc", rs, _feeds("fc", 1)[0], fetch="sum",
                    match="sum reduction")


@pytest.mark.parametrize("mode", ["AllReduce", "Reduce", "ReduceScatter"])
def test_a_mesh_with_no_world_refuses_to_train(mode):
    """A dp-4 mesh built before any world was joined has no peers: the
    step raises at its first collective instead of training on rank 0's
    quarter of the batch and dividing by 4."""
    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        loss, _ = _net(ptt, "fc", "sgd")
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    before = _params(ptt.global_scope(), ptt.default_main_program())
    pe = ParallelExecutor(
        use_cuda=False, loss_name=loss.name,
        mesh=DeviceMesh(ranks=range(WORLD), axes={"dp": WORLD}),
        build_strategy=BuildStrategy(
            reduce_strategy=getattr(ReduceStrategy, mode)))
    with pytest.raises(InvalidArgumentError, match="no world was joined"):
        pe.run(fetch_list=[loss], feed=_feeds("fc", 1)[0])
    after = _params(ptt.global_scope(), ptt.default_main_program())
    for n, v in before.items():
        np.testing.assert_array_equal(after[n], v, err_msg=n)
