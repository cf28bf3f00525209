"""Export of the port (`io.export_inference_model`, `load_exported_model`,
`export_train_program`, `save_inference_model(export=True)`,
`Predictor.from_exported` / `ExportedPredictor`) against the JAX package.

Each program is built in both packages (equal JSON); the JAX scope's
values reach the port through `load_numpy_params`. The port's archives are
exported on the CPU (a torch.export graph fixes its device; a CUDA trace
holds the six kernels as `ptpu::` ops, checked below on fake CUDA
tensors) and loaded cold. Tolerances: the JAX package's own export
round trip (1e-5 relative, 1e-6 absolute) for the MLP, 1e-5 for the conv
net and the control-flow values, and equal tokens for the generators at
the JAX native tests' sizes (use_bf16_matmul off in both packages, as in
tests/test_torch_generate.py).

The generators' archives take ~20 s each to export and write on a CPU,
and ~13 s to load cold: the graph unrolls every decode step of every layer.
`generator_export` makes each once a test session, for this file and
tests/test_torch_native.py.
"""

import fcntl
import json
import os

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.layers import control_flow as jcf
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as ptt
from paddle_tpu_torch import kernel_ops
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import InvalidArgumentError, NotFoundError
from paddle_tpu_torch.fusion import decode_attention as tda
from paddle_tpu_torch.fusion import recurrent as trec
from paddle_tpu_torch.layers import control_flow as tcf
from paddle_tpu_torch.models import mnist as tmnist
from paddle_tpu_torch.models import transformer as ttr
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.serving import PredictorClient, PredictorServer

from tests.port_env import port_jax_compile_cache  # noqa: F401

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_state():
    saved = (jflags.get_flag("use_bf16_matmul"),
             tflags.get_flag("use_bf16_matmul"))
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    jflags.set_flag("use_bf16_matmul", saved[0])
    tflags.set_flag("use_bf16_matmul", saved[1])


def _both(build):
    """`build(pkg, module_of_pkg)` under each package's fresh default
    programs; returns ((jmain, jstart, jout), (tmain, tstart, tout)) with
    equal JSON."""
    out = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            res = build(pkg)
        out.append((main, start, res))
    (jm, js, _), (tm, ts, _) = out
    assert tm.to_json() == jm.to_json()
    assert ts.to_json() == js.to_json()
    return out


def _port_scope(jscope):
    return ptt.load_numpy_params(
        {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()},
        ptt.Scope(), CPU)


def test_mlp_exported_cold_load_matches_the_jax_export(tmp_path, rng):
    """tests/test_io.py:82-107's flow in both packages: train, save with
    export=True (batch 8 traced), reset everything, cold-load the archive
    and run batches 8 and 3 (a batch never traced)."""
    def build(pkg):
        mod = jmnist if pkg is pt else tmnist
        loss, _, logits = mod.mlp(hidden_sizes=(32,), class_num=10)
        pkg.optimizer.Adam(learning_rate=0.01).minimize(loss)
        return loss, logits

    (jm, js, (jloss, jlogits)), (tm, _, (_, tlogits)) = _both(build)
    jexe, jscope = pt.Executor(), pt.Scope()
    jexe.run(js, scope=jscope)
    x = rng.rand(64, 784).astype("float32")
    y = rng.randint(0, 10, (64, 1)).astype("int64")
    for _ in range(5):
        jexe.run(jm, feed={"img": x, "label": y}, fetch_list=[jloss],
                 scope=jscope)
    pt.save_inference_model(str(tmp_path / "jax"), ["img"], [jlogits], jexe,
                            main_program=jm, scope=jscope, export=True)
    texe = ptt.Executor(CPU)
    ptt.save_inference_model(str(tmp_path / "port"), ["img"], [tlogits],
                             texe, main_program=tm,
                             scope=_port_scope(jscope), export=True)
    assert (tmp_path / "port" / "__exported__.pt2").exists()
    meta = json.loads((tmp_path / "port" / "__exported__.json").read_text())
    assert meta["platforms"] == ["cpu"] and meta["feed_names"] == ["img"]

    ptt.reset_global_scope()
    ptt.reset_default_programs()
    cold = ptt.Predictor.from_exported(str(tmp_path / "port"), place=CPU)
    ref = pt.Predictor.from_exported(str(tmp_path / "jax"))
    assert cold.feed_names == ["img"]
    for b in (8, 3):
        out, = cold.run({"img": x[:b]})
        want, = ref.run({"img": x[:b]})
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _conv(pkg):
    L = pkg.layers
    img = L.data(name="img", shape=[8, 8, 1])
    conv = L.conv2d(img, num_filters=4, filter_size=3, padding=1,
                    data_format="NHWC")
    pool = L.pool2d(conv, pool_size=2, pool_type="max", pool_stride=2,
                    data_format="NHWC")
    flat = L.reshape(pool, shape=[-1, 4 * 4 * 4])
    return L.fc(flat, size=10, act="softmax")


def test_conv_net_export_matches_jax_and_keeps_the_error_contract(tmp_path):
    """tests/test_native_predict.py:38-53's conv net: the archive's
    outputs at batches 3 and 7 against the JAX executor's, and
    Predictor.run's errors (missing, extra feeds, unknown fetch names),
    and no archive for a device it was not exported on."""
    (jm, js, jout), (tm, _, tout) = _both(_conv)
    jscope = pt.Scope()
    pt.Executor().run(js, scope=jscope)
    d = str(tmp_path / "conv")
    ptt.save_inference_model(d, ["img"], [tout], ptt.Executor(CPU),
                             main_program=tm, scope=_port_scope(jscope),
                             native=True)
    meta = open(os.path.join(d, "__exported_native__.meta")).read()
    assert meta.splitlines()[0].startswith("version ")
    assert "in img float32 -1 8 8 1" in meta and "nout 1" in meta
    assert "archive cpu __exported__.pt2" in meta
    pred = ptt.Predictor.from_exported(d, place=CPU)
    r = np.random.RandomState(0)
    for b in (3, 7):
        x = r.rand(b, 8, 8, 1).astype("float32")
        want, = pt.Executor().run(jm, feed={"img": x}, fetch_list=[jout],
                                  scope=jscope)
        out, = pred.run({"img": x})
        np.testing.assert_allclose(out, np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    x = r.rand(2, 8, 8, 1).astype("float32")
    with pytest.raises(InvalidArgumentError, match="missing feeds"):
        pred.run({})
    with pytest.raises(InvalidArgumentError, match="unexpected feeds"):
        pred.run({"img": x, "other": x})
    with pytest.raises(InvalidArgumentError, match="unknown fetch"):
        pred.run({"img": x}, fetch_names=["nope"])
    assert pred.run({"img": x}, fetch_names=[tout.name])[0].shape == (2, 10)
    ptt.io.export_inference_model(d + "_cuda_named", ["img"], [tout.name],
                                  tm.clone(for_test=True),
                                  scope=_port_scope(jscope),
                                  platforms=["cpu"])
    with open(os.path.join(d + "_cuda_named", "__exported__.json")) as f:
        assert json.load(f)["archives"] == {"cpu": "__exported__.pt2"}
    with open(os.path.join(d, "__exported__.json")) as f:
        meta = json.load(f)
    meta["archives"], meta["platforms"] = {"cuda": "x.pt2"}, ["cuda"]
    with open(os.path.join(d, "__exported__.json"), "w") as f:
        json.dump(meta, f)
    with pytest.raises(NotFoundError, match="no archive for cpu"):
        ptt.io.load_exported_model(d, place=CPU)


def test_exported_predictor_serves_through_the_predictor_server(tmp_path,
                                                               rng):
    """≙ tests/test_serving.py:99-114: the cold-loaded predictor (a
    stateless call) behind PredictorServer."""
    img = ptt.layers.data(name="img2", shape=[16])
    logits = ptt.layers.fc(img, size=3, name="srv2_fc")
    exe = ptt.Executor(CPU)
    exe.run(ptt.default_startup_program())
    d = str(tmp_path / "srv2")
    ptt.io.save_inference_model(d, ["img2"], [logits], executor=exe,
                                export=True)
    ep = ptt.Predictor.from_exported(d, place=CPU)
    x = rng.rand(4, 16).astype("float32")
    ref, = ep.run({"img2": x})
    want, = exe.run(feed={"img2": x}, fetch_list=[logits])
    np.testing.assert_allclose(ref, want, rtol=1e-6)
    with PredictorServer(ep) as srv:
        host, port = srv.address
        with PredictorClient(host, port) as c:
            out, = c.infer({"img2": x})
            with pytest.raises(RuntimeError, match="missing feeds"):
                c.infer({"wrong": x})
            again, = c.infer({"img2": x[:2]})
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    np.testing.assert_allclose(again, ref[:2], rtol=1e-6)


GEN = {"lm": ("transformer_lm_generate",
              dict(vocab=50, max_gen=6, d_model=32, d_inner=64, num_heads=4,
                   num_layers=2, bos_id=1, beam_size=2)),
       "nmt": ("transformer_generate",
               dict(src_vocab=40, tgt_vocab=40, max_src_len=6, max_gen=5,
                    d_model=32, d_inner=64, num_heads=4, num_layers=2,
                    bos_id=0, eos_id=-1, beam_size=2))}


def _gen_feeds(gen):
    """The JAX native tests' feeds (tests/test_native_predict.py:132,167)
    and another batch; int64 prompts and sources (the port keeps 64-bit
    types, where the JAX test saves int32)."""
    if gen == "lm":
        return [{"prompt": np.full((3, 1), 1, "int64")},
                {"prompt": np.array([[1], [7], [30], [2], [11]], "int64")}]
    r = np.random.RandomState(4)
    return [{"src": r.randint(1, 40, (2, 6)).astype("int64"),
             "src@SEQLEN": np.full((2,), 6, "int32")},
            {"src": r.randint(1, 40, (4, 6)).astype("int64"),
             "src@SEQLEN": np.array([6, 2, 5, 1], "int32")}]


def generator_export(tmp_path_factory, gen):
    """The generator `gen` built in both packages, exported by the port
    (native=True) from the JAX package's startup weights, and the JAX
    package's Executor.run tokens for each of `_gen_feeds(gen)`:
    (directory, [tokens]). Made once a test session, in a directory the
    session's xdist workers share, under a lock: an export takes ~20 s
    on a CPU (tests/test_torch_native.py runs the same archives)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent          # the session's, above each worker's
    root = base / "ptt_generator_exports"
    root.mkdir(exist_ok=True)
    d = root / gen
    feeds = _gen_feeds(gen)
    with open(root / f"{gen}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "done").exists():
            fn, dims = GEN[gen]
            with ptt.unique_name.guard():
                (jm, js, (jseqs, _)), (tm, _, (tseqs, _)) = _both(
                    lambda pkg: getattr(jtr if pkg is pt else ttr, fn)(
                        **dims))
            jscope = pt.Scope()
            pt.Executor().run(js, scope=jscope)
            ptt.io.save_inference_model(
                str(d), list(feeds[0]), [tseqs], executor=ptt.Executor(CPU),
                main_program=tm, scope=_port_scope(jscope), native=True)
            for i, feed in enumerate(feeds):
                np.save(d / f"want{i}.npy", np.asarray(pt.Executor().run(
                    jm, feed=feed, fetch_list=[jseqs], scope=jscope)[0]))
            (d / "done").touch()
    return str(d), [np.load(d / f"want{i}.npy") for i in range(len(feeds))]


@pytest.mark.parametrize("gen", sorted(GEN))
def test_generation_exports_with_the_jax_executors_tokens(gen,
                                                         tmp_path_factory):
    """The KV-cache beam-search decode graphs (static_rnn unrolled, K4's
    chains fused) export with a symbolic batch; the cold-loaded archive's
    tokens equal the JAX package's Executor.run tokens at two batches."""
    d, want = generator_export(tmp_path_factory, gen)
    pred = ptt.Predictor.from_exported(d, place=CPU)
    for feed, w in zip(_gen_feeds(gen), want):
        got, = pred.run(feed)
        assert got.shape == (len(feed[list(feed)[0]]), GEN[gen][1]["max_gen"],
                             2)
        np.testing.assert_array_equal(got, w)


def _while_counter(pkg):
    """tests/test_torch_control_flow.py's While counting to a limit, the
    limit fed, beside a lazy_cond on a fed predicate."""
    L = pkg.layers
    cf = jcf if pkg is pt else tcf
    n = L.data(name="n", shape=[1], dtype="int64", append_batch_size=False)
    x = L.data(name="x", shape=[3])
    i = L.fill_constant([1], "int64", 0)
    total = L.fill_constant([1], "float32", 0.0)
    c = L.less_than(i, n)
    w = cf.While(c)
    with w.block():
        L.assign(L.elementwise_add(total, L.cast(i, "float32")),
                 output=total)
        L.assign(L.increment(i, value=1), output=i)
        L.less_than(i, n, cond=c)
    pred = L.less_than(n, L.fill_constant([1], "int64", 5))
    picked = cf.cond(pred, lambda: L.scale(x, scale=2.0),
                     lambda: L.elementwise_add(x, L.scale(x, scale=-3.0)))
    return [total, i, picked]


def test_while_and_lazy_cond_export_as_graph_control_flow(tmp_path):
    """`while` exports as one while_loop node and `lazy_cond` as one cond
    node (the JAX package's lax.while_loop / lax.cond): the archive takes
    the other branch and another trip count at run time, equal to the
    JAX package's values."""
    (jm, js, jout), (tm, _, tout) = _both(_while_counter)
    jscope = pt.Scope()
    pt.Executor().run(js, scope=jscope)
    d = str(tmp_path / "cf")
    names = [v.name for v in tout]
    ptt.io.export_inference_model(d, ["n", "x"], names,
                                  tm.clone(for_test=True),
                                  scope=ptt.Scope(), platforms=["cpu"])
    ep = torch.export.load(os.path.join(d, "__exported__.pt2"))
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("while_loop") == 1 and targets.count("cond") == 1
    pred = ptt.Predictor.from_exported(d, place=CPU)
    x = np.arange(6, dtype="float32").reshape(2, 3)
    for limit in (3, 10):
        feed = {"n": np.array([limit], "int64"), "x": x}
        want = pt.Executor().run(jm, feed=feed, fetch_list=jout,
                                 scope=jscope)
        for got, w in zip(pred.run(feed), want):
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-5)


def test_export_train_program_writes_the_jax_meta_lines(tmp_path):
    """tests/test_native_train.py:63-75: `in __seed__ int32` first, a
    `carry` per read-write state, an `init` file per state input."""
    x = ptt.layers.data(name="x", shape=[8])
    y = ptt.layers.data(name="y", shape=[1])
    h = ptt.layers.fc(x, size=16, act="relu", name="nt_fc1")
    pred = ptt.layers.fc(h, size=1, name="nt_fc2")
    loss = ptt.layers.reduce_mean(ptt.layers.square(pred - y))
    ptt.optimizer.MomentumOptimizer(learning_rate=0.05,
                                    momentum=0.9).minimize(loss)
    ptt.Executor(CPU).run(ptt.default_startup_program())
    d = str(tmp_path / "train_export")
    assert ptt.io.export_train_program(d, ["x", "y"], [loss]) == \
        [loss.name]
    assert os.path.exists(os.path.join(d, "__exported_train__.pt2"))
    lines = open(os.path.join(d, "__exported_train__.meta")).read() \
        .splitlines()
    ins = [ln.split()[1] for ln in lines if ln.startswith("in ")]
    assert ins[:3] == ["__seed__", "x", "y"]
    assert "in __seed__ int32" in lines and "nfetch 1" in lines
    assert "in x float32 -1 8" in lines
    carry = [ln for ln in lines if ln.startswith("carry ")]
    init = [ln.split() for ln in lines if ln.startswith("init ")]
    # 4 parameters and their velocities are carried; the learning rate
    # is read only
    assert len(carry) == 8 and len(init) == 9
    for _, idx, fname in init:
        assert os.path.exists(os.path.join(d, fname))
        assert fname == f"train_state_{idx}.npy"
    w = np.load(os.path.join(d, f"train_state_{ins.index('nt_fc1.w_0')}"
                                f".npy"))
    np.testing.assert_array_equal(
        w, ptt.global_scope().get("nt_fc1.w_0").numpy())


def _plain_and_op(name, r):
    """(outputs of the plain version on CPU tensors, outputs of
    `ptpu::name`'s fake implementation on the same shapes on the meta
    device) — normalised to tuples of tensors, absent outputs dropped."""
    f = torch.float32

    def t(*s, dtype=f):
        return torch.from_numpy(r.rand(*s)).to(dtype)

    if name.startswith("flash"):
        q, k, v, do = (t(2, 2, 5, 32) for _ in range(4))
        ids = torch.tensor([[0, 0, 1, 1, 1], [0, 1, 1, 1, 1]], dtype=torch.int32)
        o, lse = tfa.flash_fwd_plain(q, k, v, 0.2, True, ids, ids)
        delta = tfa.flash_delta(o, do)
        dq, dk, dv = tfa.flash_bwd_plain(q, k, v, o, lse, do, 0.2, True,
                                         ids, ids, delta)
        plain = {"flash_fwd": (o, lse), "flash_bwd_dq": (dq,),
                 "flash_bwd_dkv": (dk, dv)}[name]
        args = {"flash_fwd": (q, k, v, ids, ids, 0.2, True, True),
                "flash_bwd_dq": (q, k, v, do, lse, delta, ids, ids, 0.2,
                                 True),
                "flash_bwd_dkv": (q, k, v, do, lse, delta, ids, ids, 0.2,
                                  True)}[name]
    elif name == "decode_attention":
        q, kc, vc, bias = t(3, 2, 4, 16), t(3, 2, 9, 16), t(3, 2, 9, 16), \
            t(3, 2, 4, 9)
        plain = (tda.decode_attention_plain(q, kc, vc, bias, 0.5),)
        args = (q, kc, vc, bias, 0.5, None, None)
    elif name == "lstm_seq":
        x, h0, c0, w = t(3, 4, 20), t(3, 5), t(3, 5), t(5, 20)
        sl = torch.tensor([4, 0, 2])
        plain = trec.lstm_seq_plain(x, h0, c0, w, sl, True, True)
        args = (x, h0, c0, w, sl, True, True)
    else:
        x, h0, w = t(3, 4, 15), t(3, 5), t(5, 15)
        sl = torch.tensor([4, 0, 2])
        plain = trec.gru_seq_plain(x, h0, w, sl, False, True)
        args = (x, h0, w, sl, False, True)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    out = getattr(torch.ops.ptpu, name)(*meta)
    return tuple(plain), out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", sorted(kernel_ops.SCHEMAS))
def test_fake_implementations_give_the_plain_versions_shapes(name):
    plain, fake = _plain_and_op(name, np.random.RandomState(1))
    assert [(tuple(p.shape), p.dtype) for p in plain] == \
        [(tuple(f.shape), f.dtype) for f in fake]
    assert all(f.device.type == "meta" for f in fake)
    # an output the call does not want comes back empty
    if name == "flash_fwd":
        q = torch.empty(2, 2, 5, 32, device="meta")
        _, lse = torch.ops.ptpu.flash_fwd(q, q, q, None, None, 0.1, False,
                                          False)
        assert tuple(lse.shape) == (0,)


def test_schemas_are_registered_from_the_one_table():
    qualified = kernel_ops.qualified_schemas()
    assert sorted(qualified) == sorted(kernel_ops.SCHEMAS)
    for name, schema in kernel_ops.SCHEMAS.items():
        assert qualified[name] == "ptpu::" + schema


def test_a_cuda_trace_holds_each_kernel_as_one_op():
    """On CUDA tensors (fake ones: the CPU suite runs without a card) each
    wrapper records its kernel's `ptpu::` op as one node, and nothing of
    its plain version (no exp, no softmax, no sigmoid, no matmul of the
    recurrence)."""
    with FakeTensorMode():
        q = torch.empty(2, 4, 8, 32, device="cuda")
        q1 = torch.empty(2, 4, 1, 32, device="cuda")
        bias = torch.empty(2, 4, 1, 8, device="cuda")
        x4 = torch.empty(2, 5, 12, device="cuda")
        x3 = torch.empty(2, 5, 9, device="cuda")
        h = torch.empty(2, 3, device="cuda")
        w4 = torch.empty(3, 12, device="cuda")
        w3 = torch.empty(3, 9, device="cuda")
        sl = torch.empty(2, dtype=torch.int64, device="cuda")

    def step(q, q1, bias, x4, x3, h, w4, w3, sl):
        o = tfa.fused_attention(q, q, q, causal=True)
        o2, lse = tfa.flash_fwd_cuda(q, q, q, 0.1, True)
        grads = tfa.flash_bwd_cuda(q, q, q, o2, lse, o2, 0.1, True)
        return (o, grads, tda.decode_attention_cuda(q1, q, q, bias, 0.5),
                trec.lstm_seq_cuda(x4, h, h, w4, sl, False, True),
                trec.gru_seq_cuda(x3, h, w3, sl, True, False))

    graph = make_fx(step, tracing_mode="fake")(q, q1, bias, x4, x3, h, w4,
                                                w3, sl)
    targets = [str(n.target) for n in graph.graph.nodes
               if n.op == "call_function"]
    counts = {name: targets.count(f"ptpu.{name}.default")
              for name in kernel_ops.SCHEMAS}
    assert counts == {"flash_fwd": 2, "flash_bwd_dq": 1, "flash_bwd_dkv": 1,
                      "decode_attention": 1, "lstm_seq": 1, "gru_seq": 1}
    plain = [t for t in targets if any(
        w in t for w in ("exp", "softmax", "sigmoid", "tanh", "matmul",
                         "bmm", "mm."))]
    assert plain == []
