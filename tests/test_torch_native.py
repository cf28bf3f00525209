"""The native programs `ptpu_predict` and `ptpu_train` (csrc/native/,
built by `paddle_tpu_torch.native` with g++ against the installed torch;
no CUDA in the CPU suite, so the `ptpu::` ops have no implementation and
every archive is a CPU one) against the JAX package, no Python in their
processes (≙ tests/test_native_predict.py and test_native_train.py, whose
programs run StableHLO through TensorFlow's C API).

The build is not skipped when it fails: g++ and torch's headers are
installed wherever the CPU suite runs. Feeds keep int64 where the JAX tests save int32 (the port keeps
64-bit types). Tolerances as the JAX tests': logits at 1e-5, tokens
equal, losses at rtol 1e-5 and the final weights at 1e-5.
"""

import io
import json
import os
import subprocess
import threading
import zipfile

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags

import paddle_tpu_torch as ptt
from paddle_tpu_torch import kernel_ops, native
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.serving import PredictorClient

from test_torch_export import (_both, _conv, _gen_feeds, _port_scope,
                               generator_export)

CPU = ptt.CPUPlace()


@pytest.fixture(scope="module")
def progs():
    return native.build(cuda=False)


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


def _run(exe, *args):
    return subprocess.run([exe, *map(str, args)], capture_output=True,
                          text=True, timeout=600)


@pytest.fixture(scope="module")
def conv_model(tmp_path_factory):
    """tests/test_native_predict.py:38-53's conv net, exported by the port
    with native=True from the JAX package's startup weights; returns
    (dir, JAX executor's logits at a batch)."""
    with ptt.unique_name.guard():
        (jm, js, jout), (tm, _, tout) = _both(_conv)
    jscope = pt.Scope()
    pt.Executor().run(js, scope=jscope)
    d = str(tmp_path_factory.mktemp("conv") / "model")
    ptt.save_inference_model(d, ["img"], [tout], ptt.Executor(CPU),
                             main_program=tm, scope=_port_scope(jscope),
                             native=True)

    def jax_logits(x):
        return np.asarray(pt.Executor().run(jm, feed={"img": x},
                                            fetch_list=[jout],
                                            scope=jscope)[0])
    return d, jax_logits


@pytest.mark.parametrize("batch", [3, 7])
def test_cpp_logits_match_the_jax_package(conv_model, progs, tmp_path,
                                          batch):
    """One-shot runs at the batch the JAX test uses (3) and another (7):
    the symbolic batch survives into the archive the C++ process runs."""
    d, jax_logits = conv_model
    x = np.random.RandomState(batch).rand(batch, 8, 8, 1).astype("float32")
    np.save(tmp_path / "img.npy", x)
    r = _run(progs["ptpu_predict"], d, tmp_path / "img.npy", "--out",
             tmp_path, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-1500:]
    got = np.load(tmp_path / "out0.npy")
    assert got.shape == (batch, 10)
    np.testing.assert_allclose(got, jax_logits(x), rtol=1e-5, atol=1e-5)
    assert 'launches {"flash_fwd": 0' in r.stdout


def test_cpp_refuses_a_wrong_dtype_and_a_cuda_run(conv_model, progs,
                                                  tmp_path):
    d, _ = conv_model
    np.save(tmp_path / "bad.npy", np.zeros((2, 8, 8, 1), np.int32))
    r = _run(progs["ptpu_predict"], d, tmp_path / "bad.npy")
    assert r.returncode != 0 and "dtype" in r.stderr
    np.save(tmp_path / "ok.npy", np.zeros((2, 8, 8, 1), np.float32))
    r = _run(progs["ptpu_predict"], d, tmp_path / "ok.npy", "--device",
             "cuda")
    assert r.returncode != 0 and "no CUDA" in r.stderr


def test_cpp_refuses_a_foreign_schema_version(conv_model, progs, tmp_path):
    """The runner reads the archive schema of the torch it was built
    against and names both versions when an archive is not one it
    knows."""
    d, _ = conv_model
    bad = tmp_path / "bad"
    bad.mkdir()
    for f in os.listdir(d):
        if f != "__exported__.pt2":
            (bad / f).write_bytes(open(os.path.join(d, f), "rb").read())
    src = zipfile.ZipFile(os.path.join(d, "__exported__.pt2"))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as dst:
        for info in src.infolist():
            data = src.read(info.filename)
            if info.filename.endswith("models/model.json"):
                model = json.loads(data)
                model["schema_version"]["major"] = 99
                data = json.dumps(model).encode()
            dst.writestr(info, data)
    (bad / "__exported__.pt2").write_bytes(buf.getvalue())
    np.save(tmp_path / "x.npy", np.zeros((2, 8, 8, 1), np.float32))
    r = _run(progs["ptpu_predict"], bad, tmp_path / "x.npy")
    assert r.returncode != 0
    from torch._export.serde.schema import SCHEMA_VERSION
    assert "schema_version 99" in r.stderr
    assert f"({SCHEMA_VERSION[0]}.{SCHEMA_VERSION[1]})" in r.stderr


@pytest.fixture()
def cpp_server(conv_model, progs):
    d, jax_logits = conv_model
    proc = subprocess.Popen([progs["ptpu_predict"], d, "--serve", "0",
                             "--device", "cpu"], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("LISTENING "):
            proc.kill()
            proc.wait(timeout=30)
            pytest.fail(f"server failed to start: {line!r}\n"
                        f"{proc.stderr.read()[-800:]}")
        yield "127.0.0.1", int(line.split()[1]), jax_logits
    finally:
        proc.kill()
        proc.wait(timeout=30)


def test_served_pipelined_and_concurrent_connections(cpp_server):
    """serving/transport.py's protocol unchanged: one client pipelines 6
    requests before it reads, two more call concurrently; answers in
    request order, equal to the JAX package's logits."""
    host, port, jax_logits = cpp_server
    r = np.random.RandomState(1)
    xs = [r.rand(2 + i % 3, 8, 8, 1).astype(np.float32) for i in range(6)]
    outs, others = [], []

    def other(x):
        with PredictorClient(host, port) as c:
            others.append((x, c.infer({"img": x})[0]))

    with PredictorClient(host, port) as c1:
        for x in xs:
            c1.send({"img": x})
        threads = [threading.Thread(target=other, args=(xs[i],))
                   for i in (0, 5)]
        for t in threads:
            t.start()
        outs = [c1.recv()[0] for _ in xs]
        for t in threads:
            t.join(timeout=120)
    for x, o in list(zip(xs, outs)) + others:
        np.testing.assert_allclose(o, jax_logits(x), rtol=1e-5, atol=1e-5)
    assert len(others) == 2


def test_per_request_errors_keep_the_connection(cpp_server):
    host, port, jax_logits = cpp_server
    x = np.random.RandomState(2).rand(2, 8, 8, 1).astype(np.float32)
    with PredictorClient(host, port) as c:
        with pytest.raises(RuntimeError, match="dtype"):
            c.infer({"img": x.astype(np.float64)})
        with pytest.raises(RuntimeError, match="missing feed"):
            c.infer({"wrong_name": x})
        with pytest.raises(RuntimeError, match="unknown fetch"):
            c.infer({"img": x}, fetch=["nope"])
        out = c.infer({"img": x})[0]
    np.testing.assert_allclose(out, jax_logits(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("gen", ["lm", "nmt"])
def test_cpp_beam_generation_equals_the_jax_executors(gen, progs, tmp_path,
                                                      tmp_path_factory):
    """tests/test_native_predict.py:107-183's generators (the KV-cache
    beam decode, control-flow sub-blocks unrolled) from the C++ process at
    two batches: tokens equal to the JAX package's Python Executor.run.
    The archives are test_torch_export.py's (`generator_export`)."""
    d, want = generator_export(tmp_path_factory, gen)
    for feed, w in zip(_gen_feeds(gen), want):
        paths = []
        for i, v in enumerate(feed.values()):
            paths.append(tmp_path / f"in{i}.npy")
            np.save(paths[-1], v)
        r = _run(progs["ptpu_predict"], d, *paths, "--out", tmp_path,
                 "--device", "cpu")
        assert r.returncode == 0, r.stderr[-1500:]
        got = np.load(tmp_path / "out0.npy")
        assert got.shape == w.shape
        np.testing.assert_array_equal(got, w)


def _train_model(pkg):
    """tests/test_native_train.py:35-48: fc-relu-fc, MSE, Momentum (a
    parameter and an accumulator to carry)."""
    L = pkg.layers
    x = L.data(name="x", shape=[8])
    y = L.data(name="y", shape=[1])
    h = L.fc(x, size=16, act="relu", name="nt_fc1")
    pred = L.fc(h, size=1, name="nt_fc2")
    loss = L.reduce_mean(L.square(pred - y))
    pkg.optimizer.MomentumOptimizer(learning_rate=0.05,
                                    momentum=0.9).minimize(loss)
    return loss


def test_cpp_trains_with_the_jax_executors_losses(progs, tmp_path, rng):
    """≙ tests/test_native_train.py:72-116: the exported step run 5 times
    by ptpu_train from the JAX startup state against 5 JAX Executor.run
    steps: losses at rtol 1e-5, the final nt_fc1.w_0 at 1e-5."""
    (jm, js, jloss), (tm, _, tloss) = _both(_train_model)
    jscope = pt.Scope()
    jexe = pt.Executor()
    jexe.run(js, scope=jscope)
    scope = _port_scope(jscope)
    d = str(tmp_path / "train_export")
    ptt.io.export_train_program(d, ["x", "y"], [tloss], main_program=tm,
                                scope=scope)
    xb = rng.rand(32, 8).astype("float32")
    w = np.random.RandomState(7).randn(8, 1).astype("float32")
    feed = {"x": xb, "y": (xb @ w).astype("float32")}
    steps = 5
    want = [float(np.asarray(jexe.run(jm, feed=feed, fetch_list=[jloss],
                                      scope=jscope)[0]).ravel()[0])
            for _ in range(steps)]
    np.save(tmp_path / "in_x.npy", feed["x"])
    np.save(tmp_path / "in_y.npy", feed["y"])
    r = _run(progs["ptpu_train"], d, tmp_path / "in_x.npy",
             tmp_path / "in_y.npy", "--steps", steps, "--out", tmp_path,
             "--device", "cpu")
    assert r.returncode == 0, r.stderr[-1500:]
    got = [float(ln.split()[3]) for ln in r.stdout.splitlines()
           if ln.startswith("step ")]
    assert len(got) == steps, r.stdout
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert got[-1] < got[0]
    lines = open(os.path.join(d, "__exported_train__.meta")).read() \
        .splitlines()
    ins = [ln.split()[1] for ln in lines if ln.startswith("in ")]
    final = np.load(tmp_path / f"state{ins.index('nt_fc1.w_0')}.npy")
    np.testing.assert_allclose(final, np.asarray(jscope.get("nt_fc1.w_0")),
                               rtol=1e-5, atol=1e-6)


def test_registered_schemas_are_kernel_ops_schemas(progs):
    """The C++ process registers the `ptpu::` schemas of
    kernel_ops.SCHEMAS (written into its build), as the Python process
    does."""
    r = _run(progs["ptpu_predict"], "--schemas")
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines() == list(
        kernel_ops.qualified_schemas().values())
