"""The single-card API of the ported modules against the JAX package:
`Executor.run_steps`, the batch-row mask, the reader layers, the
TruncatedNormal and Bilinear initializers, the pass manager
(`registered_passes`, `prune_pass`, `memory_optimize_pass`, `Analyzer`),
`fusion.fused_lstm_sequence` / `fused_gru_sequence`, `state_census`,
tracing's tags and `force_enable`, and the re-exports.

Small sizes (a two-layer MLP over batches of 8, H 8 recurrent cells).
Values of one program through both packages agree at 1e-5 (float32 in
another summation order); the port's run_steps against k calls of its own
`run` at 1e-6; random initializers in distribution.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.framework import passes as jpasses
from paddle_tpu.fusion import recurrent as jrec
from paddle_tpu.layers import io as jio
from paddle_tpu.observability import memory as jmem

import paddle_tpu_torch as ptt
from paddle_tpu_torch import fusion as tfusion
from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                           NotFoundError, UnavailableError)
from paddle_tpu_torch.framework.program import BATCH_ROW_MASK_NAME
from paddle_tpu_torch.layers import io as tio
from paddle_tpu_torch.observability import memory as tmem
from paddle_tpu_torch.observability import tracing as ttrace

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _net(pkg, masked=False):
    """tests/test_run_steps.py's net: two fc layers, Momentum."""
    L = pkg.layers
    x = L.data("x", shape=[6])
    y = L.data("y", shape=[1])
    h = L.fc(x, size=8, act="relu", name="rs_fc1")
    pred = L.fc(h, size=1, name="rs_fc2")
    err = L.square(pred - y)
    if masked:
        mask = L.unsqueeze(L.batch_row_mask(), axes=[1])
        loss = L.reduce_sum(err * mask) / L.reduce_sum(mask)
    else:
        loss = L.reduce_mean(err)
    pkg.optimizer.MomentumOptimizer(learning_rate=0.05,
                                    momentum=0.9).minimize(loss)
    return loss


def _build(pkg, **kw):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        loss = _net(pkg, **kw)
    return main, start, loss.name


def _feeds(k=6):
    w = np.random.RandomState(7).randn(6, 1).astype("float32")
    out = []
    for i in range(k):
        xb = np.random.RandomState(100 + i).rand(8, 6).astype("float32")
        out.append({"x": xb, "y": (xb @ w).astype("float32")})
    return out


def _pair(**kw):
    """The net in both packages, the port's scope loaded from the JAX
    startup's draws."""
    jmain, jstart, loss = _build(pt, **kw)
    tmain, _, tloss = _build(ptt, **kw)
    assert tloss == loss and tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    params = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    return (jmain, jscope, tmain, params, loss)


def _port_scope(params):
    return ptt.load_numpy_params(params, ptt.Scope(), CPU)


# ---- Executor.run_steps ------------------------------------------------------

def test_run_steps_matches_k_runs_and_the_jax_run_steps():
    jmain, jscope, tmain, params, loss = _pair()
    feeds = _feeds()
    exe = ptt.Executor(CPU)
    seq_scope = _port_scope(params)
    seq = [exe.run(tmain, feed=f, fetch_list=[loss, "rs_fc1.w_0"],
                   scope=seq_scope) for f in feeds]
    scope = _port_scope(params)
    curve, w_steps = ptt.Executor(CPU).run_steps(
        feeds, fetch_list=[loss, "rs_fc1.w_0"], program=tmain, scope=scope)
    assert curve.shape == (6,) and w_steps.shape == (6, 6, 8)
    np.testing.assert_allclose(curve, [s[0] for s in seq], rtol=1e-6)
    # a fetched parameter is each step's value, not the final one six times
    np.testing.assert_allclose(w_steps, np.stack([s[1] for s in seq]),
                               rtol=1e-6, atol=1e-7)
    for n in ("rs_fc1.w_0", "rs_fc2.w_1"):
        np.testing.assert_allclose(scope.get(n).numpy(),
                                   seq_scope.get(n).numpy(), rtol=1e-6)
    jcurve = pt.Executor().run_steps(feeds, fetch_list=[loss],
                                     program=jmain, scope=jscope)[0]
    np.testing.assert_allclose(curve, jcurve, rtol=1e-5)
    np.testing.assert_allclose(scope.get("rs_fc1.w_0").numpy(),
                               np.asarray(jscope.get("rs_fc1.w_0")),
                               rtol=1e-5, atol=1e-6)


def test_a_fetched_parameter_keeps_its_value_as_jax():
    """Executor.run returns a snapshot: the numpy array of a fetched
    parameter does not follow the next step's in-place update."""
    jmain, jscope, tmain, params, loss = _pair()
    exe = ptt.Executor(CPU)
    scope = _port_scope(params)
    feeds = _feeds(2)
    first = exe.run(tmain, feed=feeds[0], fetch_list=["rs_fc1.w_0"],
                    scope=scope)[0]
    kept = first.copy()
    exe.run(tmain, feed=feeds[1], fetch_list=[loss], scope=scope)
    np.testing.assert_array_equal(first, kept)
    jfirst = pt.Executor().run(jmain, feed=feeds[0],
                               fetch_list=["rs_fc1.w_0"], scope=jscope)[0]
    np.testing.assert_allclose(first, np.asarray(jfirst), rtol=1e-5,
                               atol=1e-6)


def test_run_steps_state_continues_and_returns_tensors():
    _, _, tmain, params, loss = _pair()
    scope = _port_scope(params)
    exe = ptt.Executor(CPU)
    feeds = _feeds(8)
    first = exe.run_steps(feeds[:4], fetch_list=[loss], program=tmain,
                          scope=scope)[0]
    second = exe.run_steps(feeds[4:], fetch_list=[loss], program=tmain,
                           scope=scope, return_numpy=False)[0]
    assert isinstance(second, torch.Tensor) and second.shape == (4,)
    assert float(second[-1]) < float(first[0])
    # one plan serves both calls
    assert len(exe._cache) == 1


def test_run_steps_rejects_mixed_signatures_and_no_feed():
    _, _, tmain, params, loss = _pair()
    exe = ptt.Executor(CPU)
    feeds = _feeds(2)
    feeds[1]["x"] = feeds[1]["x"][:4]
    with pytest.raises(InvalidArgumentError, match="signature"):
        exe.run_steps(feeds, fetch_list=[loss], program=tmain,
                      scope=_port_scope(params))
    with pytest.raises(InvalidArgumentError, match="at least one feed"):
        exe.run_steps([], fetch_list=[loss], program=tmain)


def test_run_steps_takes_staged_uint8_feeds():
    L = ptt.layers
    img = L.data(name="img", shape=[4, 4, 3], staging_dtype="uint8")
    label = L.data(name="label", shape=[1], dtype="int64")
    logits = L.fc(L.reshape(img, shape=[-1, 48]), size=3)
    loss = L.reduce_mean(L.softmax_with_cross_entropy(logits, label))
    ptt.optimizer.SGDOptimizer(learning_rate=0.5).minimize(loss)
    exe = ptt.Executor(CPU)
    exe.run(ptt.default_startup_program())
    rng = np.random.RandomState(0)
    feed = {"img": rng.randint(0, 256, (8, 4, 4, 3)).astype(np.uint8),
            "label": rng.randint(0, 3, (8, 1)).astype(np.int64)}
    curve = exe.run_steps([feed] * 5, fetch_list=[loss])[0]
    assert curve[-1] < curve[0]


# ---- the batch-row mask -------------------------------------------------------

def test_batch_row_mask_is_fed_all_ones_as_jax():
    jmain, jscope, tmain, params, loss = _pair(masked=True)
    assert BATCH_ROW_MASK_NAME in tmain.global_block().vars
    feeds = _feeds(3)
    exe = ptt.Executor(CPU)
    scope = _port_scope(params)
    got = [exe.run(tmain, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in feeds[:2]]
    got.append(exe.run_steps(feeds[2:], fetch_list=[loss], program=tmain,
                             scope=scope)[0][0])
    want = [pt.Executor().run(jmain, feed=f, fetch_list=[loss],
                              scope=jscope)[0] for f in feeds[:2]]
    want.append(pt.Executor().run_steps(feeds[2:], fetch_list=[loss],
                                        program=jmain,
                                        scope=jscope)[0][0])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # made once per batch length on the executor's device, then reused
    mask = exe._row_masks[8]
    exe.run(tmain, feed=feeds[0], fetch_list=[loss], scope=scope)
    assert exe._row_masks[8] is mask and list(exe._row_masks) == [8]
    assert mask.device.type == "cpu" and bool((mask == 1).all())


def test_a_fed_batch_row_mask_weights_the_rows():
    _, _, tmain, params, loss = _pair(masked=True)
    f = dict(_feeds(1)[0])
    half = dict(f, **{BATCH_ROW_MASK_NAME: np.float32([1] * 4 + [0] * 4)})
    top = {"x": f["x"][:4], "y": f["y"][:4]}
    exe = ptt.Executor(CPU)
    a = exe.run(tmain, feed=half, fetch_list=[loss],
                scope=_port_scope(params))[0]
    b = exe.run(tmain, feed=top, fetch_list=[loss],
                scope=_port_scope(params))[0]
    np.testing.assert_allclose(a, b, rtol=1e-6)


# ---- readers -------------------------------------------------------------------

def _samples(n=7):
    r = np.random.RandomState(3)
    return [(r.rand(6).astype("float32"), r.rand(1).astype("float32"))
            for _ in range(n)]


def _drain(reader):
    return [{k: np.asarray(v) for k, v in d.items()} for d in reader()]


def test_reader_decorators_match_jax():
    def rec():
        for x, y in _samples():
            yield {"x": x, "y": y}

    for drop_last in (True, False):
        got = _drain(tio.batch(rec, 3, drop_last=drop_last))
        want = _drain(jio.batch(rec, 3, drop_last=drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    def transform(s):
        return None if s["y"][0] < 0.2 else {"x": s["x"] * 2}

    made = []
    for io in (tio, jio):
        p = io.Preprocessor(rec)
        p.def_transform(transform)
        made.append([d["x"].tolist() for d in _drain(p())])
    assert made[0] == made[1] and 0 < len(made[0]) < 7
    # shuffle keeps the records, in another order
    assert sorted(d["x"].tolist() for d in _drain(tio.shuffle(rec, 4))) == \
        sorted(d["x"].tolist() for d in _drain(rec))


def test_py_reader_feeds_the_executor_as_direct_feeding():
    _, _, tmain, params, loss = _pair()
    data = _samples(16)

    def batches():
        for i in range(0, 16, 8):
            chunk = data[i:i + 8]
            yield [np.stack([c[0] for c in chunk]),
                   np.stack([c[1] for c in chunk])]

    reader = tio.PyReader(["x", "y"], capacity=2)
    reader.decorate_paddle_reader(batches).start()
    exe = ptt.Executor(CPU)
    scope = _port_scope(params)
    got = [exe.run(tmain, feed=f, fetch_list=[loss], scope=scope)[0]
           for f in reader]
    direct = _port_scope(params)
    want = [exe.run(tmain, feed=dict(zip(["x", "y"], b)), fetch_list=[loss],
                    scope=direct)[0] for b in batches()]
    assert len(got) == 2
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_py_reader_declares_its_vars_and_double_buffers_on_the_place():
    r = tio.py_reader(capacity=4, shapes=[[2, 3], [2, 1]],
                      dtypes=["float32", "int64"], names=["a", "b"],
                      place=CPU)
    block = ptt.default_main_program().global_block()
    assert tuple(block.vars["a"].shape) == (2, 3) and r.use_double_buffer
    src = [(np.full((2, 3), i, "float32"), np.full((2, 1), i, "int64"))
           for i in range(3)]
    r.decorate_sample_list_generator(lambda: iter(src)).start()
    out = list(r)
    assert [int(d["a"][0, 0]) for d in out] == [0, 1, 2]
    assert all(isinstance(d["b"], torch.Tensor) for d in out)
    # a reset epoch starts clean
    r.reset()
    r.decorate_sample_list_generator(lambda: iter(src[:1])).start()
    assert len(list(r)) == 1


def test_reader_errors_surface_and_recordio_waits():
    def broken():
        yield [np.zeros(1)]
        raise ValueError("bad record")

    r = tio.PyReader(["a"]).decorate_sample_list_generator(broken).start()
    with pytest.raises(ValueError, match="bad record"):
        list(r)
    with pytest.raises(UnavailableError, match="item 4"):
        tio.open_recordio_file("f", [[1]], ["float32"], ["a"])
    with pytest.raises(UnavailableError, match="item 4"):
        tio.open_files(["f"], [[1]], ["float32"], ["a"])


def test_double_buffer_defaults_to_the_card():
    def rec():
        yield {"a": np.zeros(2, "float32")}

    got = list(tio.double_buffer(rec, place=CPU)())
    assert isinstance(got[0]["a"], torch.Tensor)
    if not torch.cuda.is_available():
        with pytest.raises(UnavailableError):
            list(tio.double_buffer(rec)())


# ---- initializers ------------------------------------------------------------

def _init_programs(make):
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4, 6, 6])
            pkg.layers.conv2d_transpose(
                x, num_filters=4, filter_size=4, stride=2, bias_attr=False,
                param_attr=pkg.ParamAttr(name="w",
                                         initializer=make(pkg)))
        progs.append(start)
    return progs


def test_bilinear_initializer_matches_jax():
    jstart, tstart = _init_programs(lambda p: p.initializer.Bilinear())
    assert tstart.to_json() == jstart.to_json()
    jscope, tscope = pt.Scope(), ptt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    ptt.Executor(CPU).run(tstart, scope=tscope)
    np.testing.assert_array_equal(tscope.get("w").numpy(),
                                  np.asarray(jscope.get("w")))


def test_truncated_normal_initializer_matches_jax_in_distribution():
    jstart, tstart = _init_programs(
        lambda p: p.initializer.TruncatedNormal(loc=0.5, scale=0.2))
    assert tstart.to_json() == jstart.to_json()
    assert ptt.initializer.TruncatedNormalInitializer is \
        ptt.initializer.TruncatedNormal
    tscope = ptt.Scope()
    ptt.Executor(CPU).run(tstart, scope=tscope)
    w = tscope.get("w").numpy()
    assert w.shape == (4, 4, 4, 4)
    assert np.abs(w - 0.5).max() <= 2 * 0.2 + 1e-6
    assert abs(w.mean() - 0.5) < 0.05


# ---- passes ------------------------------------------------------------------

def test_prune_and_memory_optimize_passes_rewrite_as_jax():
    assert {"prune_pass", "memory_optimize_pass"} <= \
        set(ptt.registered_passes())
    jmain, _, tmain, _, loss = _pair()
    for name, attrs in (("prune_pass", {"targets": [loss]}),
                        ("memory_optimize_pass", {"level": 1})):
        j = jpasses.get_pass(name, **attrs).apply(jmain.clone())
        t = ptt.get_pass(name, **attrs)(tmain.clone())
        assert isinstance(ptt.get_pass(name, **attrs), ptt.Pass)
        assert t.to_json() == j.to_json(), name


def test_analyzer_runs_the_given_passes_and_its_default_waits():
    jmain, _, tmain, _, loss = _pair()
    t = ptt.Analyzer(passes=["memory_optimize_pass"],
                     memory_optimize_pass={"level": 1}).run(
        tmain.clone(), targets=[loss])
    j = jpasses.get_pass("memory_optimize_pass", level=1).apply(
        jpasses.get_pass("prune_pass", targets=[loss]).apply(jmain.clone()))
    assert t.to_json() == j.to_json()
    with pytest.raises(NotFoundError, match="item 4"):
        ptt.Analyzer().run(tmain.clone())


# ---- fused whole-sequence cells ---------------------------------------------

@pytest.mark.parametrize("kind", ["lstm", "gru"])
@pytest.mark.parametrize("reverse", [False, True])
def test_fused_sequence_entry_points_match_jax(kind, reverse):
    r = np.random.RandomState(1)
    g, b, t, h = (4 if kind == "lstm" else 3), 3, 5, 8
    a = {"x": (r.randn(b, t, g * h) * .3).astype("float32"),
         "h0": (r.randn(b, h) * .1).astype("float32"),
         "c0": (r.randn(b, h) * .1).astype("float32"),
         "w": (r.randn(h, g * h) * .1).astype("float32"),
         "seqlen": np.int32([5, 2, 0])}
    names = ("x", "h0", "c0", "w") if kind == "lstm" else ("x", "h0", "w")
    tfn = getattr(tfusion, f"fused_{kind}_sequence")
    jfn = getattr(jrec, f"fused_{kind}_sequence")
    got = tfn(*(torch.from_numpy(a[n]) for n in names),
              torch.from_numpy(a["seqlen"]), reverse=reverse)
    want = jfn(*(jnp.asarray(a[n]) for n in names), jnp.asarray(a["seqlen"]),
               reverse=reverse, backend="xla")
    for gv, wv in zip(got if kind == "lstm" else [got],
                      want if kind == "lstm" else [want]):
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                                   atol=1e-6)
    args = [torch.from_numpy(a[n]) for n in names] + \
        [torch.from_numpy(a["seqlen"])]
    for bad in ("pallas", "pallas_interpret", "xla", "cuda"):
        with pytest.raises(InvalidArgumentError, match="backend=None"):
            tfn(*args, backend=bad)


# ---- observability -----------------------------------------------------------

def test_state_census_matches_jax_categories():
    jmain, jscope, tmain, params, _ = _pair()
    names = sorted(params)
    scope = _port_scope(params)
    got = tmem.state_census(scope, tmain, names + ["absent"],
                            kv_names=["rs_fc2.w_1"])
    want = jmem.state_census(jscope, jmain, names + ["absent"],
                             kv_names=["rs_fc2.w_1"])
    assert got["categories"] == want["categories"]
    assert got["per_var"] == want["per_var"]
    assert got["categories"]["optimizer_state"] > 0


def test_scoped_tags_and_force_enable():
    mark = ttrace.mark()
    with ttrace.scoped_tags(world="w", rank=1):
        with ttrace.scoped_tags(rank=2):
            assert ttrace.current_tags() == {"world": "w", "rank": 2}
            with ttrace.span("step", "tagged", rank=5):
                pass
            ttrace.record_span("request", "retro", 0.0, 1.0)
    assert ttrace.current_tags() == {}
    spans = {s.name: s for s in ttrace.spans_since(mark)}
    assert spans["tagged"].attrs == {"world": "w", "rank": 5}
    assert spans["retro"].attrs == {"world": "w", "rank": 2}
    flag = ptt.flags.get_flag("trace")
    ptt.flags.set_flag("trace", False)
    try:
        assert not ttrace.enabled()
        ttrace.force_enable(True)
        mark = ttrace.mark()
        with ttrace.span("step", "forced"):
            pass
        ttrace.force_enable(False)
        with ttrace.span("step", "dropped"):
            pass
        assert [s.name for s in ttrace.spans_since(mark)] == ["forced"]
        ttrace.force_enable(False)          # unbalanced: stays off
        assert not ttrace.enabled()
    finally:
        ptt.flags.set_flag("trace", flag)


# ---- re-exports --------------------------------------------------------------

def test_re_exports():
    L = ptt.layers
    assert L.LayerHelper is ptt.layer_helper.LayerHelper
    assert L.ParamAttr is ptt.ParamAttr and L.Variable is ptt.Variable
    assert L.ConstantInitializer is ptt.initializer.ConstantInitializer
    assert L.NormalInitializer is ptt.initializer.NormalInitializer
    assert ptt.io.as_numpy(torch.ones(2, dtype=torch.bfloat16)).dtype == \
        np.float32
    assert ptt.devices("cpu") == [torch.device("cpu")]
    assert ptt.device_count() == torch.cuda.device_count()
    dense = np.float32([[0, 0], [1, 2], [0, 0], [3, 4]])
    rows = ptt.SelectedRows.from_dense(dense)
    jrows = pt.SelectedRows.from_dense(dense)
    assert list(rows.rows) == list(jrows.rows)
    dup = ptt.SelectedRows([1, 3, 1], np.float32([[1, 1], [2, 2], [3, 3]]),
                           4).merge_add()
    jdup = pt.SelectedRows([1, 3, 1], np.float32([[1, 1], [2, 2], [3, 3]]),
                           4).merge_add()
    np.testing.assert_array_equal(dup.to_dense(), jdup.to_dense())
