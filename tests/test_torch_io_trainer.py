"""The port's high-level API (`io`, `Trainer`, `Inferencer`, `DataFeeder`,
the reader decorators and the metrics registry) against the JAX package's.

A small classifier (fc 4 → 16 relu → 3, softmax cross entropy; with a
dropout of 0.3 where named) built by both packages with the same names.
Values carried between the packages are compared exactly (saved and
loaded arrays, bfloat16 bits); outputs computed by both at rtol 1e-5
(float32 sums in another order). Everything runs on CPUPlace().
"""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.data import decorator as jdecorator
from paddle_tpu.data.feeder import DataFeeder as JaxFeeder

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.framework.executor import as_numpy

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _net(pkg, dropout=0.0):
    x = pkg.layers.data(name="x", shape=[4], dtype="float32")
    y = pkg.layers.data(name="y", shape=[1], dtype="int64")
    h = pkg.layers.fc(x, size=16, act="relu")
    if dropout:
        h = pkg.layers.dropout(h, dropout_prob=dropout)
    logits = pkg.layers.fc(h, size=3)
    loss = pkg.layers.mean(pkg.layers.softmax_with_cross_entropy(logits, y))
    return loss, logits


def _program(pkg, dropout=0.0, lr=0.1):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        loss, logits = _net(pkg, dropout)
        pkg.optimizer.Momentum(learning_rate=lr,
                               momentum=0.9).minimize(loss)
    return main, start, loss, logits


def _batch(rng, n=8):
    x = rng.randn(n, 4).astype("float32")
    y = (x[:, :1] > 0).astype("int64") + (x[:, 1:2] > 1).astype("int64")
    return {"x": x, "y": y}


def _trained_port(steps=3, dropout=0.0):
    main, start, loss, logits = _program(ptt, dropout)
    scope = ptt.Scope()
    exe = ptt.Executor(CPU)
    exe.run(start, scope=scope)
    rng = np.random.RandomState(0)
    for _ in range(steps):
        exe.run(main, feed=_batch(rng), fetch_list=[loss], scope=scope)
    return main, exe, scope, loss, logits


def _persistables(main):
    return sorted(v.name for v in main.global_block().vars.values()
                  if v.persistable)


def _bf16(a):
    return as_numpy(torch.from_numpy(np.asarray(a, "float32"))
                    .to(torch.bfloat16))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("filename", [None, "all.npz"],
                         ids=["per_var", "combined"])
def test_persistables_round_trip(tmp_path, filename, bf16):
    main, exe, scope, _, _ = _trained_port()
    names = _persistables(main)
    want = {n: as_numpy(scope.get(n)).copy() for n in names}
    saved = ptt.io.save_persistables(exe, str(tmp_path), main_program=main,
                                     filename=filename, scope=scope,
                                     save_as_bf16=bf16)
    assert saved == names
    fresh = ptt.Scope()
    loaded = ptt.io.load_persistables(exe, str(tmp_path), main_program=main,
                                      filename=filename, scope=fresh)
    assert loaded == names
    for n in names:
        t = fresh.get(n)
        assert t.dtype == scope.get(n).dtype, n
        w = want[n]
        if bf16 and w.dtype == np.float32:
            w = _bf16(w)
        np.testing.assert_array_equal(as_numpy(t), w, err_msg=n)


def test_params_vars_and_program_round_trip(tmp_path):
    main, exe, scope, _, _ = _trained_port()
    params = sorted(p.name for p in main.all_parameters())
    assert ptt.io.save_params(exe, str(tmp_path / "p"), main_program=main,
                              scope=scope) == params
    fresh = ptt.Scope()
    assert ptt.io.load_params(exe, str(tmp_path / "p"), main_program=main,
                              scope=fresh) == params
    for n in params:
        assert torch.equal(fresh.get(n), scope.get(n))
    one = main.global_block().var(params[0])
    ptt.io.save_vars(exe, str(tmp_path / "v"), vars=[one], scope=scope)
    assert os.listdir(tmp_path / "v") == [one.name + ".npy"]
    start = ptt.Program()
    ptt.io.save_program(str(tmp_path / "prog"), main, start, ["x", "y"],
                        ["loss"])
    m2, s2, feeds, fetches = ptt.io.load_program(str(tmp_path / "prog"))
    assert m2.to_json() == main.to_json() and s2.to_json() == start.to_json()
    assert (feeds, fetches) == (["x", "y"], ["loss"])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("filename", [None, "all.npz"],
                         ids=["per_var", "combined"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_package_loading(tmp_path, direction, filename, bf16):
    """A directory either package writes loads in the other: the same
    values (bfloat16 bits included), each in its variable's dtype."""
    jmain, jstart, _, _ = _program(pt)
    tmain, tstart, _, _ = _program(ptt)
    assert jmain.to_json() == tmain.to_json()
    d = str(tmp_path)
    if direction == "jax_to_port":
        src = pt.Scope()
        pt.Executor().run(jstart, scope=src)
        pt.io.save_persistables(None, d, main_program=jmain, scope=src,
                                filename=filename, save_as_bf16=bf16)
        dst = ptt.Scope()
        ptt.io.load_persistables(ptt.Executor(CPU), d, main_program=tmain,
                                 scope=dst, filename=filename)
        got = {n: as_numpy(dst.get(n)) for n in _persistables(tmain)}
        want = {n: np.asarray(src.get(n)) for n in _persistables(tmain)}
    else:
        src = ptt.Scope()
        ptt.Executor(CPU).run(tstart, scope=src)
        ptt.io.save_persistables(None, d, main_program=tmain, scope=src,
                                 filename=filename, save_as_bf16=bf16)
        dst = pt.Scope()
        pt.io.load_persistables(None, d, main_program=jmain, scope=dst,
                                filename=filename)
        got = {n: np.asarray(dst.get(n)) for n in _persistables(tmain)}
        want = {n: as_numpy(src.get(n)) for n in _persistables(tmain)}
    for n, w in want.items():
        if bf16 and w.dtype == np.float32:
            w = _bf16(w)
        np.testing.assert_array_equal(got[n], w, err_msg=n)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_inference_model_serves_the_same_in_both(tmp_path, saved_by):
    """save_inference_model (pruned, is_test: the dropout scales by 0.7)
    from one package; both packages' Inferencer run it on the same feed."""
    feed = {"x": np.random.RandomState(5).randn(6, 4).astype("float32")}
    if saved_by == "jax":
        main, start, _, logits = _program(pt, dropout=0.3)
        scope = pt.Scope()
        pt.Executor().run(start, scope=scope)
        pt.io.save_inference_model(str(tmp_path), ["x"], [logits],
                                   main_program=main, scope=scope)
    else:
        main, exe, scope, _, logits = _trained_port(dropout=0.3)
        ptt.io.save_inference_model(str(tmp_path), ["x"], [logits],
                                    executor=exe, main_program=main,
                                    scope=scope)
    with open(tmp_path / "__model__") as f:
        meta = json.load(f)
    ops = [op["type"] for op in meta["program"]["blocks"][0]["ops"]]
    assert "dropout" in ops and "momentum" not in ops
    port = ptt.Inferencer(str(tmp_path), place=CPU)
    assert all(op.attrs.get("is_test") for op in
               port.program.global_block().ops if op.type == "dropout")
    got, = port.infer(feed)
    want, = pt.Inferencer(str(tmp_path)).infer(feed)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    clone = port._predictor.clone()
    np.testing.assert_array_equal(clone.run(feed)[0], got)
    with pytest.raises(Exception, match="missing feeds"):
        port.infer({})


def _reader(n_batches, seed=0, n=8):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_batches):
            b = _batch(rng, n)
            yield [(x, y) for x, y in zip(b["x"], b["y"])]
    return reader


def _trainer(ckpt_dir=None, place=CPU, **ckpt):
    cfg = (ptt.CheckpointConfig(ckpt_dir, **ckpt) if ckpt_dir is not None
           else None)
    with ptt.unique_name.guard():
        return ptt.Trainer(lambda: list(_net(ptt)[:1]),
                           lambda: ptt.optimizer.SGD(learning_rate=0.2),
                           place=place, checkpoint_config=cfg)


def test_trainer_events_metrics_and_test():
    tr = _trainer()
    events = []

    def handler(ev):
        events.append((type(ev).__name__, getattr(ev, "step", None)))
        if isinstance(ev, ptt.BeginStepEvent) and ev.step == 1:
            ev.fetch_metrics = False
        if isinstance(ev, ptt.EndStepEvent):
            assert len(ev.metrics) == (0 if ev.step == 1 else 1)

    tm = ptt.trainer.training_metrics()
    steps0, epochs0 = tm["steps"].value, tm["epochs"].value
    tr.train(2, handler, _reader(3), ["x", "y"])
    assert events[:8] == [("BeginEpochEvent", None), ("BeginStepEvent", 0),
                          ("EndStepEvent", 0), ("BeginStepEvent", 1),
                          ("EndStepEvent", 1), ("BeginStepEvent", 2),
                          ("EndStepEvent", 2), ("EndEpochEvent", None)]
    assert len(events) == 16
    assert tm["steps"].value - steps0 == 6
    assert tm["epochs"].value - epochs0 == 2
    text = ptt.observability.metrics.default_registry().expose()
    assert "ptpu_train_steps_total" in text
    assert "ptpu_train_step_seconds_bucket" in text
    before = {p.name: tr.scope.get(p.name).clone()
              for p in tr.train_program.all_parameters()}
    loss, = tr.test(_reader(2, seed=9), ["x", "y"])
    assert np.isfinite(loss)
    assert all(torch.equal(tr.scope.get(n), t) for n, t in before.items())


def test_trainer_matches_jax_trainer():
    """Both Trainers from the same weights over the same reader: the
    same losses each step (float32, SGD)."""
    jlosses, tlosses = [], []
    with pt.unique_name.guard():
        jtr = pt.Trainer(lambda: list(_net(pt)[:1]),
                         lambda: pt.optimizer.SGD(learning_rate=0.2))
    ttr = _trainer()
    state = {n: np.asarray(jtr.scope.get(n))
             for n in jtr.scope.local_var_names()}
    ptt.load_numpy_params(state, ttr.scope, CPU)

    def handler(out):
        def h(ev):
            if isinstance(ev, (pt.EndStepEvent, ptt.EndStepEvent)):
                out.append(float(np.asarray(ev.metrics[0])))
        return h

    jtr.train(1, handler(jlosses), _reader(5), ["x", "y"])
    ttr.train(1, handler(tlosses), _reader(5), ["x", "y"])
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert tlosses[-1] < tlosses[0]


def test_checkpoint_retention_and_resume(tmp_path):
    d = str(tmp_path)
    tr = _trainer(d, max_num_checkpoints=2, step_interval=2,
                  epoch_interval=1)
    tr.train(2, lambda ev: None, _reader(5), ["x", "y"])
    # saves: (0,2) (0,4) (1,0) (1,2) (1,4) (2,0) and the final (2,0)
    serials = sorted(os.listdir(d))
    assert serials == ["checkpoint_5", "checkpoint_6"], serials
    for s in serials:
        assert os.path.exists(os.path.join(d, s, "_SUCCESS"))
    assert ptt.trainer.get_latest_checkpoint_serial(d) == 6
    with open(os.path.join(d, "checkpoint_6", "trainer_args.json")) as f:
        assert json.load(f) == {"epoch_id": 2, "step_id": 0}
    os.remove(os.path.join(d, "checkpoint_6", "_SUCCESS"))
    assert ptt.trainer.get_latest_checkpoint_serial(d) == 5
    resumed = _trainer(d, max_num_checkpoints=2)
    assert (resumed.checkpoint_cfg.epoch_id,
            resumed.checkpoint_cfg.step_id) == (2, 0)
    for n in _persistables(tr.train_program):
        assert torch.equal(resumed.scope.get(n), tr.scope.get(n)), n
    steps = []
    resumed.train(2, lambda ev: steps.append(ev)
                  if isinstance(ev, ptt.BeginStepEvent) else None,
                  _reader(5), ["x", "y"])
    assert steps == []          # the run had completed


def test_stop_checkpoints_and_resume_skips_done_steps(tmp_path):
    d = str(tmp_path)
    tr = _trainer(d, step_interval=100)

    def handler(ev):
        if isinstance(ev, ptt.EndStepEvent) and ev.step == 2:
            tr.stop()

    tr.train(1, handler, _reader(6), ["x", "y"])
    args = ptt.load_checkpoint(tr.exe, d, tr.train_program,
                               scope=ptt.Scope())
    assert args == {"epoch_id": 0, "step_id": 3}
    resumed = _trainer(d, step_interval=100)
    seen = []
    resumed.train(1, lambda ev: seen.append(ev.step)
                  if isinstance(ev, ptt.BeginStepEvent) else None,
                  _reader(6), ["x", "y"])
    assert seen == [3, 4, 5]


def test_save_params_and_inference_model_from_trainer(tmp_path):
    tr = _trainer()
    tr.train(1, lambda ev: None, _reader(2), ["x", "y"])
    tr.save_params(str(tmp_path / "p"))
    names = sorted(p.name for p in tr.train_program.all_parameters())
    assert sorted(f[:-4] for f in os.listdir(tmp_path / "p")) == names
    logits = next(op for op in tr.train_program.global_block().ops
                  if op.type == "softmax_with_cross_entropy"
                  ).inputs["Logits"][0]
    tr.save_inference_model(str(tmp_path / "m"), ["x"], [logits])
    out, = ptt.Inferencer(str(tmp_path / "m"), place=CPU).infer(
        {"x": np.ones((2, 4), "float32")})
    assert out.shape == (2, 3)


def test_feeder_and_decorators_match_jax():
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        s = ptt.layers.data(name="s", shape=[5], dtype="int64", lod_level=1)
        lbl = ptt.layers.data(name="l", shape=[1], dtype="int64")
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart):
        js = pt.layers.data(name="s", shape=[5], dtype="int64", lod_level=1)
        jl = pt.layers.data(name="l", shape=[1], dtype="int64")
    samples = [([1, 2, 3], 0), ([4], 1), ([5, 6], 2)]
    got = ptt.DataFeeder([s, lbl]).feed(samples)
    want = JaxFeeder([js, jl]).feed(samples)
    assert sorted(got) == sorted(want) == ["l", "s", "s@SEQLEN"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype, k

    def reader():
        yield from range(7)

    for dec in ("batch", "firstn"):
        assert list(getattr(ptt.data, dec)(reader, 3)()) == \
            list(getattr(jdecorator, dec)(reader, 3)())
    assert list(ptt.data.batch(reader, 3, drop_last=False)()) == \
        [[0, 1, 2], [3, 4, 5], [6]]
    assert list(ptt.data.chain(reader, reader)()) == list(range(7)) * 2
    assert sorted(ptt.data.shuffle(reader, 4)()) == list(range(7))
    assert list(ptt.data.buffered(reader, 2)()) == list(range(7))


def test_unported_paths_raise_naming_the_roadmap(tmp_path):
    for fn in (ptt.io.export_inference_model, ptt.io.load_exported_model,
               ptt.io.export_train_program):
        with pytest.raises(NotImplementedError, match=r"§1 item 4"):
            fn(str(tmp_path))
    with pytest.raises(NotImplementedError, match=r"§1 item 4"):
        ptt.Predictor.from_exported(str(tmp_path))
    with pytest.raises(NotImplementedError, match=r"§1 item 4"):
        ptt.CheckpointConfig(str(tmp_path), sharded=True)
    with pytest.raises(NotImplementedError, match=r"§1 item 4"):
        ptt.CheckpointConfig(str(tmp_path), elastic=True)
    main, exe, scope, _, logits = _trained_port(steps=1)
    with pytest.raises(NotImplementedError, match=r"§1 item 4"):
        ptt.io.save_inference_model(str(tmp_path), ["x"], [logits],
                                    main_program=main, scope=scope,
                                    export=True)
    with pytest.raises(NotImplementedError, match=r"§1 item 4"):
        ptt.io.save_persistables(exe, str(tmp_path), main_program=main,
                                 scope=scope, filename="all.pts")


def test_entry_points_default_to_the_card(tmp_path):
    """Without a place the entry points run on CUDAPlace(0), which raises
    on a machine without a card (this one, for the CPU suite)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default place is usable")
    main, exe, scope, _, logits = _trained_port(steps=1)
    ptt.io.save_inference_model(str(tmp_path), ["x"], [logits],
                                executor=exe, main_program=main, scope=scope)
    with pytest.raises(UnavailableError):
        ptt.Inferencer(str(tmp_path))
    with pytest.raises(UnavailableError):
        ptt.io.load_inference_model(str(tmp_path), scope=ptt.Scope())
    with pytest.raises(UnavailableError):
        _trainer(place=None)
