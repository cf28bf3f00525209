"""The rest of training in the port: dropout, the learning-rate schedules,
gradient clipping and weight decay, against the JAX package.

- Dropout cannot agree bitwise (jax's threefry and torch's Philox draw
  different masks), so the rest is held exactly: at `is_test` (the attr,
  or a `clone(for_test=True)` program) Out = X·(1-p) exactly; in training
  Out == X·Mask with Mask in {0, 1} (`upscale_in_train`: X·Mask/(1-p)),
  the keep fraction within 4σ of 1-p (σ = sqrt(p(1-p)/n)), the gradient
  through a vjp_region equal to dOut·Mask for the mask that run drew, a
  nonzero `seed` attr giving the same mask twice and two runs of seed 0
  different masks. The programs equal the JAX package's (`to_json`).
- The schedules: each over 10 executor runs against the JAX package's
  values of the same program at rtol 1e-6 (float32 arithmetic, the same
  op order), mirroring tests/test_lr_scheduler.py.
- Clip by value, by norm and by global norm, L1 and L2 decay: one
  `minimize` step through both packages from the same weights (carried
  with `load_numpy_params`); programs equal through `to_json`, updated
  parameters at 1e-5 (sums in another order), mirroring
  tests/test_backward.py:49,67.
"""

import math

import numpy as np
import pytest
import torch

import paddle_tpu as pt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.framework.executor import as_numpy


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _dropout_program(pkg, p, impl="downgrade_in_infer", seed=None,
                     is_test=False):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[6, 50], dtype="float32")
        h = pkg.layers.fc(x, size=40, num_flatten_dims=2, bias_attr=False)
        d = pkg.layers.dropout(h, dropout_prob=p, is_test=is_test,
                               seed=seed, dropout_implementation=impl)
        w = pkg.layers.data(name="w", shape=[6, 40], dtype="float32")
        loss = pkg.layers.reduce_sum(pkg.layers.elementwise_mul(d, w))
    return main, start, h, d, loss


def _mask_name(main):
    return next(op for op in main.global_block().ops
                if op.type == "dropout").outputs["Mask"][0]


def _feed(seed=0, b=8):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(b, 6, 50).astype("float32"),
            "w": rng.randn(b, 6, 40).astype("float32")}


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_program_matches_jax_json(impl):
    for is_test in (False, True):
        j = _dropout_program(pt, 0.3, impl, seed=5, is_test=is_test)
        t = _dropout_program(ptt, 0.3, impl, seed=5, is_test=is_test)
        assert j[0].to_json() == t[0].to_json()
        assert j[1].to_json() == t[1].to_json()


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_is_test_is_exact(impl):
    """The is_test attr, and a training program cloned for test, scale by
    1-p (downgrade_in_infer) or pass X through (upscale_in_train), with no
    draw; the JAX package gives the same values."""
    p = 0.3
    main, start, h, d, _ = _dropout_program(ptt, p, impl)
    test_prog = main.clone(for_test=True)
    assert all(op.attrs["is_test"] for op in test_prog.global_block().ops
               if op.type == "dropout")
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope)
    feed = _feed()
    hv, dv = exe.run(test_prog, feed=feed, fetch_list=[h, d], scope=scope)
    want = hv if impl == "upscale_in_train" else hv * np.float32(1 - p)
    np.testing.assert_array_equal(dv, want)

    jmain, jstart, jh, jd, _ = _dropout_program(pt, p, impl, is_test=True)
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    w = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(w, ptt.Scope(), ptt.CPUPlace())
    jd_v, = pt.Executor().run(jmain, feed=feed, fetch_list=[jd],
                              scope=jscope)
    td_v, = exe.run(test_prog, feed=feed, fetch_list=[d], scope=tscope)
    np.testing.assert_allclose(td_v, jd_v, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_dropout_training_out_mask_and_keep_fraction(impl):
    p = 0.3
    main, start, h, d, _ = _dropout_program(ptt, p, impl)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope)
    hv, dv, mask = exe.run(main, feed=_feed(), fetch_list=[h, d,
                                                           _mask_name(main)],
                           scope=scope)
    assert set(np.unique(mask)) <= {0.0, 1.0}
    want = hv * mask
    if impl == "upscale_in_train":
        want = want / np.float32(1 - p)
    np.testing.assert_allclose(dv, want, rtol=1e-6, atol=0)
    n = mask.size
    keep = float(mask.mean())
    assert abs(keep - (1 - p)) < 4 * math.sqrt(p * (1 - p) / n), keep


def test_dropout_keep_fraction_matches_jax_in_distribution():
    """Both packages' masks keep 1-p of the elements within 4σ."""
    p = 0.2
    jmain, jstart, _, _, _ = _dropout_program(pt, p)
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    jmask, = pt.Executor().run(jmain, feed=_feed(b=32),
                               fetch_list=[_mask_name(jmain)], scope=jscope)
    main, start, _, _, _ = _dropout_program(ptt, p)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope)
    tmask, = exe.run(main, feed=_feed(b=32), fetch_list=[_mask_name(main)],
                     scope=scope)
    sigma = math.sqrt(p * (1 - p) / tmask.size)
    for m in (np.asarray(jmask), tmask):
        assert abs(float(m.mean()) - (1 - p)) < 4 * sigma


def test_dropout_gradient_is_dout_times_the_drawn_mask():
    """Under the vjp_region the mask is drawn once, in the forward: the fc
    weight's gradient is xᵀ·(w∘Mask) for the Mask that same run fetched."""
    p = 0.4
    main, start, h, d, loss = _dropout_program(ptt, p)
    with ptt.program_guard(main, start):
        ptt.optimizer.SGD(learning_rate=0.0).minimize(loss)
    wname = main.all_parameters()[0].name
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope)
    feed = _feed(3)
    mask, g = exe.run(main, feed=feed,
                      fetch_list=[_mask_name(main), wname + "@GRAD"],
                      scope=scope)
    x = feed["x"].reshape(-1, 50)
    dout = (feed["w"] * mask).reshape(-1, 40)
    np.testing.assert_allclose(g, x.T @ dout, rtol=1e-5, atol=1e-5)


def test_dropout_seed_attr_repeats_and_runs_differ():
    exe = ptt.Executor(ptt.CPUPlace())
    masks = {}
    for seed in (7, None):
        main, start, _, _, _ = _dropout_program(ptt, 0.5, seed=seed)
        scope = ptt.Scope()
        exe.run(start, scope=scope)
        masks[seed] = [exe.run(main, feed=_feed(), scope=scope,
                               fetch_list=[_mask_name(main)])[0]
                       for _ in range(2)]
    np.testing.assert_array_equal(masks[7][0], masks[7][1])
    assert not np.array_equal(masks[None][0], masks[None][1])


# --- learning-rate schedules -------------------------------------------------

SCHEDULES = {
    "noam": lambda L: L.noam_decay(64, 4),
    "exponential": lambda L: L.exponential_decay(0.1, 10, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 10, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 4, 0.5, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 10, 0.5),
    "polynomial": lambda L: L.polynomial_decay(0.1, 5, 0.01, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 5, 0.01,
                                                     power=2.0, cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 6], [1.0, 0.5, 0.1]),
    "cosine": lambda L: L.cosine_decay(0.1, 2, 5),
}


def _schedule(pkg, make):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        lr = make(pkg.layers)
    return main, start, lr


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax_over_10_steps(name):
    jmain, jstart, jlr = _schedule(pt, SCHEDULES[name])
    tmain, tstart, tlr = _schedule(ptt, SCHEDULES[name])
    assert jmain.to_json() == tmain.to_json()
    assert jstart.to_json() == tstart.to_json()
    jscope, tscope = pt.Scope(), ptt.Scope()
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    got, want = [], []
    for _ in range(10):
        want.append(float(np.asarray(jexe.run(
            jmain, feed={}, fetch_list=[jlr], scope=jscope)[0]).reshape(())))
        got.append(float(texe.run(tmain, feed={}, fetch_list=[tlr],
                                  scope=tscope)[0].reshape(())))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    counter = next(n for n in tscope.local_var_names() if "COUNTER" in n)
    ctr = tscope.get(counter)
    assert ctr.dtype == torch.int64 and int(ctr) == 10 - (name != "noam")


def test_step_counter_is_updated_in_place_once_a_run():
    """The counter is read-write state: the same tensor every run, one
    increment a run, and the optimizer reads the schedule's value as a
    tensor each step (a frozen rate would leave the update constant). The
    gradient is 1 here, so each SGD step moves the weight by the step's
    rate, read off as a difference of float32 weights below 1 in size:
    atol 1e-6 (a few float32 units there; the rates differ by 2.5e-4)."""
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start), ptt.unique_name.guard():
        x = ptt.layers.data(name="x", shape=[3], dtype="float32")
        loss = ptt.layers.mean(ptt.layers.fc(x, size=1, bias_attr=False))
        lr = ptt.layers.noam_decay(16, 100)
        ptt.optimizer.SGD(learning_rate=lr).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope)
    name = "@LR_DECAY_COUNTER@1@"
    ctr = scope.get(name)
    w = main.all_parameters()[0].name
    feed = {"x": np.ones((2, 3), "float32")}
    steps = []
    for _ in range(3):
        before = as_numpy(scope.get(w)).copy()
        exe.run(main, feed=feed, scope=scope)
        steps.append(float((before - as_numpy(scope.get(w)))[0, 0]))
    assert scope.get(name) is ctr and int(ctr) == 3
    rates = [16 ** -0.5 * s * 100 ** -1.5 for s in (1, 2, 3)]
    np.testing.assert_allclose(steps, rates, rtol=0, atol=1e-6)


# --- clipping and weight decay -----------------------------------------------

def _clip_setup(pkg, kind):
    if kind == "value":
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByValue(0.05))
    elif kind == "norm":
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByNorm(0.1))
    elif kind == "global_norm":
        pkg.clip.set_gradient_clip(pkg.clip.GradientClipByGlobalNorm(0.2))
    elif kind == "l1":
        return pkg.regularizer.L1Decay(0.05)
    elif kind == "l2":
        return pkg.regularizer.L2Decay(0.05)
    return None


def _clip_program(pkg, kind, opt):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[4], dtype="float32")
        h = pkg.layers.fc(x, size=16, act="relu")
        y = pkg.layers.fc(h, size=1)
        loss = pkg.layers.mean(y)
        reg = _clip_setup(pkg, kind)
        if opt == "sgd":
            o = pkg.optimizer.SGD(learning_rate=0.5, regularization=reg)
        elif opt == "momentum":
            o = pkg.optimizer.Momentum(learning_rate=0.5, momentum=0.9,
                                       regularization=reg)
        else:
            o = pkg.optimizer.Adam(learning_rate=0.01, regularization=reg)
        o.minimize(loss)
    return main, start, loss


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("kind", ["value", "norm", "global_norm", "l1",
                                  "l2"])
def test_clip_and_decay_minimize_step_matches_jax(kind, opt):
    jmain, jstart, jloss = _clip_program(pt, kind, opt)
    tmain, tstart, _ = _clip_program(ptt, kind, opt)
    assert jmain.to_json() == tmain.to_json()
    assert jstart.to_json() == tstart.to_json()
    types = [op.type for op in tmain.global_block().ops]
    assert {"value": "clip", "norm": "clip_by_norm",
            "global_norm": "squared_l2_norm", "l1": "sign",
            "l2": "scale"}[kind] in types
    if kind == "global_norm":
        assert types.count("sqrt") == 1
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    feed = {"x": np.random.RandomState(1).rand(8, 4).astype("float32") * 4}
    pt.Executor().run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
    ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed, scope=tscope)
    moved = 0
    for p in tmain.all_parameters():
        got, want = as_numpy(tscope.get(p.name)), np.asarray(
            jscope.get(p.name))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=p.name)
        moved += not np.array_equal(got, state[p.name])
    assert moved
