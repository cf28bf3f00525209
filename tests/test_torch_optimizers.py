"""The optimizer family in the port, against the JAX package.

- The twelve update ops (sgd, momentum, adam and the nine of
  paddle_tpu/ops/optimizer_ops.py:146-290): tests/test_op_coverage.py's
  optimizer inputs through both registries, then edge cases — a zero
  gradient for each, the first step of adadelta and rmsprop (zero
  accumulators; rmsprop centered and with momentum), ftrl with lr_power
  -0.3, lamb's trust ratio at ‖p‖ = 0 and at ‖update‖ = 0. Float32 at
  1e-6 + 1e-6|x| (the same arithmetic in the same order; lamb's norms sum
  in another order); NaN where the reference gives NaN (proximal_adagrad
  of a zero gradient on a zero moment divides 0 by 0 in both).
- In place: an op whose outputs name its inputs (what the optimizers
  append) updates those tensors and gives the out-of-place values.
- The classes: each builds the JAX package's program (`to_json` equal) on
  a small fc model, and 3 steps from the same state (carried with
  `load_numpy_params`) give the same losses at 1e-5 and parameters and
  accumulators at 1e-5 + 1e-5|x|.
- ModelAverage: the EMA ops, apply / restore through the port's Scope, and
  the averaged values equal to the JAX package's; WeightedAverage equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.average import WeightedAverage as JWeightedAverage
from paddle_tpu.framework import registry as jreg

import paddle_tpu_torch as ptt
from paddle_tpu_torch.average import WeightedAverage
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.executor import as_numpy
from paddle_tpu_torch.framework.program import Program as PortProgram

from test_op_coverage import SPECS

from tests.port_env import port_jax_compile_cache  # noqa: F401

OPS = ("sgd", "momentum", "adam", "adamax", "adagrad", "decayed_adagrad",
       "adadelta", "rmsprop", "ftrl", "proximal_gd", "proximal_adagrad",
       "lamb")


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _lower_both(op_type, ins, attrs):
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs))
    tout = treg.lookup_op(op_type).lower(
        treg.LowerCtx(),
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in ins.items()}, dict(attrs))
    return jout, tout


def _assert_same(jout, tout, rtol=1e-6, atol=1e-6):
    assert set(tout) == set(jout)
    for slot, jv in jout.items():
        j, t = np.asarray(jv[0]), as_numpy(tout[slot][0])
        assert t.shape == j.shape and t.dtype == j.dtype, slot
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol,
                                   equal_nan=True, err_msg=slot)


def _spec(op_type, seed=0):
    spec = SPECS[op_type]
    ins = {k: v if isinstance(v, list) else [v]
           for k, v in spec["ins"](np.random.RandomState(seed)).items()}
    return ins, dict(spec.get("attrs", {}))


@pytest.mark.parametrize("op_type", OPS)
def test_op_matches_jax(op_type):
    ins, attrs = _spec(op_type)
    _assert_same(*_lower_both(op_type, ins, attrs))


@pytest.mark.parametrize("op_type", OPS)
def test_zero_gradient_matches_jax(op_type):
    ins, attrs = _spec(op_type, seed=1)
    ins["Grad"] = [np.zeros_like(ins["Grad"][0])]
    _assert_same(*_lower_both(op_type, ins, attrs))


def _zeros_like_state(ins, keep=("Param", "Grad", "LearningRate")):
    return {k: v if k in keep else [np.zeros_like(v[0])]
            for k, v in ins.items()}


@pytest.mark.parametrize("case", [
    "adadelta_first", "rmsprop_first", "rmsprop_first_centered",
    "rmsprop_centered_momentum", "ftrl_lr_power", "ftrl_lr_power_first",
    "lamb_zero_param", "lamb_zero_update", "proximal_adagrad_zero_grad",
    "adamax_first"])
def test_edge_case_matches_jax(case):
    op_type = case.split("_first")[0].split("_zero")[0].split("_lr")[0] \
        .split("_centered")[0]
    ins, attrs = _spec(op_type, seed=2)
    if case.endswith("first"):
        # the first step: every accumulator as the startup program makes it
        ins = _zeros_like_state(ins)
        if op_type == "adamax":
            ins["Beta1Pow"] = [np.array([0.9], "float32")]
    if "centered" in case:
        attrs["centered"] = True
        ins["MeanGrad"] = [np.zeros_like(ins["Param"][0])
                           if case.endswith("first")
                           else 0.1 * ins["Grad"][0]]
        attrs["momentum"] = 0.0 if case.endswith("first") else 0.9
    if case.startswith("ftrl_lr_power"):
        attrs["lr_power"] = -0.3
    if case == "lamb_zero_param":
        ins["Param"] = [np.zeros_like(ins["Param"][0])]
        attrs["weight_decay"] = 0.0
    if case == "lamb_zero_update":
        ins["Grad"] = [np.zeros_like(ins["Grad"][0])]
        ins["Moment1"] = [np.zeros_like(ins["Moment1"][0])]
        attrs["weight_decay"] = 0.0
    if case == "proximal_adagrad_zero_grad":
        ins["Grad"] = [np.zeros_like(ins["Grad"][0])]
        ins["Moment"] = [np.zeros_like(ins["Moment"][0])]
    jout, tout = _lower_both(op_type, ins, attrs)
    _assert_same(jout, tout)
    if case == "proximal_adagrad_zero_grad":
        assert np.isnan(as_numpy(tout["ParamOut"][0])).all()
    if case.startswith("lamb_zero"):
        # trust ratio 1: the step is lr * update
        p = ins["Param"][0]
        assert np.isfinite(as_numpy(tout["ParamOut"][0])).all()
        if case == "lamb_zero_update":
            np.testing.assert_array_equal(as_numpy(tout["ParamOut"][0]), p)


@pytest.mark.parametrize("op_type", OPS[3:])
def test_op_updates_in_place_on_its_own_variables(op_type):
    """Outputs that name their inputs are the input tensors, updated to
    the out-of-place values."""
    ins, attrs = _spec(op_type, seed=3)
    if op_type == "rmsprop":
        attrs["centered"] = True
        ins["MeanGrad"] = [0.1 * ins["Grad"][0]]
    fresh = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {s: [torch.from_numpy(np.array(v[0]))]
                          for s, v in ins.items()}, dict(attrs))
    names = {s: s.lower() for s in ins}
    outs = {}
    for slot in fresh:
        base = slot[:-3]
        src = {"SquaredAccum": "SquaredAccumulator",
               "LinearAccum": "LinearAccumulator"}.get(base, base)
        outs[slot] = [names[src]]
    block = PortProgram().global_block()
    op = block.append_op(op_type, inputs={s: [names[s]] for s in ins},
                         outputs=outs, attrs=attrs)
    tins = {s: [torch.from_numpy(np.array(v[0]))] for s, v in ins.items()}
    out = treg.lookup_op(op_type).lower(treg.LowerCtx(op=op), tins,
                                        dict(attrs))
    for slot, name in outs.items():
        src = next(s for s in ins if names[s] == name[0])
        assert out[slot][0] is tins[src][0], slot
        assert torch.equal(out[slot][0], fresh[slot][0]), slot


# -- the classes ------------------------------------------------------------

def _make_opt(pkg, name):
    o = pkg.optimizer
    return {
        "SGD": lambda: o.SGD(learning_rate=0.1),
        "Momentum": lambda: o.Momentum(learning_rate=0.1, momentum=0.9,
                                       use_nesterov=True),
        "Adagrad": lambda: o.Adagrad(learning_rate=0.1),
        "Adam": lambda: o.Adam(learning_rate=0.01),
        "Adamax": lambda: o.Adamax(learning_rate=0.01),
        "DecayedAdagrad": lambda: o.DecayedAdagrad(learning_rate=0.1),
        "Adadelta": lambda: o.Adadelta(learning_rate=1.0),
        "RMSProp": lambda: o.RMSProp(learning_rate=0.01, momentum=0.9),
        "RMSPropCentered": lambda: o.RMSProp(learning_rate=0.01,
                                             centered=True),
        "Ftrl": lambda: o.Ftrl(learning_rate=0.1, l1=0.01, l2=0.01),
        "FtrlPower": lambda: o.Ftrl(learning_rate=0.1, lr_power=-0.3),
        "Lamb": lambda: o.Lamb(learning_rate=0.01),
    }[name]()


def _model(pkg, opt_name):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        h = pkg.layers.fc(x, size=8, act="tanh")
        pred = pkg.layers.fc(h, size=1)
        d = pkg.layers.elementwise_sub(pred, y)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(d, d))
        _make_opt(pkg, opt_name).minimize(loss)
    return main, start, loss


def _feeds(steps=3, b=5):
    rng = np.random.RandomState(11)
    return [{"x": rng.randn(b, 6).astype("float32"),
             "y": rng.randn(b, 1).astype("float32")} for _ in range(steps)]


@pytest.mark.parametrize("opt_name", [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
    "Adadelta", "RMSProp", "RMSPropCentered", "Ftrl", "FtrlPower", "Lamb"])
def test_optimizer_class_matches_jax(opt_name):
    jmain, jstart, jloss = _model(pt, opt_name)
    tmain, tstart, tloss = _model(ptt, opt_name)
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    jscope = pt.Scope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    for feed in _feeds():
        jl, = jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        tl, = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for n in state:
        np.testing.assert_allclose(as_numpy(tscope.get(n)),
                                   np.asarray(jscope.get(n)), rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def _averaged(pkg):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        y = pkg.layers.data(name="y", shape=[1], dtype="float32")
        pred = pkg.layers.fc(x, size=1)
        d = pkg.layers.elementwise_sub(pred, y)
        loss = pkg.layers.mean(pkg.layers.elementwise_mul(d, d))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        test_prog = main.clone(for_test=True)
        avg = pkg.optimizer.ModelAverage(average_window_rate=0.3)
        avg.build(main.all_parameters())
    return main, start, loss, avg, test_prog


def test_model_average_matches_jax():
    """build appends scale + scale + sum per parameter (the JAX package's
    program); after 3 steps apply swaps in the averages (equal to the JAX
    package's), an evaluation sees them, and restore brings back the
    trained values. The average is a copy: a step between apply and
    restore does not move it."""
    jmain, jstart, jloss, javg, jtest = _averaged(pt)
    tmain, tstart, tloss, tavg, ttest = _averaged(ptt)
    assert tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    for feed in _feeds():
        jexe.run(jmain, feed=feed, fetch_list=[jloss], scope=jscope)
        texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
    params = [p.name for p in tmain.all_parameters()]
    trained = {n: as_numpy(tscope.get(n)).copy() for n in params}
    javg.apply(jscope)
    tavg.apply(tscope)
    for n in params:
        np.testing.assert_allclose(as_numpy(tscope.get(n)),
                                   np.asarray(jscope.get(n)), rtol=1e-5,
                                   atol=1e-6, err_msg=n)
        assert not np.allclose(as_numpy(tscope.get(n)), trained[n])
    averaged = {n: as_numpy(tscope.get(n)).copy() for n in params}
    emas = {n: as_numpy(tscope.get(tavg._get_accumulator("ema", p).name))
            .copy() for n, p in zip(params, tmain.all_parameters())}
    feed = _feeds(1)[0]
    # (the evaluation program is cloned before build: in the JAX package
    # the applied parameter IS the average's buffer, and a program that
    # also writes the average donates that buffer twice)
    got, = texe.run(ttest, feed=feed, fetch_list=[tloss], scope=tscope)
    want, = jexe.run(jtest, feed=feed, fetch_list=[jloss], scope=jscope)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
    for n, p in zip(params, tmain.all_parameters()):
        # the step moved the swapped-in parameter; the average moved only
        # by its own ops, 0.7 * ema + 0.3 * p (read after the update)
        p_new = as_numpy(tscope.get(n))
        assert not np.array_equal(p_new, averaged[n])
        ema = as_numpy(tscope.get(tavg._get_accumulator("ema", p).name))
        np.testing.assert_allclose(ema, np.float32(0.7) * emas[n]
                                   + np.float32(0.3) * p_new, rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    tavg.restore(tscope)
    javg.restore(jscope)
    for n in params:
        assert tscope.find_var(n + "@MODEL_AVG_BACKUP") is None
        np.testing.assert_array_equal(as_numpy(tscope.get(n)), trained[n])


def test_weighted_average_matches_jax():
    j, t = JWeightedAverage(), WeightedAverage()
    for value, weight in ((np.array([1.0, 2.0]), 2), (3.5, 1),
                          (np.float32(0.25), 4)):
        j.add(value, weight)
        t.add(value, weight)
    assert t.eval() == j.eval()
    with pytest.raises(Exception, match="non-finite"):
        t.add(float("nan"))
    t.reset()
    with pytest.raises(Exception, match="before any add"):
        t.eval()
