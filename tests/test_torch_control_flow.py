"""Fluid's control-flow builders through both packages: tests/
test_control_flow.py's programs (While counting to ten, the StaticRNN
cumulative sum, DynamicRNN with lengths, the IfElse mask merge,
`cond` (lazy_cond), Switch piecewise and the tensor arrays) built by the
JAX package and by the port, with equal program JSON, run by both
executors on the CPU from the same feeds; values at 1e-6.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.layers import control_flow as jcf

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.program import Program as PortProgram
from paddle_tpu_torch.layers import control_flow as tcf


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _while_counts_to_ten(pkg, cf):
    L = pkg.layers
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 10)
    total = L.fill_constant([1], "float32", 0.0)
    c = L.less_than(i, n)
    w = cf.While(c)
    with w.block():
        L.assign(L.elementwise_add(total, L.cast(i, "float32")),
                 output=total)
        L.assign(L.increment(i, value=1), output=i)
        L.less_than(i, n, cond=c)
    return [total, i]


def _static_rnn_cumsum(pkg, cf):
    L = pkg.layers
    x = L.data(name="x", shape=[6, 4])
    zero = L.fill_constant_batch_size_like(x, [-1, 4], "float32", 0.0)
    rnn = cf.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        acc = rnn.memory(init=zero)
        s = L.elementwise_add(acc, xt)
        rnn.update_memory(acc, s)
        rnn.step_output(s)
    return [rnn()]


def _static_rnn_output(pkg, cf):
    """`rnn.output(*outs)`, the fluid spelling of one step_output each."""
    L = pkg.layers
    x = L.data(name="x", shape=[6, 4])
    zero = L.fill_constant_batch_size_like(x, [-1, 4], "float32", 0.0)
    rnn = cf.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        acc = rnn.memory(init=zero)
        s = L.elementwise_add(acc, xt)
        rnn.update_memory(acc, s)
        rnn.output(s, L.scale(s, scale=2.0))
    return list(rnn())


def _dynamic_rnn_lengths(pkg, cf):
    L = pkg.layers
    x = L.data(name="x", shape=[6, 4], lod_level=1)
    zero = L.fill_constant_batch_size_like(x, [-1, 4], "float32", 0.0)
    drnn = cf.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        acc = drnn.memory(init=zero)
        s = L.elementwise_add(acc, xt)
        drnn.update_memory(acc, s)
        drnn.step_output(s)
    return [drnn(), drnn.final_memories()]


def _ifelse_mask_merge(pkg, cf):
    L = pkg.layers
    x = L.data(name="x", shape=[4])
    flag = L.data(name="flag", shape=[1], dtype="bool")
    ie = cf.IfElse(flag)
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=2.0))
    with ie.false_block():
        ie.output(L.scale(ie.input(x), scale=-1.0))
    return ie()


def _lazy_cond(pred_value):
    def build(pkg, cf):
        L = pkg.layers
        pred = L.fill_constant([1], "bool", pred_value)
        a = L.fill_constant([2], "float32", 3.0)
        b = L.fill_constant([2], "float32", 5.0)
        return [cf.cond(pred, lambda: L.elementwise_add(a, b),
                        lambda: L.elementwise_sub(a, b))]
    return build


def _switch_piecewise(step_value, default=True):
    def build(pkg, cf):
        L = pkg.layers
        step = L.fill_constant([1], "float32", step_value)
        b1 = L.fill_constant([1], "float32", 5.0)
        b2 = L.fill_constant([1], "float32", 10.0)
        lr = L.fill_constant([1], "float32", -1.0) if not default else \
            L.create_tensor("float32", name="lr_value")
        sw = cf.Switch()
        with sw.case(L.less_than(step, b1)):
            L.assign(L.fill_constant([1], "float32", 0.1), output=lr)
        with sw.case(L.less_than(step, b2)):
            L.assign(L.fill_constant([1], "float32", 0.01), output=lr)
        if default:
            with sw.default():
                L.assign(L.fill_constant([1], "float32", 0.001), output=lr)
        return [sw.finish(lr)]
    return build


def _tensor_arrays(pkg, cf):
    L = pkg.layers
    x = L.data("x", shape=[4])
    arr = cf.create_array("float32", max_len=3, shape=[2, 4])
    i0 = L.fill_constant([], "int64", 0)
    i1 = L.fill_constant([], "int64", 1)
    arr = cf.array_write(x, i0, arr)
    arr = cf.array_write(x * 2.0, i1, arr)
    return [cf.array_read(arr, i0), cf.array_read(arr, i1),
            cf.array_read(arr, L.fill_constant([], "int64", 2)),
            cf.array_length(arr)]


def _comparisons(pkg, cf):
    L = pkg.layers
    x = L.data("x", shape=[4])
    y = L.data("y", shape=[4])
    return [cf.less_equal(x, y), cf.greater_equal(x, y),
            cf.not_equal(x, y), cf.equal(x, y)]


R = np.random.RandomState(2)
X64 = R.rand(2, 6, 4).astype("float32")
PROGRAMS = {
    "while": (_while_counts_to_ten, {}),
    "static_rnn": (_static_rnn_cumsum,
                   {"x": R.rand(3, 6, 4).astype("float32")}),
    "static_rnn_output": (_static_rnn_output,
                          {"x": R.rand(3, 6, 4).astype("float32")}),
    "dynamic_rnn": (_dynamic_rnn_lengths,
                    {"x": X64, "x@SEQLEN": np.array([3, 6], "int32")}),
    "dynamic_rnn_empty_row": (_dynamic_rnn_lengths,
                              {"x": X64,
                               "x@SEQLEN": np.array([0, 2], "int32")}),
    "ifelse": (_ifelse_mask_merge,
               {"x": R.rand(6, 4).astype("float32"),
                "flag": np.array([[1], [0], [1], [0], [1], [0]], bool)}),
    "cond_true": (_lazy_cond(True), {}),
    "cond_false": (_lazy_cond(False), {}),
    "switch_second_case": (_switch_piecewise(7.0), {}),
    "switch_first_case": (_switch_piecewise(1.0), {}),
    "switch_default": (_switch_piecewise(12.0), {}),
    "switch_no_default_keeps_target": (_switch_piecewise(12.0, False), {}),
    "tensor_arrays": (_tensor_arrays, {"x": R.rand(2, 4).astype("float32")}),
    "comparisons": (_comparisons,
                    {"x": np.array([[1, 2, 3, np.nan]], "float32"),
                     "y": np.array([[2, 2, 1, 0]], "float32")}),
}


def _build(name):
    make, _ = PROGRAMS[name]
    built = []
    for pkg, cf in ((pt, jcf), (ptt, tcf)):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            outs = make(pkg, cf)
        built.append((main, start, [o.name for o in outs]))
    return built


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_and_runs_as_jax(name):
    (jmain, jstart, names), (tmain, tstart, tnames) = _build(name)
    assert tnames == names
    assert tmain.to_json() == jmain.to_json()
    assert PortProgram.from_json(jmain.to_json()).to_json() == \
        tmain.to_json()
    feed = PROGRAMS[name][1]
    jscope, tscope = pt.Scope(), ptt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    texe = ptt.Executor(ptt.CPUPlace())
    texe.run(tstart, scope=tscope)
    jout = pt.Executor().run(jmain, feed=feed, fetch_list=names,
                             scope=jscope)
    tout = texe.run(tmain, feed=feed, fetch_list=names, scope=tscope)
    for n, a, b in zip(names, tout, jout):
        b = np.asarray(b)
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=n)


def test_values_as_test_control_flow_states():
    """The claims of tests/test_control_flow.py, on the port's values."""
    def run(name):
        _, (tmain, tstart, names) = _build(name)
        exe = ptt.Executor(ptt.CPUPlace())
        scope = ptt.Scope()
        exe.run(tstart, scope=scope)
        return exe.run(tmain, feed=PROGRAMS[name][1], fetch_list=names,
                       scope=scope)
    total, i = run("while")
    assert float(total[0]) == sum(range(10)) and int(i[0]) == 10
    out, fin = run("dynamic_rnn")
    np.testing.assert_allclose(fin[0], X64[0, :3].sum(0), rtol=1e-5)
    np.testing.assert_allclose(fin[1], X64[1].sum(0), rtol=1e-5)
    assert (out[0, 3:] == 0).all()
    np.testing.assert_allclose(run("cond_true")[0], [8.0, 8.0])
    np.testing.assert_allclose(run("cond_false")[0], [-2.0, -2.0])
    np.testing.assert_allclose(run("switch_second_case")[0], [0.01])
    np.testing.assert_allclose(run("switch_no_default_keeps_target")[0],
                               [-1.0])
    a, b, c, n = run("tensor_arrays")
    x = PROGRAMS["tensor_arrays"][1]["x"]
    np.testing.assert_allclose(a, x)
    np.testing.assert_allclose(b, 2 * x)
    assert (c == 0).all() and int(n) == 3


def test_lazy_cond_runs_only_the_picked_branch(monkeypatch):
    _, (tmain, tstart, names) = _build("cond_true")
    calls = []
    sub = treg.lookup_op("elementwise_sub")
    monkeypatch.setitem(treg._OPS, "elementwise_sub", treg.OpDef(
        "elementwise_sub", lambda *a: calls.append(1) or sub.lower(*a)))
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(tstart, scope=scope)
    exe.run(tmain, fetch_list=names, scope=scope)
    assert calls == []


def test_while_is_forward_only():
    """A `while` on the differentiated path of a vjp_region raises, as the
    JAX package's lax.while_loop does under jax.vjp."""
    L = ptt.layers
    x = L.data("x", shape=[3], stop_gradient=False)
    w = ptt.layers.fc(x, size=3, name="wfc")
    i = L.fill_constant([1], "int64", 0)
    n = L.fill_constant([1], "int64", 2)
    c = L.less_than(i, n)
    loop = tcf.While(c)
    with loop.block():
        L.assign(L.scale(w, scale=2.0), output=w)
        L.assign(L.increment(i, value=1), output=i)
        L.less_than(i, n, cond=c)
    loss = L.mean(w)
    ptt.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    with pytest.raises(NotImplementedError, match="forward-only"):
        exe.run(feed={"x": np.ones((2, 3), "float32")}, fetch_list=[loss])


def test_ifelse_gradient_flows_through_both_branches():
    """IfElse runs both branches and merges with where: each row's
    gradient comes from the branch its flag picks (2 or -1 per element,
    over the mean's 1/numel)."""
    L = ptt.layers
    x = L.data("x", shape=[4], stop_gradient=False)
    xp = L.fc(x, size=4, name="ifc", bias_attr=False)
    flag = L.data("flag", shape=[1], dtype="bool")
    ie = tcf.IfElse(flag)
    with ie.true_block():
        ie.output(L.scale(xp, scale=2.0))
    with ie.false_block():
        ie.output(L.scale(xp, scale=-1.0))
    out, = ie()
    loss = L.mean(out)
    ptt.optimizer.SGD(learning_rate=0.0).minimize(loss)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    xv = np.ones((2, 4), "float32")
    g, = exe.run(feed={"x": xv, "flag": np.array([[1], [0]], bool)},
                 fetch_list=["ifc.w_0@GRAD"])
    np.testing.assert_allclose(g, np.full((4, 4), (2.0 - 1.0) / 8.0),
                               rtol=1e-6)


def test_control_flow_defaults_to_the_card():
    """Without a place the executor that runs a control-flow program
    targets CUDAPlace(0), which raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _while_counts_to_ten(ptt, tcf)
    with pytest.raises(UnavailableError):
        ptt.Executor().run(ptt.default_startup_program())
