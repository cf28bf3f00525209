"""The transpilers (`paddle_tpu_torch.transpiler`) and the passes over them
against the JAX package, on the CPU.

- `InferenceTranspiler` (batch norm folded into the conv / fc before it):
  a conv without bias, a conv with its 1-D bias add, an fc (`mul`) and
  ResNet-8 (NHWC) from the zoo. After the transpile the programs'
  `to_json` is equal, every folded scope value is within 1 float32 ulp
  of the JAX package's (the same numpy arithmetic: equal in practice),
  and the fetches before and after agree within 1e-5. A residual add and
  a conv output with two readers stay unfolded in both. A program run
  before the in-place rewrite runs the folded program after it.
- `QuantizeTranspiler` on a 2-layer, d_model-64 LM (float32 matmuls in
  both): `to_json` equal after `training_transpile` and `minimize` (the
  JAX program with its `.quantized` vars made differentiable, the one
  flag the port does not copy: the JAX program's autodiff stops at every
  fake-quant op, ROADMAP.md §3), three
  Adam steps, each from the JAX state, with losses within 1e-5 relative
  (1e-4 with the moving-average activation scale, whose first step's
  grid is finer), the scale
  within 1e-6, `freeze_program` bitwise from one state, and the refusal
  after `minimize`.
- `slice_variable` and both dispatchers over parametrised shapes and
  names; pserver and startup programs' `to_json` for SGD, Momentum and
  Adam; two Adam steps of each endpoint's pserver program within 1e-6.
- `Analyzer()`'s default list, `bn_fold_pass` and `quant_freeze_pass`
  through `get_pass`.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import transpiler as jtr
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework import passes as jpasses

import paddle_tpu_torch as ptt
from paddle_tpu_torch import transpiler as ttr
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import InvalidArgumentError

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
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


def _build(pkg, fn):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        out = fn(pkg)
    return main, start, out


def _state(scope):
    return {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}


def _port_scope(state):
    return ptt.load_numpy_params(state, ptt.Scope(), CPU)


def _bits_close(t, j, ulp=1):
    """Port tensor `t` within `ulp` float32 ulps of JAX array `j`."""
    t = t.detach().cpu().numpy()
    j = np.asarray(j)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_array_max_ulp(t, j, maxulp=ulp)


# ---- batch-norm folding ------------------------------------------------------

def _conv_bn(pkg):
    L = pkg.layers
    img = L.data("img", shape=[3, 8, 8])
    return L.batch_norm(L.conv2d(img, num_filters=4, filter_size=3,
                                 bias_attr=False), is_test=True)


def _conv_bias_bn(pkg):
    L = pkg.layers
    img = L.data("img", shape=[3, 8, 8])
    return L.batch_norm(L.conv2d(img, num_filters=4, filter_size=3),
                        is_test=True)


def _fc_bn(pkg):
    L = pkg.layers
    x = L.data("img", shape=[6])
    return L.batch_norm(L.fc(x, size=5, bias_attr=False), is_test=True)


def _residual_bn(pkg):
    L = pkg.layers
    img = L.data("img", shape=[3, 8, 8])
    a = L.conv2d(img, num_filters=4, filter_size=3, bias_attr=False)
    b = L.conv2d(img, num_filters=4, filter_size=3, bias_attr=False)
    return L.batch_norm(L.elementwise_add(a, b), is_test=True)


def _two_readers_bn(pkg):
    L = pkg.layers
    img = L.data("img", shape=[3, 8, 8])
    c = L.conv2d(img, num_filters=4, filter_size=3, bias_attr=False)
    return L.batch_norm(c, is_test=True) + L.scale(c, scale=2.0)


def _resnet8(pkg):
    img = pkg.layers.data("img", shape=[16, 16, 3])
    _, _, logits = pkg.models.resnet.resnet_cifar10(img=img, depth=8,
                                                    is_test=True)
    return logits


FOLD_CASES = {"conv": (_conv_bn, (2, 3, 8, 8), True),
              "conv_bias": (_conv_bias_bn, (2, 3, 8, 8), True),
              "fc": (_fc_bn, (4, 6), True),
              "residual": (_residual_bn, (2, 3, 8, 8), False),
              "two_readers": (_two_readers_bn, (2, 3, 8, 8), False),
              "resnet8": (_resnet8, (2, 16, 16, 3), True)}


def _bn_stats(program, scope, rng):
    """Non-trivial statistics and affine parameters for every BN."""
    for op in program.global_block().ops:
        if op.type != "batch_norm":
            continue
        c = np.asarray(scope.get(op.inputs["Mean"][0])).shape
        for slot, lo in (("Mean", -0.5), ("Variance", 0.5), ("Scale", 0.5),
                         ("Bias", -0.5)):
            scope.set_var(op.inputs[slot][0],
                          (rng.rand(*c) + lo).astype("float32"))


def _fold_pair(case):
    build, shape, _ = FOLD_CASES[case]
    jmain, jstart, jout = _build(pt, build)
    tmain, _, tout = _build(ptt, build)
    # the inference function alone (ResNet-8's loss reads a label)
    jmain, tmain = jmain.prune([jout.name]), tmain.prune([tout.name])
    assert tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    _bn_stats(jmain, jscope, np.random.RandomState(3))
    feed = {"img": np.random.RandomState(4).rand(*shape).astype("float32")}
    return jmain, jscope, jout.name, tmain, _port_scope(_state(jscope)), \
        feed


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_bn_fold_matches_jax(case):
    jmain, jscope, out, tmain, tscope, feed = _fold_pair(case)
    folds = FOLD_CASES[case][2]
    jexe, texe = pt.Executor(), ptt.Executor(CPU)
    jbase = np.asarray(jexe.run(jmain, feed=feed, fetch_list=[out],
                                scope=jscope)[0])
    tbase = texe.run(tmain, feed=feed, fetch_list=[out], scope=tscope)[0]
    np.testing.assert_allclose(tbase, jbase, rtol=1e-5, atol=1e-5)
    n_bn = sum(op.type == "batch_norm" for op in tmain.global_block().ops)

    jtr.InferenceTranspiler().transpile(jmain, scope=jscope)
    ttr.InferenceTranspiler().transpile(tmain, scope=tscope)
    assert tmain.to_json() == jmain.to_json()
    left = sum(op.type == "batch_norm" for op in tmain.global_block().ops)
    assert left == (0 if folds else n_bn)
    for name, value in _state(jscope).items():
        t = tscope.get(name)
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        _bits_close(t, value)
    # the same executor plans the rewritten program anew: a stale plan
    # would run batch_norm over the rescaled filters
    tfold = texe.run(tmain, feed=feed, fetch_list=[out], scope=tscope)[0]
    jfold = np.asarray(jexe.run(jmain, feed=feed, fetch_list=[out],
                                scope=jscope)[0])
    np.testing.assert_allclose(tfold, jfold, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tfold, tbase, rtol=1e-5, atol=1e-5)


def test_fold_writes_values_in_the_dtype_and_place_it_replaces():
    jmain, jscope, out, tmain, tscope, feed = _fold_pair("conv")
    filt = next(op for op in tmain.global_block().ops
                if op.type == "conv2d").inputs["Filter"][0]
    before = tscope.get(filt)
    ttr.InferenceTranspiler().transpile(tmain, scope=tscope)
    after = tscope.get(filt)
    assert after.dtype == before.dtype and after.device == before.device
    fused = next(n for n in tscope.local_var_names()
                 if n.endswith(".fused"))
    assert tscope.get(fused).dtype == torch.float32
    var = tmain.global_block().var(fused)
    assert var.persistable and list(var.shape) == [4]
    with pytest.raises(InvalidArgumentError):
        ttr.InferenceTranspiler().transpile("not a program")


# ---- quantization-aware training --------------------------------------------

LM = dict(vocab=50, max_len=8, d_model=64, d_inner=128, num_heads=4,
          num_layers=2)


def _differentiable_quantized(program):
    """The one flag the port does not copy (ROADMAP.md §3): each
    `.quantized` var differentiable where its source is. The JAX
    transpiler leaves the Variable default (stop_gradient=True), so its
    autodiff stops at every fake-quant op; with this flag set on the JAX
    program too, the JAX package is the reference for the port's QAT."""
    block = program.global_block()
    for name, v in block.vars.items():
        if name.endswith(".quantized"):
            v.stop_gradient = block.vars[name[:-len(".quantized")]] \
                .stop_gradient


def _qat_lm(kind, fix_jax=True):
    def build(pkg):
        loss, _ = pkg.models.transformer.transformer_lm(**LM)
        tr = (jtr if pkg is pt else ttr).QuantizeTranspiler(
            activation_quantize_type=kind)
        tr.training_transpile(pkg.default_main_program(),
                              pkg.default_startup_program())
        unfixed = pkg.default_main_program().to_json()
        if pkg is pt and fix_jax:
            _differentiable_quantized(pkg.default_main_program())
        quantized = pkg.default_main_program().to_json()
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return loss, quantized, unfixed
    return build


def _lm_feeds(n):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(n):
        toks = rng.randint(0, LM["vocab"], (4, LM["max_len"] + 1))
        out.append({"tokens": toks[:, :-1].astype("int64"),
                    "tokens@SEQLEN": np.full((4,), LM["max_len"], "int32"),
                    "targets": toks[:, 1:].astype("int64")})
    return out


@pytest.mark.parametrize("kind", ["abs_max", "moving_average_abs_max"])
def test_qat_lm_matches_jax(kind):
    jmain, jstart, (jloss, jq, junfixed) = _build(pt, _qat_lm(kind))
    tmain, tstart, (tloss, tq, _) = _build(ptt, _qat_lm(kind))
    assert tq == jq and tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    # the JAX transpiler's own program differs only in that flag
    jvars = json.loads(junfixed)["blocks"][0]["vars"]
    tvars = json.loads(tq)["blocks"][0]["vars"]
    flipped = [t["name"] for j, t in zip(jvars, tvars) if j != t]
    assert flipped and all(n.endswith(".quantized") for n in flipped)
    assert all(j == dict(t, stop_gradient=True)
               for j, t in zip(jvars, tvars) if j != t)
    assert json.loads(junfixed)["blocks"][0]["ops"] == \
        json.loads(tq)["blocks"][0]["ops"]
    ops = [op.type for op in tmain.global_block().ops]
    qtype = ("fake_quantize_abs_max" if kind == "abs_max" else
             "fake_quantize_moving_average_abs_max")
    assert ops.count(qtype) + ops.count("fake_quantize_abs_max") >= 16
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    jexe, texe = pt.Executor(), ptt.Executor(CPU)
    jl, tl = [], []
    for f in _lm_feeds(3):
        # each step from the JAX state (the repo's method for Adam steps):
        # a fake-quant rounding flip must not carry into the next step
        tscope = _port_scope(_state(jscope))
        jl.append(float(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                 scope=jscope)[0]))
        out = texe.run(tmain, feed=f, fetch_list=[tloss, "tok_emb@GRAD",
                                                  "l0_attn_q.w_0@GRAD"],
                       scope=tscope)
        tl.append(float(out[0]))
        # the straight-through gradient reaches the bottom of the net
        assert all(np.abs(g).max() > 0 for g in out[1:])
    # the moving-average scale starts at 0, so step 1 quantizes the
    # activations on a grid 10x finer than abs_max's: a float32 reordering
    # (~1e-7) that moves one element across a rounding boundary moves it a
    # whole grid step (1.9e-5 of the loss at step 1). 1e-4 holds that;
    # abs_max's grid keeps 1e-5
    np.testing.assert_allclose(tl, jl, rtol=1e-5 if kind == "abs_max"
                               else 1e-4)
    scales = [n for n in tscope.local_var_names()
              if n.endswith(".quant_scale")]
    if kind == "moving_average_abs_max":
        assert scales
        for n in scales:
            np.testing.assert_allclose(tscope.get(n).numpy(),
                                       np.asarray(jscope.get(n)), atol=1e-6,
                                       rtol=1e-6)
            assert float(tscope.get(n)) != 0.0
    else:
        assert scales == []


def test_quant_freeze_is_bitwise_and_the_frozen_loss_holds():
    jmain, jstart, (jloss, _, _) = _build(pt, _qat_lm("abs_max"))
    tmain, _, (tloss, _, _) = _build(ptt, _qat_lm("abs_max"))
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = _state(jscope)
    tscope = _port_scope(state)
    # the is_test clone's forward alone (the clone keeps the Adam ops)
    jtest = jmain.clone(for_test=True).prune([jloss])
    ttest = tmain.clone(for_test=True).prune([tloss])
    feed = _lm_feeds(1)[0]
    texe = ptt.Executor(CPU)
    before = float(texe.run(ttest, feed=feed, fetch_list=[tloss],
                            scope=tscope)[0])
    jpasses.get_pass("quant_freeze_pass").apply(jtest, jscope)
    ptt.Analyzer(passes=["quant_freeze_pass"]).run(ttest, tscope)
    assert ttest.to_json() == jtest.to_json()
    frozen = 0
    for op in ttest.global_block().ops:
        if op.type != "fake_quantize_abs_max" or \
                op.inputs["X"][0] not in state:
            continue
        w, s_name = op.inputs["X"][0], op.outputs["OutScale"][0]
        got = tscope.get(w).numpy()
        assert got.tobytes() == np.asarray(jscope.get(w)).tobytes(), w
        assert float(tscope.get(s_name)) == float(np.asarray(
            jscope.get(s_name)))
        s = np.abs(state[w].astype(np.float64)).max()
        grid = np.round(state[w] * (127 / s)) * (s / 127)
        np.testing.assert_allclose(got, grid, rtol=1e-6, atol=1e-7)
        frozen += 1
    assert frozen >= 8
    after = float(texe.run(ttest, feed=feed, fetch_list=[tloss],
                           scope=tscope)[0])
    assert abs(after - before) <= 1e-5 * abs(before), (before, after)


@pytest.mark.parametrize("pkg_name", ["jax", "torch"])
def test_qat_after_minimize_raises(pkg_name):
    pkg, tr = (pt, jtr) if pkg_name == "jax" else (ptt, ttr)

    def build(pkg):
        h = pkg.layers.fc(pkg.layers.data("img", shape=[8]), size=4)
        pkg.optimizer.SGD(learning_rate=0.1).minimize(pkg.layers.mean(h))
    main, _, _ = _build(pkg, build)
    with pytest.raises(RuntimeError, match="BEFORE"):
        tr.QuantizeTranspiler().training_transpile(main)
    with pytest.raises(ValueError):
        tr.QuantizeTranspiler(activation_quantize_type="range_abs_max")


# ---- the parameter-shard planner ---------------------------------------------

SHAPES = [[1000, 64], [7], [8192 * 3 + 5], [3, 5, 7], [20000, 1],
          [1, 100000], [40000, 3]]


@pytest.mark.parametrize("slices,min_block", [(1, 8192), (2, 8192),
                                              (3, 1024), (4, 1024)])
def test_slice_variable_matches_jax(slices, min_block):
    def build(pkg):
        blk = pkg.default_main_program().global_block()
        return [blk.create_parameter(name=f"w{i}", shape=s,
                                     dtype="float32")
                for i, s in enumerate(SHAPES)]
    _, _, jv = _build(pt, build)
    _, _, tv = _build(ptt, build)
    jb = jtr.slice_variable(jv, slices, min_block)
    tb = ttr.slice_variable(tv, slices, min_block)
    assert [[(str(b), b.begin) for b in v] for v in tb] == \
        [[(str(b), b.begin) for b in v] for v in jb]
    for v, blocks in zip(SHAPES, tb):
        assert sum(b.size for b in blocks) == int(np.prod(v))


NAMES = ["fc_0.w_0", "fc_0.b_0", "tok_emb", "l0_attn_q.w_0", "lm_head.w_0",
         "ζ-unicode", "", "a" * 300]


@pytest.mark.parametrize("n_eps", [1, 2, 3, 5])
def test_dispatchers_match_jax(n_eps):
    eps = [f"ps{i}:6174" for i in range(n_eps)]
    for jcls, tcls in ((jtr.RoundRobin, ttr.RoundRobin),
                       (jtr.HashName, ttr.HashName)):
        j, t = jcls(eps), tcls(eps)
        assert t.dispatch(NAMES) == j.dispatch(NAMES)
        assert t.dispatch(NAMES[::-1]) == j.dispatch(NAMES[::-1])
        assert t.eps == eps
    for n in NAMES:
        assert ttr.HashName._hash(n) == jtr.HashName._hash(n)


def _mlp(opt):
    def build(pkg):
        L = pkg.layers
        x = L.data("img", shape=[16])
        h = L.fc(x, size=600, act="relu")
        loss = L.mean(L.fc(h, size=10))
        o = pkg.optimizer
        {"sgd": lambda: o.SGD(learning_rate=0.1),
         "momentum": lambda: o.Momentum(learning_rate=0.1, momentum=0.9),
         "adam": lambda: o.Adam(learning_rate=0.01)}[opt]().minimize(loss)
        return loss
    return build


def _transpiled(pkg, tr, opt, split=None):
    main, start, loss = _build(pkg, _mlp(opt))
    cfg = tr.DistributeTranspilerConfig(min_block_size=1024)
    if split is not None:
        cfg.split_method = split
    t = tr.DistributeTranspiler(cfg)
    t.transpile(trainer_id=0, program=main, pservers="ps0:6174,ps1:6174",
                trainers=2)
    return t, main, start


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_pserver_programs_match_jax(opt):
    for jsplit, tsplit in ((None, None), (jtr.HashName, ttr.HashName)):
        jt, jmain, _ = _transpiled(pt, jtr, opt, jsplit)
        tt, tmain, _ = _transpiled(ptt, ttr, opt, tsplit)
        assert tt.get_trainer_program().to_json() == jmain.to_json()
        plan = tt.get_shard_plan()
        for p in tmain.all_parameters():
            assert sum(vb.size for vb, _ in plan.by_var[p.name]) == \
                int(np.prod(p.shape))
        for ep in ("ps0:6174", "ps1:6174"):
            jps, tps = jt.get_pserver_program(ep), tt.get_pserver_program(ep)
            assert tps.to_json() == jps.to_json()
            assert tt.get_startup_program(ep, tps).to_json() == \
                jt.get_startup_program(ep, jps).to_json()
            assert sum(op.type == opt for op in tps.global_block().ops) >= 1


def test_pserver_adam_steps_match_jax():
    jt, _, _ = _transpiled(pt, jtr, "adam")
    tt, _, _ = _transpiled(ptt, ttr, "adam")
    rng = np.random.RandomState(6)
    for ep in ("ps0:6174", "ps1:6174"):
        jps, tps = jt.get_pserver_program(ep), tt.get_pserver_program(ep)
        jscope, tscope = pt.Scope(), ptt.Scope()
        pt.Executor().run(jt.get_startup_program(ep, jps), scope=jscope)
        ptt.Executor(CPU).run(tt.get_startup_program(ep, tps), scope=tscope)
        adam = [op for op in tps.global_block().ops if op.type == "adam"]
        lr = adam[0].inputs["LearningRate"][0]
        jscope.set_var(lr, np.asarray(0.01, "float32"))
        tscope.set_var(lr, torch.tensor(0.01))
        for _ in range(2):
            feed = {}
            for op in adam:
                g = op.inputs["Grad"][0]
                n = tps.global_block().var(g).shape[0]
                feed[g] = rng.randn(n).astype("float32")
            jexe = pt.Executor()
            jexe.run(jps, feed=feed, fetch_list=[], scope=jscope)
            ptt.Executor(CPU).run(tps, feed=feed, fetch_list=[],
                                  scope=tscope)
        for name, value in _state(jscope).items():
            np.testing.assert_allclose(tscope.get(name).numpy(), value,
                                       rtol=1e-6, atol=1e-6, err_msg=name)
        # the beta powers advanced step by step, on the shard's own var
        b1 = adam[0].inputs["Beta1Pow"][0]
        assert adam[0].outputs["Beta1PowOut"] == [b1]
        np.testing.assert_allclose(float(tscope.get(b1)), 0.9 ** 3,
                                   rtol=1e-6)


def test_transpile_refuses_a_negative_trainer_id():
    main, _, _ = _build(ptt, _mlp("sgd"))
    with pytest.raises(InvalidArgumentError):
        ttr.DistributeTranspiler().transpile(-1, main)
    with pytest.raises(InvalidArgumentError):
        ttr.DistributeTranspiler().get_shard_plan()


# ---- the passes and the Analyzer ---------------------------------------------

def test_analyzer_default_list_folds_and_the_passes_resolve():
    assert {"bn_fold_pass", "quant_freeze_pass"} <= \
        set(ptt.registered_passes())
    assert isinstance(ptt.get_pass("bn_fold_pass"), ptt.Pass)
    assert isinstance(ptt.get_pass("quant_freeze_pass", weight_bits=8),
                      ptt.Pass)
    jmain, jscope, out, tmain, tscope, feed = _fold_pair("resnet8")
    jgot = jpasses.Analyzer().run(jmain, jscope, targets=[out])
    got = ptt.Analyzer().run(tmain, tscope, targets=[out])
    assert got.to_json() == jgot.to_json()
    assert "batch_norm" not in [op.type for op in got.global_block().ops]
    np.testing.assert_allclose(
        ptt.Executor(CPU).run(got, feed=feed, fetch_list=[out],
                              scope=tscope)[0],
        np.asarray(pt.Executor().run(jgot, feed=feed, fetch_list=[out],
                                     scope=jscope)[0]),
        rtol=1e-5, atol=1e-5)
