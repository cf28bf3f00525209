"""Rematerialization and live-out narrowing in the port, against the JAX
package.

- `transpiler.memory_optimize` (levels 0 and 1) and `release_memory`
  rewrite a program into the JAX package's (`to_json` equal).
- A tiny Transformer LM (vocab 64, max_len 8, d_model 32, 2 layers, float32
  mode) under remat: step 1's loss and every gradient equal the JAX
  package's under the same rewrite (loss at 1e-5 relative, each gradient
  at 1e-5 of its largest element: sums in another order); 3 Adam steps
  bit-equal to the port's own un-rematerialized run, at levels 0 and 1,
  with dropout 0 and 0.1 (the recompute draws the forward's masks from
  the run's generator; a control on torch.utils.checkpoint alone must
  break the equality). The attention forward runs twice a layer
  a step under remat (the backward recomputes it), once without.
- `remat_segments` from the JAX package's memory planner, loaded with
  `Program.from_json`: 2 Adam steps equal to the JAX package's planned
  program (losses at 1e-5) and to the port's unplanned run.
- `live_out`: the region publishes only the live set plus the run's
  fetches.
- batch_norm under remat: ResNet-8's running statistics move once a step,
  bit-equal to the un-rematerialized run, and equal to the JAX package's
  at 1e-5 of each tensor's largest magnitude.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.passes import get_pass
from paddle_tpu.transpiler import memory_optimize as jmemory_optimize
from paddle_tpu.transpiler import release_memory as jrelease_memory

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import lowering
from paddle_tpu_torch.framework.executor import as_numpy
from paddle_tpu_torch.ops import flash_attention
from paddle_tpu_torch.transpiler import memory_optimize, release_memory

from tests.port_env import port_jax_compile_cache  # noqa: F401

DIMS = dict(vocab=64, max_len=8, d_model=32, d_inner=64, num_heads=4,
            num_layers=2)


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


def _lm(pkg, dropout=0.0, level=None, release=False):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        loss, _ = pkg.models.transformer.transformer_lm(dropout=dropout,
                                                        **DIMS)
        pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    opt = pkg.transpiler
    if level is not None:
        opt.memory_optimize(main, level=level)
    elif release:
        opt.release_memory(main)
    return main, start, loss


def _lm_feeds(n, b=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        toks = rng.randint(0, DIMS["vocab"], (b, DIMS["max_len"] + 1))
        out.append({"tokens": toks[:, :-1].astype("int64"),
                    "tokens@SEQLEN": np.array([8, 5, 8, 3], "int32"),
                    "targets": toks[:, 1:].astype("int64")})
    return out


def _jax_state(start):
    scope = pt.Scope()
    pt.Executor().run(start, scope=scope)
    return scope, {n: np.asarray(scope.get(n))
                   for n in scope.local_var_names()}


@pytest.mark.parametrize("how", ["level0", "level1", "release"])
def test_programs_equal_jax(how):
    kw = ({"release": True} if how == "release"
          else {"level": int(how[-1])})
    j = _lm(pt, **kw)[0]
    t = _lm(ptt, **kw)[0]
    assert t.to_json() == j.to_json()
    region = next(op for op in t.global_block().ops
                  if op.type == "vjp_region")
    assert region.attrs["live_out"]
    assert region.attrs.get("remat", False) == (how != "release")
    # skip_opt_set keeps a name the liveness pass would drop
    keep = t.global_block().ops[region.attrs["fwd_ops"][3]].output_names()[0]
    jm = _lm(pt)[0]
    tm = _lm(ptt)[0]
    jmemory_optimize(jm, skip_opt_set=[keep], level=1)
    memory_optimize(tm, skip_opt_set=[keep], level=1)
    jrelease_memory(jm)
    release_memory(tm)
    assert tm.to_json() == jm.to_json()


def _count_flash_forward(monkeypatch):
    calls = []
    real = flash_attention.flash_fwd_plain

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(flash_attention, "flash_fwd_plain", counted)
    return calls


def _port_run(main, start_state, feeds, fetch):
    scope = ptt.load_numpy_params(start_state, ptt.Scope(), ptt.CPUPlace())
    exe = ptt.Executor(ptt.CPUPlace())
    outs = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
            for f in feeds]
    return outs, {n: as_numpy(scope.get(n)) for n in start_state}


@pytest.mark.parametrize("level", [0, 1])
def test_lm_remat_step_matches_jax(level):
    jmain, jstart, jloss = _lm(pt, level=level)
    tmain, _, tloss = _lm(ptt, level=level)
    jscope, state = _jax_state(jstart)
    params = [p.name for p in tmain.all_parameters()]
    fetch = [tloss.name] + [n + "@GRAD" for n in params]
    feed = _lm_feeds(1)[0]
    j = pt.Executor().run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
    (t,), _ = _port_run(tmain, state, [feed], fetch)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    for n, tg, jg in zip(params, t[1:], j[1:]):
        np.testing.assert_allclose(
            tg, jg, atol=1e-5 * max(1.0, float(np.abs(jg).max())),
            err_msg=n)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("level", [0, 1])
def test_lm_remat_equals_plain_run(level, dropout, monkeypatch):
    """3 Adam steps bit-equal to the un-rematerialized run. Without
    dropout the attention is the fused op, whose forward runs 2 x layers
    times a step under remat (with attention dropout the LM takes the
    unfused chain)."""
    _, jstart, _ = _lm(pt, dropout=dropout)
    _, state = _jax_state(jstart)
    feeds = _lm_feeds(3, seed=1)
    calls = _count_flash_forward(monkeypatch)
    plain, _, loss = _lm(ptt, dropout=dropout)
    p_out, p_state = _port_run(plain, state, feeds, [loss.name])
    fused = 0 if dropout else 1
    assert len(calls) == fused * 3 * DIMS["num_layers"]
    del calls[:]
    remat, _, loss = _lm(ptt, dropout=dropout, level=level)
    r_out, r_state = _port_run(remat, state, feeds, [loss.name])
    assert len(calls) == fused * 2 * 3 * DIMS["num_layers"]
    np.testing.assert_array_equal(np.concatenate(r_out),
                                  np.concatenate(p_out))
    for n in state:
        np.testing.assert_array_equal(r_state[n], p_state[n], err_msg=n)
    if dropout:
        # control: torch.utils.checkpoint alone (its preserve_rng_state
        # does not cover the run's generator) recomputes with fresh masks,
        # and the gradients, so the parameters, come out different
        from torch.utils.checkpoint import checkpoint
        monkeypatch.setattr(
            lowering, "_checkpointed",
            lambda fn, ctx, policy: checkpoint(fn, use_reentrant=False))
        c_out, c_state = _port_run(remat, state, feeds, [loss.name])
        assert any(not np.array_equal(c_state[n], p_state[n])
                   for n in state)


def test_remat_segments_from_the_jax_planner():
    """The JAX package's memory planner segments the region; the port
    loads the planned program's JSON and runs it as one checkpointed
    function per segment."""
    from paddle_tpu.models import transformer as jtr
    jmain, jstart = pt.Program(), pt.Program()
    with pt.program_guard(jmain, jstart), pt.unique_name.guard():
        jloss, _ = jtr.transformer_lm(mean_loss=True, **DIMS)
        pt.optimizer.Adam(learning_rate=1e-2).minimize(jloss)
    planned = get_pass("memory_plan_pass", nominal_batch=4,
                       time_budget_s=1.0)(jmain)
    region = next(op for op in planned.global_block().ops
                  if op.type == "vjp_region")
    segs = region.attrs.get("remat_segments")
    assert segs and len(segs) > 1
    tplanned = ptt.Program.from_json(planned.to_json())
    tplain = ptt.Program.from_json(jmain.to_json())
    jscope, state = _jax_state(jstart)
    feeds = _lm_feeds(2, seed=2)
    p_out, p_state = _port_run(tplain, state, feeds, [jloss.name])
    calls = []
    real = lowering._checkpointed

    def counted(fn, ctx, policy):
        calls.append(policy)
        return real(fn, ctx, policy)
    lowering._checkpointed = counted
    try:
        s_out, s_state = _port_run(tplanned, state, feeds, [jloss.name])
    finally:
        lowering._checkpointed = real
    assert len(calls) == 2 * len(segs)
    jexe = pt.Executor()
    for f, s in zip(feeds, s_out):
        j, = jexe.run(planned, feed=f, fetch_list=[jloss], scope=jscope)
        np.testing.assert_allclose(s[0], j, rtol=1e-5)
    np.testing.assert_allclose(np.concatenate(s_out),
                               np.concatenate(p_out), rtol=1e-6)
    for n in state:
        np.testing.assert_allclose(s_state[n], p_state[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_live_out_narrows_what_the_region_publishes(monkeypatch):
    main, start, loss = _lm(ptt, release=True)
    region = next(op for op in main.global_block().ops
                  if op.type == "vjp_region")
    live = set(region.attrs["live_out"])
    produced = {n for i in region.attrs["fwd_ops"]
                for n in main.global_block().ops[i].output_names()}
    dead = sorted(produced - live)
    assert dead
    seen = {}
    real = lowering.run_vjp_region

    def spy(op, env, ctx):
        real(op, env, ctx)
        seen.update(keys=set(env))
    monkeypatch.setattr(lowering, "run_vjp_region", spy)
    _, jstart, _ = _lm(pt)
    _, state = _jax_state(jstart)
    _port_run(main, state, _lm_feeds(1), [loss.name])
    assert not set(dead) & seen["keys"]
    assert (produced & live) <= seen["keys"]
    # a fetched name is published whatever the liveness pass said
    (out,), _ = _port_run(main, state, _lm_feeds(1), [loss.name, dead[0]])
    assert dead[0] in seen["keys"] and out[1].size


def _resnet8(pkg, level=None):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        img = pkg.layers.data("img", shape=[16, 16, 3])
        loss, _, _ = pkg.models.resnet.resnet_cifar10(img=img, depth=8)
        pkg.optimizer.Momentum(learning_rate=0.05,
                               momentum=0.9).minimize(loss)
    if level is not None:
        pkg.transpiler.memory_optimize(main, level=level)
    return main, start, loss


@pytest.mark.parametrize("level", [0, 1])
def test_batch_norm_statistics_move_once_under_remat(level):
    rng = np.random.RandomState(4)
    feeds = [{"img": rng.rand(4, 16, 16, 3).astype("float32"),
              "label": rng.randint(0, 10, (4, 1)).astype("int64")}
             for _ in range(2)]
    jmain, jstart, jloss = _resnet8(pt, level)
    tmain, _, tloss = _resnet8(ptt, level)
    assert tmain.to_json() == jmain.to_json()
    jscope, state = _jax_state(jstart)
    plain = _resnet8(ptt)[0]
    p_out, p_state = _port_run(plain, state, feeds, [tloss.name])
    r_out, r_state = _port_run(tmain, state, feeds, [tloss.name])
    stats = [n for n in state if any(
        op.type == "batch_norm" and n in op.output_names()
        for op in tmain.global_block().ops)]
    assert len(stats) == 2 * 9
    for n in state:
        np.testing.assert_array_equal(r_state[n], p_state[n], err_msg=n)
    jexe = pt.Executor()
    for f in feeds:
        jexe.run(jmain, feed=f, fetch_list=[jloss], scope=jscope)
    for n in stats:
        jv = np.asarray(jscope.get(n))
        np.testing.assert_allclose(
            r_state[n], jv, rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(jv).max())), err_msg=n)
        assert not np.array_equal(r_state[n], state[n]), n


@pytest.mark.parametrize("level", [0, 1])
def test_sparse_region_under_remat(level):
    """A region with an is_sparse table runs un-segmented under one
    checkpoint, the perturbation inside it: DeepFM's sparse steps equal
    the un-rematerialized run's, and the JAX package's."""
    def build(pkg, remat):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss, _ = pkg.models.deepfm.deepfm(
                num_fields=5, vocab_size=500, embed_dim=8, fc_sizes=(32,),
                is_sparse=True)
            pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        if remat:
            pkg.transpiler.memory_optimize(main, level=level)
        return main, start, loss
    rng = np.random.RandomState(7)
    feeds = [{"feat_ids": rng.randint(0, 500, (16, 5)).astype("int64"),
              "feat_vals": rng.rand(16, 5).astype("float32"),
              "label": rng.randint(0, 2, (16, 1)).astype("float32")}
             for _ in range(3)]
    jmain, jstart, jloss = build(pt, True)
    tmain, _, tloss = build(ptt, True)
    assert tmain.to_json() == jmain.to_json()
    jscope, state = _jax_state(jstart)
    calls = []
    real = lowering._checkpointed

    def counted(fn, ctx, policy):
        calls.append(policy)
        return real(fn, ctx, policy)
    lowering._checkpointed = counted
    try:
        r_out, r_state = _port_run(tmain, state, feeds, [tloss.name])
    finally:
        lowering._checkpointed = real
    assert len(calls) == len(feeds)          # one checkpoint a step
    plain = build(ptt, False)[0]
    p_out, p_state = _port_run(plain, state, feeds, [tloss.name])
    np.testing.assert_array_equal(np.concatenate(r_out),
                                  np.concatenate(p_out))
    for n in state:
        np.testing.assert_array_equal(r_state[n], p_state[n], err_msg=n)
    jexe = pt.Executor()
    for f, t in zip(feeds, r_out):
        j, = jexe.run(jmain, feed=f, fetch_list=[jloss], scope=jscope)
        np.testing.assert_allclose(t[0], j, rtol=1e-6)
    for n in state:
        np.testing.assert_allclose(r_state[n], np.asarray(jscope.get(n)),
                                   rtol=1e-6, atol=1e-6, err_msg=n)


def test_remat_cuts_fall_between_sub_layers():
    """memory_optimize's region runs as about sqrt(n) checkpointed
    segments, cut where the fewest bytes cross (the residual stream)."""
    main, _, _ = _lm(ptt, level=1)
    block = main.global_block()
    region = next(op for op in block.ops if op.type == "vjp_region")
    segs = lowering._remat_cuts(region.attrs["fwd_ops"], block,
                                set(region.attrs["live_out"]))
    n = len(region.attrs["fwd_ops"])
    assert [i for s in segs for i in s] == list(region.attrs["fwd_ops"])
    assert len(segs) == round(n ** 0.5)
    carried = lowering.remat_boundaries(
        [[block.ops[i] for i in s] for s in segs],
        set(region.attrs["live_out"]))
    stream = DIMS["max_len"] * DIMS["d_model"] * 4     # one [T, D] float32
    for names in carried[:-1]:
        made = [m for m in names
                if not block.var(m).persistable]
        assert sum(lowering._var_bytes(block, m) for m in made) \
            <= 2 * stream, names
