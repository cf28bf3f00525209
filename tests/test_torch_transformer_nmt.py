"""The encoder-decoder Transformer (`models.transformer.transformer`) in the
port against the JAX package's, at 2 layers and d_model 32 (vocab 50 / 60,
max_len 8, 4 heads, batch 4).

- The programs are equal through `to_json` (training with dropout, label
  smoothing, noam and Adam; dropout 0; the is_test inference program).
- Dropout 0 with label smoothing 0.1 and noam_decay, 3 Adam steps through
  both executors in float32 mode (use_bf16_matmul off in both), each step
  from the same state: losses at rtol 1e-5, gradients at 1e-5 of each
  gradient's largest element (sums in another order), parameters at
  1e-6 + rtol 1e-5 except where the gradient the update applied (after clipping and weight decay, in the variant that
  has them) was below 1e-5: there Adam moves an element by about
  lr·sign(g), or near its epsilon in proportion to g, so rounding-level
  differences move it by up to 2·lr. The step counter agrees each step.
- Dropout 0.1 at `is_test`: the logits agree at 1e-5 (float32 mode).
- Dropout 0.1 in training (the masks differ between packages, so the port
  alone): the loss falls over 30 Adam steps on one batch.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework.executor import as_numpy
from paddle_tpu_torch.models import transformer as ttr

from tests.port_env import port_jax_compile_cache  # noqa: F401

DIMS = dict(src_vocab=50, tgt_vocab=60, max_len=8, d_model=32, d_inner=64,
            num_heads=4, num_layers=2)
B = 4
COUNTER = "@LR_DECAY_COUNTER@1@"


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = (jflags.get_flag("use_bf16_matmul"),
             tflags.get_flag("use_bf16_matmul"))
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    jflags.set_flag("use_bf16_matmul", saved[0])
    tflags.set_flag("use_bf16_matmul", saved[1])


def _float32_mode():
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)


def _build(pkg, mod, dropout=0.1, is_test=False, label_smooth=0.1,
           train=True, clip_l2=False, lr=None):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        loss, logits = mod.transformer(dropout=dropout, is_test=is_test,
                                       label_smooth=label_smooth, **DIMS)
        if train:
            reg = None
            if clip_l2:
                pkg.clip.set_gradient_clip(
                    pkg.clip.GradientClipByGlobalNorm(1.0))
                reg = pkg.regularizer.L2Decay(1e-4)
            rate = lr if lr is not None else pkg.layers.noam_decay(
                DIMS["d_model"], 10)
            pkg.optimizer.Adam(learning_rate=rate, beta2=0.98,
                               epsilon=1e-9,
                               regularization=reg).minimize(loss)
    return main, start, loss, logits


def _feed(rng):
    t, vs, vt = DIMS["max_len"], DIMS["src_vocab"], DIMS["tgt_vocab"]
    src = rng.randint(2, vs, (B, t)).astype("int64")
    out = (src + 5) % vt
    tgt = np.concatenate([np.zeros((B, 1), "int64"), out[:, :-1]], axis=1)
    return {"src": src, "src@SEQLEN": np.array([t, 5, 3, t], "int32"),
            "tgt": tgt, "tgt@SEQLEN": np.array([t, 6, 2, 7], "int32"),
            "lbl": out}


def _carry(jstart):
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    return jscope, ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())


@pytest.mark.parametrize("kw", [
    {}, {"dropout": 0.0}, {"is_test": True, "train": False},
    {"label_smooth": 0.0}, {"clip_l2": True}],
    ids=["train", "dropout0", "is_test", "no_smoothing", "clip_l2"])
def test_programs_equal_jax(kw):
    j = _build(pt, jtr, **kw)
    t = _build(ptt, ttr, **kw)
    assert j[0].to_json() == t[0].to_json()
    assert j[1].to_json() == t[1].to_json()
    assert j[2].name == t[2].name and j[3].name == t[3].name
    types = [op.type for op in t[0].global_block().ops]
    if kw.get("dropout", 0.1) and not kw.get("is_test"):
        assert "dropout" in types
    if not kw.get("is_test") and kw.get("label_smooth", 0.1):
        assert "reduce_mean" in types and "log_softmax" in types


@pytest.mark.parametrize("clip_l2", [False, True], ids=["adam", "clip_l2"])
def test_three_adam_steps_match_jax_float32(clip_l2):
    """Each step starts both packages from the same state (the JAX
    package's, carried across after the comparison): a rounding-level
    difference that Adam turns into a visible move of a tiny-gradient
    element would otherwise change the next step's forward, and the
    comparison would measure that instead of the step."""
    _float32_mode()
    jmain, jstart, jloss, _ = _build(pt, jtr, dropout=0.0, clip_l2=clip_l2)
    tmain, _, tloss, _ = _build(ptt, ttr, dropout=0.0, clip_l2=clip_l2)
    jscope, tscope = _carry(jstart)
    names = [p.name for p in tmain.all_parameters()]
    applied = {op.outputs["ParamOut"][0]: op.inputs["Grad"][0]
               for op in tmain.global_block().ops if "ParamOut" in op.outputs}
    fetch = ([tloss.name] + [n + "@GRAD" for n in names]
             + [applied[n] for n in names])
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    rng = np.random.RandomState(0)
    k = len(names)
    for step in (1, 2, 3):
        feed = _feed(rng)
        jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        tout = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(tout[0], np.asarray(jout[0]), rtol=1e-5)
        for n, jg, tg in zip(names, jout[1:k + 1], tout[1:k + 1]):
            jg = np.asarray(jg)
            np.testing.assert_allclose(
                tg, jg, rtol=0, atol=1e-5 * max(1.0, np.abs(jg).max()),
                err_msg=n)
        tiny = {n: np.abs(ta) < 1e-5 for n, ta in zip(names, tout[k + 1:])}
        assert int(np.asarray(jscope.get(COUNTER))[0]) == step == \
            int(as_numpy(tscope.get(COUNTER))[0])
        lr = DIMS["d_model"] ** -0.5 * step * 10 ** -1.5
        for n in names:
            got, want = as_numpy(tscope.get(n)), np.asarray(jscope.get(n))
            tol = np.where(tiny[n], 2 * lr, 0.0) + 1e-6 + 1e-5 * np.abs(want)
            assert (np.abs(got - want) <= tol).all(), (step, n)
        state = {n: np.asarray(jscope.get(n))
                 for n in jscope.local_var_names()}
        tscope = ptt.load_numpy_params(state, tscope, ptt.CPUPlace())


def test_is_test_logits_match_jax_float32():
    """Dropout 0.1 at inference: every dropout site scales by 0.9 and the
    attention takes the fused route (K1 on the card), in both packages."""
    _float32_mode()
    jmain, jstart, _, jlogits = _build(pt, jtr, is_test=True, train=False)
    tmain, _, _, tlogits = _build(ptt, ttr, is_test=True, train=False)
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fused_attention") == 3 * DIMS["num_layers"]
    assert "softmax" not in types
    jscope, tscope = _carry(jstart)
    feed = _feed(np.random.RandomState(1))
    jl, = pt.Executor().run(jmain, feed=feed, fetch_list=[jlogits],
                            scope=jscope)
    tl, = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=[tlogits],
                                           scope=tscope)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=1e-5)


def test_dropout_training_loss_falls():
    tmain, tstart, tloss, _ = _build(ptt, ttr, dropout=0.1, lr=5e-3)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(tstart, scope=scope)
    feed = _feed(np.random.RandomState(2))
    losses = [float(exe.run(tmain, feed=feed, fetch_list=[tloss],
                            scope=scope)[0]) for _ in range(30)]
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.5, losses
