"""The recurrent slice as a whole: the port's stacked LSTM classifier, LSTM
language model and GRU-attention NMT model trained against the JAX
package's.

Small models: `stacked_lstm_net` at dict 300, emb 16, hid 16, max_len 10,
batch 4 with lengths [10, 6, 2, 10] (the shape tests/test_fusion.py trains);
`lstm_language_model` at vocab 60, emb 16, hid 16, 2 layers, max_len 8;
NMT `train_net` at batch 4, Ts 6, Tt 5, vocab 50, embed 16, hidden 32 with
ragged source lengths. Both packages build the same program; the JAX
package's startup program initializes it and its persistable state carries
across with `load_numpy_params`; feeds come from a numpy seed; both
executors then take 3 Adam steps on the CPU, with the executor-time fusion
passes on (the port's plain versions stand in for its kernels there).

Tolerances, as tests/test_torch_training.py's float32 mode: losses at rtol
1e-5; gradients at 1e-5 of each gradient's largest element; parameters at
1e-6 + 1e-5 |p|, except where a step's gradient is below 1e-5 in
magnitude: Adam moves such an element by about lr·sign(g), and the sign of
a gradient that is zero up to rounding may differ, so there the bound is
2·lr per step.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.passes import apply_fusion_passes as japply
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import stacked_lstm as jsl

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework.executor import as_numpy
from paddle_tpu_torch.framework.passes import apply_fusion_passes as tapply
from paddle_tpu_torch.framework.program import Program as PortProgram
from paddle_tpu_torch.fusion import decode_attention as tda
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import stacked_lstm as tsl

LR = 1e-2
B, TS, TT, V = 4, 6, 5, 50


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh default programs, scope and name generator for the port; the
    fusion flags of both packages restored."""
    saved = {n: (jflags.get_flag(n), tflags.get_flag(n))
             for n in ("fuse_recurrent_cells", "fuse_decode_attention")}
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    for n, (jv, tv) in saved.items():
        jflags.set_flag(n, jv)
        tflags.set_flag(n, tv)


def _model(pkg, which):
    """(loss, names of the inputs) of `which` built in `pkg`."""
    if which == "stacked_lstm":
        mod = jsl if pkg is pt else tsl
        loss, _, _ = mod.stacked_lstm_net(dict_dim=300, emb_dim=16,
                                          hid_dim=16, max_len=10)
        return loss
    if which == "lstm_lm":
        mod = jsl if pkg is pt else tsl
        loss, _ = mod.lstm_language_model(vocab_size=60, emb_dim=16,
                                          hid_dim=16, num_layers=2,
                                          max_len=8)
        return loss
    mod = jmt if pkg is pt else tmt
    L = pkg.layers
    src = L.data("src", shape=[TS], dtype="int64")
    src_lens = L.data("src_lens", shape=[], dtype="int64")
    tgt_in = L.data("tgt_in", shape=[TT], dtype="int64")
    tgt_out = L.data("tgt_out", shape=[TT], dtype="int64")
    tgt_mask = L.data("tgt_mask", shape=[TT], dtype="float32")
    loss, _ = mod.train_net(src, src_lens, tgt_in, tgt_out, tgt_mask,
                            dict_size=V, embed_dim=16, hidden_dim=32)
    return loss


def _build(which, opt="Adam"):
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss = _model(pkg, which)
            getattr(pkg.optimizer, opt)(learning_rate=LR).minimize(loss)
        progs.append((main, start, loss.name))
    assert progs[0][2] == progs[1][2]
    return progs


def _feeds(which, n, seed=0):
    r = np.random.RandomState(seed)
    feeds = []
    for _ in range(n):
        if which == "stacked_lstm":
            feeds.append({"words": r.randint(0, 300, (B, 10)).astype("int64"),
                          "words@SEQLEN": np.array([10, 6, 2, 10], "int32"),
                          "label": r.randint(0, 2, (B, 1)).astype("int64")})
        elif which == "lstm_lm":
            feeds.append({"tokens": r.randint(0, 60, (B, 8)).astype("int64"),
                          "tokens@SEQLEN": np.array([8, 5, 1, 7], "int32"),
                          "targets": r.randint(0, 60, (B, 8))
                          .astype("int64")})
        else:
            tlen = np.array([[5], [2], [4], [1]])
            feeds.append({
                "src": r.randint(2, V, (B, TS)).astype("int64"),
                "src_lens": np.array([6, 3, 1, 5], "int64"),
                "tgt_in": r.randint(2, V, (B, TT)).astype("int64"),
                "tgt_out": r.randint(2, V, (B, TT)).astype("int64"),
                "tgt_mask": (np.arange(TT)[None] < tlen).astype("float32")})
    return feeds


def _train_both(which, steps=3):
    """`steps` Adam steps of both executors from the JAX package's initial
    state. Returns (param names, per-step (jax, port) fetches, final jax
    state, final port state)."""
    (jprog, jstart, loss), (tprog, _, _) = _build(which)
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    names = [p.name for p in tprog.all_parameters()]
    fetch = [loss] + [n + "@GRAD" for n in names]
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    outs = []
    for feed in _feeds(which, steps):
        jout = jexe.run(jprog, feed=feed, fetch_list=fetch, scope=jscope)
        tout = texe.run(tprog, feed=feed, fetch_list=fetch, scope=tscope)
        outs.append(([np.asarray(a, "float32") for a in jout], tout))
    jstate = {n: np.asarray(jscope.get(n), "float32") for n in state}
    tstate = {n: as_numpy(tscope.get(n)) for n in state}
    return names, outs, jstate, tstate


def _check(names, outs, jstate, tstate):
    tiny = {n: np.zeros(jstate[n].shape, bool) for n in names}
    for i, (jout, tout) in enumerate(outs):
        np.testing.assert_allclose(tout[0], jout[0], rtol=1e-5,
                                   err_msg=f"loss, step {i + 1}")
        for n, jg, tg in zip(names, jout[1:], tout[1:]):
            assert tg.shape == jg.shape, n
            np.testing.assert_allclose(
                tg, jg, rtol=0, atol=1e-5 * max(float(np.abs(jg).max()),
                                                1e-30),
                err_msg=f"{n}@GRAD, step {i + 1}")
            tiny[n] |= np.abs(jg) < 1e-5
    for n, jv in jstate.items():
        tol = 1e-6 + 1e-5 * np.abs(jv)
        if n in tiny:
            tol = tol + np.where(tiny[n], 2 * LR * len(outs), 0.0)
        assert (np.abs(tstate[n] - jv) <= tol).all(), \
            (n, float(np.abs(tstate[n] - jv).max()))


FUSED_TYPES = {
    "stacked_lstm": [
        ["lookup_table", "mul", "elementwise_add", "fused_lstm",
         "concat", "mul", "elementwise_add", "fused_lstm",
         "concat", "mul", "elementwise_add", "fused_lstm",
         "sequence_pool", "sequence_pool", "mul", "mul", "sum",
         "elementwise_add", "softmax_with_cross_entropy", "mean", "top_k",
         "accuracy", "vjp_region"] + ["adam"] * 16],
    "nmt": [
        ["lookup_table", "mul", "fused_gru", "sequence_mask",
         "sequence_last_step", "mul", "elementwise_add", "tanh",
         "lookup_table", "static_rnn", "mul", "elementwise_add", "reshape",
         "reshape", "softmax_with_cross_entropy", "reshape",
         "elementwise_mul", "reduce_sum", "reduce_sum", "scale",
         "elementwise_div", "vjp_region"] + ["adam"] * 15,
        ["unsqueeze", "scale", "unsqueeze", "fused_decode_attention",
         "squeeze", "concat", "mul", "mul", "elementwise_add",
         "elementwise_add", "sigmoid", "slice", "slice", "mul",
         "elementwise_mul", "mul", "elementwise_add", "elementwise_add",
         "tanh", "scale", "elementwise_mul", "elementwise_mul",
         "elementwise_add"]],
}


@pytest.mark.parametrize("which", ["stacked_lstm", "lstm_lm", "nmt"])
def test_programs_match_and_load_from_jax_json(which):
    (jprog, jstart, loss), (tprog, tstart, _) = _build(which)
    assert tprog.to_json() == jprog.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert PortProgram.from_json(jprog.to_json()).to_json() == \
        tprog.to_json()
    assert tprog.clone().to_json() == tprog.to_json()


@pytest.mark.parametrize("which", ["stacked_lstm", "lstm_lm", "nmt"])
def test_fusion_passes_give_the_jax_packages_ops(which):
    (jprog, _, loss), (tprog, _, _) = _build(which)
    jf = japply(jprog, protected=[loss])
    tf = tapply(tprog, protected=[loss])
    types = [[op.type for op in b.ops] for b in tf.blocks]
    assert types == [[op.type for op in b.ops] for b in jf.blocks]
    if which in FUSED_TYPES:
        assert types == FUSED_TYPES[which]
    assert tf.to_json() == jf.to_json()


@pytest.mark.parametrize("which", ["stacked_lstm", "lstm_lm", "nmt"])
def test_adam_steps_match_jax(which):
    _check(*_train_both(which))


def test_nmt_step_block_runs_the_fused_clone(monkeypatch):
    """The StaticRNN's step block is planned from the executor's fused
    clone, so the decoder's attention runs as fused_decode_attention: once
    per target position each run."""
    calls = []
    fused = tda.fused_decode_attention

    def counting(*a, **k):
        calls.append(a[0].shape)
        return fused(*a, **k)
    monkeypatch.setattr(tda, "fused_decode_attention", counting)
    _, (tprog, tstart, loss) = _build("nmt")
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(tstart, scope=scope)
    exe.run(tprog, feed=_feeds("nmt", 1)[0], fetch_list=[loss], scope=scope)
    assert calls == [(B, 1, 32)] * TT


@pytest.mark.parametrize("which", ["stacked_lstm", "nmt"])
def test_unfused_cpu_run_matches_fused(which):
    """With fuse_recurrent_cells off (and fuse_decode_attention off for the
    NMT model) the CPU runs the unfused ops; losses, gradients and
    parameters agree with the fused run over 3 SGD steps (SGD, not Adam:
    a sign flip of a gradient that is zero up to rounding would move an
    Adam parameter by lr and perturb the next step's gradients beyond
    float32 rounding)."""
    runs = []
    for fuse in (True, False):
        tflags.set_flag("fuse_recurrent_cells", fuse)
        tflags.set_flag("fuse_decode_attention", fuse)
        _, (tprog, tstart, loss) = _build(which, opt="SGD")
        scope = ptt.Scope()
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(tstart, scope=scope)
        names = [p.name for p in tprog.all_parameters()]
        outs = [exe.run(tprog, feed=f, fetch_list=[loss] + [
            n + "@GRAD" for n in names], scope=scope)
            for f in _feeds(which, 3)]
        runs.append((names, outs, {n: as_numpy(scope.get(n))
                                   for n in names}))
    (names, fused, fstate), (_, unfused, ustate) = runs
    _check(names, [([np.asarray(a) for a in f], u)
                   for f, u in zip(fused, unfused)], fstate, ustate)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("seq_lens", [False, True])
def test_static_rnn_lengths_and_reverse_match_jax(seq_lens, reverse):
    """The static_rnn op's SeqLens branch (memories freeze and outputs are
    zeroed past each row's length) and is_reverse branch, through both
    executors: outputs and final memories at 1e-6."""
    def build(pkg):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            L = pkg.layers
            x = L.data("x", shape=[5, 3], dtype="float32")
            h0 = L.data("h0", shape=[4], dtype="float32")
            lens = L.data("lens", shape=[], dtype="int64")
            rnn = L.StaticRNN()
            if seq_lens:
                rnn.set_sequence_lengths(lens)
            with rnn.step():
                xt = rnn.step_input(x)
                hp = rnn.memory(init=h0)
                h = L.tanh(L.elementwise_add(L.fc(xt, size=4), hp))
                rnn.update_memory(hp, h)
                rnn.step_output(h)
            outs = [rnn(), rnn.final_memories()]
        op = next(o for o in main.global_block().ops
                  if o.type == "static_rnn")
        op.attrs["is_reverse"] = reverse
        return main, start, [v.name for v in outs]
    (jmain, jstart, names), (tmain, _, tnames) = build(pt), build(ptt)
    assert names == tnames and tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    tscope = ptt.load_numpy_params(
        {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()},
        ptt.Scope(), ptt.CPUPlace())
    r = np.random.RandomState(9)
    feed = {"x": r.randn(3, 5, 3).astype("float32"),
            "h0": r.randn(3, 4).astype("float32"),
            "lens": np.array([5, 2, 0], "int64")}
    jout = pt.Executor().run(jmain, feed=feed, fetch_list=names,
                             scope=jscope)
    tout = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                            fetch_list=names, scope=tscope)
    for n, a, b in zip(names, tout, jout):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, err_msg=n)
