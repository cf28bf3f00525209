"""Sequence labelling: the port's `linear_chain_crf`, `crf_decoding` and
`chunk_eval` against the JAX package's ops and a numpy dynamic program,
and the BiLSTM-CRF flow of tests/test_book.py (label semantic roles)
through both packages.

Small sizes: the ops on [4, 6, 5] emissions with lengths 6, 3, 1 and 0;
the flow at batch 4, T 7, vocabulary 30, 5 tags, word embedding 8 and
hidden 16 per direction, ragged lengths, 3 Adam steps from the JAX
package's initial state (carried with `load_numpy_params`), with the
recurrent cells fused (the port's plain K5 on the CPU) and unfused. Losses
and every gradient at 1e-5 relative (to each gradient's largest element);
Viterbi paths and the chunk counts exactly. chunk_eval's cases of
tests/test_sequence_labeling.py run as parity cases in
tests/test_torch_ops.py.
"""

import numpy as np
import pytest
import torch
from scipy.special import logsumexp as np_lse

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework import registry as jreg

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.executor import as_numpy


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = (jflags.get_flag("fuse_recurrent_cells"),
             tflags.get_flag("fuse_recurrent_cells"))
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    jflags.set_flag("fuse_recurrent_cells", saved[0])
    tflags.set_flag("fuse_recurrent_cells", saved[1])


def np_crf_nll(emission, transition, label, length):
    """tests/test_sequence_labeling.py's numpy forward algorithm."""
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    out = np.zeros((emission.shape[0], 1))
    for b in range(emission.shape[0]):
        n = int(length[b])
        e = emission[b, :n].astype(np.float64)
        lab = label[b, :n]
        alpha = start_w + e[0]
        for t in range(1, n):
            alpha = np_lse(alpha[:, None] + trans, axis=0) + e[t]
        score = start_w[lab[0]] + e[np.arange(n), lab].sum() + end_w[lab[-1]]
        for t in range(1, n):
            score += trans[lab[t - 1], lab[t]]
        out[b, 0] = np_lse(alpha + end_w) - score
    return out


def np_viterbi(emission, transition, length):
    start_w, end_w, trans = transition[0], transition[1], transition[2:]
    b_, t_, d = emission.shape
    paths = np.zeros((b_, t_), dtype=np.int64)
    for b in range(b_):
        n = int(length[b])
        e = emission[b, :n].astype(np.float64)
        v = start_w + e[0]
        bp = np.zeros((n, d), dtype=int)
        for t in range(1, n):
            scores = v[:, None] + trans
            bp[t] = np.argmax(scores, axis=0)
            v = scores.max(axis=0) + e[t]
        tag = int(np.argmax(v + end_w))
        seq = [tag]
        for t in range(n - 1, 0, -1):
            tag = bp[t][tag]
            seq.append(tag)
        paths[b, :n] = seq[::-1]
    return paths


R = np.random.RandomState(11)
EMISSION = R.randn(4, 6, 5).astype("float32")
TRANSITION = (R.randn(7, 5) * 0.5).astype("float32")
LABEL = R.randint(0, 5, (4, 6)).astype("int64")
LENGTH = np.array([6, 3, 1, 6], "int64")


def test_crf_nll_and_gradients_match_jax_and_numpy():
    w = R.randn(4, 1).astype("float32")    # weights the rows' losses

    def jloss(e, tr):
        out = jreg.lookup_op("linear_chain_crf").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"Emission": [e], "Transition": [tr],
             "Label": [jnp.asarray(LABEL)], "Length": [jnp.asarray(LENGTH)]},
            {})
        return (out["LogLikelihood"][0] * w).sum(), out["LogLikelihood"][0]

    (_, jnll), (jge, jgt) = (
        jloss(jnp.asarray(EMISSION), jnp.asarray(TRANSITION)),
        jax.grad(lambda e, tr: jloss(e, tr)[0], argnums=(0, 1))(
            jnp.asarray(EMISSION), jnp.asarray(TRANSITION)))
    e = torch.tensor(EMISSION, requires_grad=True)
    tr = torch.tensor(TRANSITION, requires_grad=True)
    out = treg.lookup_op("linear_chain_crf").lower(
        treg.LowerCtx(), {"Emission": [e], "Transition": [tr],
                          "Label": [torch.tensor(LABEL)],
                          "Length": [torch.tensor(LENGTH)]}, {})
    nll = out["LogLikelihood"][0]
    (nll * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        nll.detach().numpy(), np_crf_nll(EMISSION, TRANSITION, LABEL,
                                         LENGTH), rtol=1e-5, atol=1e-5)
    for got, want in ((e.grad, jge), (tr.grad, jgt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_crf_decoding_matches_numpy_viterbi():
    length = LENGTH[:3]
    out = treg.lookup_op("crf_decoding").lower(
        treg.LowerCtx(), {"Emission": [torch.tensor(EMISSION[:3])],
                          "Transition": [torch.tensor(TRANSITION)],
                          "Length": [torch.tensor(length)]}, {})
    path = out["ViterbiPath"][0].numpy()
    np.testing.assert_array_equal(path, np_viterbi(EMISSION[:3], TRANSITION,
                                                   length))
    # with the decoded path as the label, every position in a row is 1
    ok = treg.lookup_op("crf_decoding").lower(
        treg.LowerCtx(), {"Emission": [torch.tensor(EMISSION[:3])],
                          "Transition": [torch.tensor(TRANSITION)],
                          "Length": [torch.tensor(length)],
                          "Label": [torch.tensor(path)]},
        {})["ViterbiPath"][0].numpy()
    for b, n in enumerate(length):
        assert (ok[b, :n] == 1).all() and (ok[b, n:] == 0).all()


# ---- the BiLSTM-CRF flow (tests/test_book.py:178-243) ----------------------

FB, FT, FV, FNT, FEMB, FH = 4, 7, 30, 5, 8, 16
LR = 5e-3


def _bilstm_crf(pkg):
    """embedding -> fc -> dynamic_lstm forward and reverse -> fc emission
    -> linear_chain_crf; crf_decoding and chunk_eval over the same
    emission and the shared transition parameter."""
    L = pkg.layers
    seq = L.sequence
    words = L.data("words", shape=[FT], dtype="int64", lod_level=1)
    label = L.data("label", shape=[FT], dtype="int64")
    length = seq.get_seqlen(words)
    emb = seq.tag_sequence(L.embedding(words, size=[FV, FEMB]), length)
    fwd_in = seq.tag_sequence(
        L.fc(emb, size=FH * 4, num_flatten_dims=2), length)
    bwd_in = seq.tag_sequence(
        L.fc(emb, size=FH * 4, num_flatten_dims=2), length)
    fwd, _ = seq.dynamic_lstm(fwd_in, size=FH * 4)
    bwd, _ = seq.dynamic_lstm(bwd_in, size=FH * 4, is_reverse=True)
    hidden = seq.tag_sequence(L.concat([fwd, bwd], axis=2), length)
    emission = L.fc(hidden, size=FNT, num_flatten_dims=2)
    crf_cost = L.linear_chain_crf(emission, label, length,
                                  param_attr=pkg.ParamAttr(name="srl_crfw"))
    loss = L.mean(crf_cost)
    pkg.optimizer.Adam(learning_rate=LR).minimize(loss)
    path = seq.crf_decoding(emission, length,
                            param_attr=pkg.ParamAttr(name="srl_crfw"))
    _, _, f1, n_inf, n_lab, n_cor = seq.chunk_eval(
        path, label, length, chunk_scheme="plain", num_chunk_types=FNT)
    return loss, [path, f1, n_inf, n_lab, n_cor]


def _flow_programs():
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss, evals = _bilstm_crf(pkg)
        progs.append((main, start, loss.name, [v.name for v in evals]))
    return progs


def _flow_feeds(n):
    r = np.random.RandomState(5)
    feeds = []
    for _ in range(n):
        w = r.randint(0, FV, (FB, FT)).astype("int64")
        feeds.append({"words": w,
                      "words@SEQLEN": np.array([7, 4, 1, 6], "int32"),
                      "label": (w % FNT).astype("int64")})
    return feeds


def test_bilstm_crf_programs_match():
    (jmain, jstart, _, _), (tmain, tstart, _, _) = _flow_programs()
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    types = [op.type for op in tmain.global_block().ops]
    for t in ("linear_chain_crf", "crf_decoding", "chunk_eval"):
        assert types.count(t) == 1
    # crf_decoding reads the transition linear_chain_crf trains
    crf = {op.type: op for op in tmain.global_block().ops}
    assert crf["crf_decoding"].inputs["Transition"] == \
        crf["linear_chain_crf"].inputs["Transition"] == ["srl_crfw"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_bilstm_crf_steps_match_jax(fused):
    """3 Adam steps from the same state: the loss and every parameter's
    gradient each step; then Viterbi decoding and chunk_eval on a fresh
    batch, exactly."""
    jflags.set_flag("fuse_recurrent_cells", fused)
    tflags.set_flag("fuse_recurrent_cells", fused)
    (jmain, jstart, loss, evals), (tmain, _, _, _) = _flow_programs()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    names = [p.name for p in tmain.all_parameters()]
    fetch = [loss] + [n + "@GRAD" for n in names]
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    losses = []
    *feeds, held = _flow_feeds(4)
    for i, feed in enumerate(feeds):
        jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        tout = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(tout[0], np.asarray(jout[0]), rtol=1e-5,
                                   err_msg=f"loss, step {i + 1}")
        for n, jg, tg in zip(names, jout[1:], tout[1:]):
            jg = np.asarray(jg)
            np.testing.assert_allclose(
                tg, jg, rtol=0, atol=1e-5 * max(float(np.abs(jg).max()),
                                                1e-30),
                err_msg=f"{n}@GRAD, step {i + 1}")
        losses.append(float(tout[0]))
    jout = jexe.run(jmain, feed=held, fetch_list=evals, scope=jscope)
    tout = texe.run(tmain, feed=held, fetch_list=evals, scope=tscope)
    for n, a, b in zip(evals, tout, jout):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=n)


def test_bilstm_crf_fuses_both_directions_into_k5():
    """The executor's fused clone runs both LSTMs as fused_lstm (K5 on a
    card), the reverse one included."""
    _, (tmain, _, loss, evals) = _flow_programs()
    from paddle_tpu_torch.framework.passes import apply_fusion_passes
    fused = apply_fusion_passes(tmain, protected=[loss] + evals)
    ops = [op for op in fused.global_block().ops if op.type == "fused_lstm"]
    assert [op.attrs.get("is_reverse", False) for op in ops] == \
        [False, True]


def test_bilstm_crf_loss_falls_and_decodes():
    """The book flow's claim at test size: the loss falls over Adam steps
    on the learnable rule, and the decoded tags agree with it more often
    than chance."""
    _, (tmain, tstart, loss, evals) = _flow_programs()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(tstart, scope=scope)
    feeds = _flow_feeds(1) * 40
    first = float(exe.run(tmain, feed=feeds[0], fetch_list=[loss],
                          scope=scope)[0])
    for feed in feeds[1:]:
        last = float(exe.run(tmain, feed=feed, fetch_list=[loss],
                             scope=scope)[0])
    assert last < first * 0.5, (first, last)
    path, f1 = exe.run(tmain, feed=feeds[0], fetch_list=evals[:2],
                       scope=scope)
    lens = feeds[0]["words@SEQLEN"]
    valid = np.arange(FT)[None] < lens[:, None]
    acc = (as_numpy(path) == feeds[0]["label"])[valid].mean()
    assert acc > 0.5 and 0.0 <= float(f1[0]) <= 1.0


def test_bilstm_crf_defaults_to_the_card():
    """Without a place the executor that trains the flow targets
    CUDAPlace(0), which raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _bilstm_crf(ptt)
    with pytest.raises(UnavailableError):
        ptt.Executor().run(ptt.default_startup_program())


# ---- the rest of the recurrent and sequence layers -------------------------

def _lstmp(pkg):
    L = pkg.layers
    x = L.data("x", shape=[5, 4], lod_level=1, stop_gradient=False)
    proj_in = L.sequence.tag_sequence(
        L.fc(x, size=32, num_flatten_dims=2), L.sequence.get_seqlen(x))
    proj, cell = L.sequence.dynamic_lstmp(
        proj_in, size=32, proj_size=6, proj_activation="tanh",
        param_attr=pkg.ParamAttr(name="lstmp_w"), is_reverse=True)
    return [proj, cell]


def _cells(pkg):
    L = pkg.layers
    x = L.data("x", shape=[4], stop_gradient=False)
    h0 = L.data("h0", shape=[8], stop_gradient=False)
    hid, c = L.lstm_unit(L.fc(x, size=32), h0, forget_bias=1.0)
    new_h, reset, gate = L.gru_unit(L.fc(x, size=24), h0, size=24)
    return [hid, c, new_h, reset, gate]


def _sequences(pkg):
    L = pkg.layers
    seq = L.sequence
    x = L.data("x", shape=[5, 4], lod_level=1)
    s = L.data("s", shape=[5], lod_level=1)
    ids = L.data("ids", shape=[5], dtype="int64", lod_level=1)
    off = L.data("off", shape=[1], dtype="int64")
    padded, length = seq.sequence_pad(x)
    return [seq.sequence_softmax(s), seq.sequence_first_step(x),
            seq.sequence_reverse(x),
            seq.sequence_expand(seq.sequence_last_step(x), x),
            seq.sequence_concat([x, seq.sequence_reverse(x)]),
            seq.sequence_slice(x, off, 2), padded, length,
            seq.sequence_erase(ids, tokens=[2, 3]),
            seq.sequence_reshape(x, new_dim=2),
            seq.lod_reset(x, y=s), seq.max_sequence_len(x)]


LAYER_FEEDS = {
    "dynamic_lstmp": (_lstmp, lambda r: {
        "x": r.randn(3, 5, 4).astype("float32"),
        "x@SEQLEN": np.array([5, 2, 0], "int32")}),
    "lstm_unit_gru_unit": (_cells, lambda r: {
        "x": r.randn(3, 4).astype("float32"),
        "h0": r.randn(3, 8).astype("float32")}),
    "sequence_layers": (_sequences, lambda r: {
        "x": r.randn(3, 5, 4).astype("float32"),
        "x@SEQLEN": np.array([5, 2, 0], "int32"),
        "s": r.randn(3, 5).astype("float32"),
        "s@SEQLEN": np.array([4, 1, 5], "int32"),
        "ids": r.randint(0, 5, (3, 5)).astype("int64"),
        "ids@SEQLEN": np.array([5, 5, 3], "int32"),
        "off": np.array([[0], [1], [3]], "int64")}),
}


@pytest.mark.parametrize("name", sorted(LAYER_FEEDS))
def test_layers_match_jax(name):
    """The layers build the JAX package's program; its outputs and, where
    it trains, every parameter's gradient of the outputs' mean agree at
    1e-5."""
    make, feed_of = LAYER_FEEDS[name]
    built = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            outs = make(pkg)
            floats = [o for o in outs if "float" in str(o.dtype)]
            params = main.all_parameters()
            if params:
                loss = pkg.layers.mean(pkg.layers.concat(
                    [pkg.layers.reshape(o, [-1]) for o in floats], axis=0))
                pkg.optimizer.SGD(learning_rate=0.0).minimize(loss)
                outs = outs + [loss]
        built.append((main, start, [o.name for o in outs]
                      + [p.name + "@GRAD" for p in params]))
    (jmain, jstart, names), (tmain, _, tnames) = built
    assert tnames == names
    assert tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    feed = feed_of(np.random.RandomState(8))
    jout = pt.Executor().run(jmain, feed=feed, fetch_list=names,
                             scope=jscope)
    tout = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                            fetch_list=names, scope=tscope)
    for n, a, b in zip(names, tout, jout):
        b = np.asarray(b)
        assert a.shape == b.shape, n
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=n)
