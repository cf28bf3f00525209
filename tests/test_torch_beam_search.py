"""Beam-search translation: the port's `beam_search` / `gather_tree` ops,
`contrib.BeamSearchDecoder` and `machine_translation.infer_net` against
the JAX package's.

Small sizes: the ops on crafted [B, K, V] inputs; the decoder over a toy
step function (B 3, K 3, V 7, 6 steps); `infer_net` at
tests/test_machine_translation.py's test width (B 8, Ts 5, K 3, V 24,
embed 16, hidden 32, 5 decode steps) with ragged sources. The NMT
parameters are trained by the JAX package (10 Adam steps) and carried
across with `load_numpy_params`; both executors decode on the CPU with the
fusion passes on. Scores are held at 1e-5; sequences must be equal (the
issue's tie rule would allow a parting at a step whose two competing
totals lie within 1e-5; none parts here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.contrib import decoder as jdec
from paddle_tpu.framework.passes import apply_fusion_passes as japply
from paddle_tpu.models import machine_translation as jmt

import paddle_tpu_torch as ptt
from paddle_tpu_torch.contrib import decoder as tdec
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.passes import apply_fusion_passes as tapply
from paddle_tpu_torch.framework.program import Program as PortProgram
from paddle_tpu_torch.models import machine_translation as tmt

B, TS, TT, V, K = 8, 5, 5, 24, 3
EMBED, HIDDEN = 16, 32
BOS, EOS = 0, 1


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _lower(op_type, ins, attrs):
    t = {s: [torch.as_tensor(np.asarray(a)) for a in v]
         for s, v in ins.items()}
    out = treg.lookup_op(op_type).lower(treg.LowerCtx(), t, attrs)
    return {s: [v.numpy() for v in vs] for s, vs in out.items()}


# ---- beam_search and gather_tree on crafted inputs -------------------------

def test_beam_search_takes_the_top_k_across_beams():
    scores = np.log(np.array([[[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]]],
                             "float32"))
    out = _lower("beam_search",
                 {"PreIds": [np.array([[2, 0]])],
                  "PreScores": [np.array([[-1.0, -0.5]], "float32")],
                  "Scores": [scores]}, {"beam_size": 2, "end_id": 9})
    totals = (np.array([[-1.0], [-0.5]]) + scores[0]).reshape(-1)
    best = np.argsort(-totals, kind="stable")[:2]
    np.testing.assert_array_equal(out["SelectedIds"][0][0], best % 3)
    np.testing.assert_array_equal(out["ParentIdx"][0][0], best // 3)
    np.testing.assert_allclose(out["SelectedScores"][0][0], totals[best],
                               rtol=1e-6)


def test_beam_search_freezes_a_finished_beam():
    """Beam 0 ended (its id is end_id 1): its only continuation is end_id
    at its own score, which beats beam 1's continuations."""
    out = _lower("beam_search",
                 {"PreIds": [np.array([[1, 3]])],
                  "PreScores": [np.array([[-0.2, -3.0]], "float32")],
                  "Scores": [np.log(np.full((1, 2, 4), 0.25, "float32"))]},
                 {"beam_size": 2, "end_id": 1})
    assert out["SelectedIds"][0][0].tolist() == [1, 0]
    assert out["ParentIdx"][0][0].tolist() == [0, 1]
    np.testing.assert_allclose(out["SelectedScores"][0][0, 0], -0.2)


def test_beam_search_ties_go_to_the_lower_flat_index():
    out = _lower("beam_search",
                 {"PreIds": [np.array([[4, 4, 4]])],
                  "PreScores": [np.zeros((1, 3), "float32")],
                  "Scores": [np.zeros((1, 3, 5), "float32")]},
                 {"beam_size": 3, "end_id": 1})
    assert out["ParentIdx"][0][0].tolist() == [0, 0, 0]
    assert out["SelectedIds"][0][0].tolist() == [0, 1, 2]


def test_beam_search_with_one_beam_is_greedy():
    scores = np.log(np.array([[[0.2, 0.5, 0.3]], [[0.7, 0.1, 0.2]]],
                             "float32"))
    out = _lower("beam_search",
                 {"PreIds": [np.array([[0], [2]])],
                  "PreScores": [np.zeros((2, 1), "float32")],
                  "Scores": [scores]}, {"beam_size": 1, "end_id": 9})
    assert out["SelectedIds"][0][:, 0].tolist() == [1, 0]
    assert out["ParentIdx"][0].tolist() == [[0], [0]]


def test_gather_tree_backtracks_parent_pointers():
    # beam 1 at t=2: token 10, parent 1 -> t=1 beam 1 token 8, parent 0
    # -> t=0 beam 0 token 5 (the JAX package's book test case)
    ids = np.array([[[5, 6, 7], [1, 8, 9], [3, 10, 4]]], "int64")
    parents = np.array([[[0, 0, 0], [2, 0, 1], [0, 1, 2]]], "int64")
    out = _lower("gather_tree", {"Ids": [ids], "Parents": [parents]}, {})
    seq = out["Out"][0]
    assert seq[0, :, 1].tolist() == [5, 8, 10]
    assert seq[0, :, 0].tolist() == [7, 1, 3]
    assert seq[0, :, 2].tolist() == [6, 9, 4]


# ---- BeamSearchDecoder over a toy step function ----------------------------

TOY_B, TOY_K, TOY_V, TOY_T, TOY_H = 3, 3, 7, 6, 4


def _toy_decode(pkg, dec_mod):
    """A decoder whose step mixes an fc of its [B, K, H] state with an
    embedding of the previous ids."""
    L = pkg.layers
    x = L.data("x", shape=[TOY_H], dtype="float32")
    decoder = dec_mod.BeamSearchDecoder(beam_size=TOY_K, bos_id=0, eos_id=2,
                                        max_len=TOY_T)

    def step(states, ids_prev):
        e = L.embedding(L.unsqueeze(ids_prev, axes=[2]),
                        size=[TOY_V, TOY_H],
                        param_attr=pkg.ParamAttr(name="toy_emb"))
        h = L.tanh(L.elementwise_add(
            L.fc(states["h"], size=TOY_H, num_flatten_dims=2, name="toy_h"),
            e))
        logits = L.fc(h, size=TOY_V, num_flatten_dims=2, name="toy_out")
        return {"h": h}, L.log_softmax(logits)

    return decoder.decode(x, {"h": decoder.expand_to_beams(x)}, step)


def _build_both(make):
    built = []
    for pkg, extra in ((pt, jdec), (ptt, tdec)):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            outs = make(pkg, extra)
        built.append((main, start, [o.name for o in outs]))
    return built


def _run_both(built, feed, jstate=None):
    (jmain, jstart, names), (tmain, _, tnames) = built
    assert names == tnames
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    if jstate is not None:
        state.update(jstate)
        for n, v in jstate.items():
            jscope.set_var(n, jnp.asarray(v))
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    jout = pt.Executor().run(jmain, feed=feed, fetch_list=names,
                             scope=jscope)
    tout = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                            fetch_list=names, scope=tscope)
    return [np.asarray(a) for a in jout], tout


def test_beam_search_decoder_matches_jax():
    built = _build_both(_toy_decode)
    assert built[1][0].to_json() == built[0][0].to_json()
    feed = {"x": np.random.RandomState(3).randn(TOY_B, TOY_H)
            .astype("float32")}
    (jseq, jsc), (tseq, tsc) = _run_both(built, feed)
    assert tseq.shape == (TOY_B, TOY_T, TOY_K)
    np.testing.assert_array_equal(tseq, jseq)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
    assert (np.diff(tsc, axis=1) <= 0).all()


def test_gather_beams_refuses_integer_state():
    x = ptt.layers.data("x", shape=[K], dtype="int64")
    parent = ptt.layers.data("p", shape=[K], dtype="int64")
    with pytest.raises(Exception, match="float states"):
        tdec.gather_beams(x, parent)


# ---- infer_net at test width ----------------------------------------------

def _toy_batch(seed):
    r = np.random.RandomState(seed)
    src = r.randint(4, V, (B, TS)).astype("int64")
    tgt = np.concatenate([src[:, :TT - 1], np.full((B, 1), EOS)], 1)
    tgt_in = np.concatenate([np.full((B, 1), BOS), tgt[:, :-1]], 1)
    lens = np.array([5, 3, 5, 1, 4, 5, 2, 5], "int64")
    return src, lens, tgt_in.astype("int64"), tgt.astype("int64")


@pytest.fixture(scope="module")
def trained_nmt():
    """The JAX package's NMT model after 10 Adam steps on the copy task:
    its persistable state as numpy."""
    main, start = pt.Program(), pt.Program()
    with pt.program_guard(main, start), pt.unique_name.guard():
        L = pt.layers
        src = L.data("src", shape=[TS], dtype="int64")
        src_lens = L.data("src_lens", shape=[], dtype="int64")
        tgt_in = L.data("tgt_in", shape=[TT], dtype="int64")
        tgt_out = L.data("tgt_out", shape=[TT], dtype="int64")
        tgt_mask = L.data("tgt_mask", shape=[TT], dtype="float32")
        loss, _ = jmt.train_net(src, src_lens, tgt_in, tgt_out, tgt_mask,
                                dict_size=V, embed_dim=EMBED,
                                hidden_dim=HIDDEN)
        pt.optimizer.AdamOptimizer(learning_rate=5e-3).minimize(loss)
    scope = pt.Scope()
    exe = pt.Executor()
    exe.run(start, scope=scope)
    s, sl, ti, to = _toy_batch(0)
    feed = {"src": s, "src_lens": sl, "tgt_in": ti, "tgt_out": to,
            "tgt_mask": np.ones((B, TT), "float32")}
    for _ in range(10):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    return {p.name: np.asarray(scope.get(p.name))
            for p in main.all_parameters()}


def _infer(pkg, mod, beam_size=K):
    L = pkg.layers
    src = L.data("src", shape=[TS], dtype="int64")
    lens = L.data("src_lens", shape=[], dtype="int64")
    return mod.infer_net(src, lens, dict_size=V, embed_dim=EMBED,
                         hidden_dim=HIDDEN, beam_size=beam_size,
                         max_len=TT, bos_id=BOS, eos_id=EOS)


def _infer_both(beam_size=K):
    return _build_both(lambda pkg, _: _infer(
        pkg, jmt if pkg is pt else tmt, beam_size))


def test_infer_net_programs_match_and_load_from_jax_json():
    (jmain, jstart, _), (tmain, tstart, _) = _infer_both()
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert PortProgram.from_json(jmain.to_json()).to_json() == \
        tmain.to_json()


def test_infer_net_fused_clone_runs_the_kernels_ops():
    """The fused clone of the decode program has the encoder's fused_gru
    and, in the decoder's step block, one fused_decode_attention (the
    attention of the K beams, G = K rows), in both packages."""
    (jmain, _, names), (tmain, _, _) = _infer_both()
    jf = japply(jmain, protected=names)
    tf = tapply(tmain, protected=names)
    types = [[op.type for op in b.ops] for b in tf.blocks]
    assert types == [[op.type for op in b.ops] for b in jf.blocks]
    assert tf.to_json() == jf.to_json()
    assert types[0].count("fused_gru") == 1
    step = [t for t in types[1:] if "beam_search" in t]
    assert len(step) == 1 and step[0].count("fused_decode_attention") == 1


@pytest.mark.parametrize("beam_size", [K, 1])
def test_infer_net_decodes_as_jax(trained_nmt, beam_size):
    built = _infer_both(beam_size)
    s, sl, _, _ = _toy_batch(1)
    (jseq, jsc), (tseq, tsc) = _run_both(
        built, {"src": s, "src_lens": sl}, jstate=trained_nmt)
    assert tseq.shape == (B, TT, beam_size) and tseq.dtype == np.int64
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tseq, jseq)
    assert np.isfinite(tsc).all() and (np.diff(tsc, axis=1) <= 1e-5).all()
    assert ((tseq >= 0) & (tseq < V)).all()


def test_infer_net_round_trips_through_save_and_load_params(trained_nmt,
                                                            tmp_path):
    """The book flow: parameters saved by the port's `io.save_params` load
    into a fresh `infer_net` program and decode as before."""
    s, sl, _, _ = _toy_batch(2)
    feed = {"src": s, "src_lens": sl}
    outs = []
    for i in range(2):
        ptt.reset_default_programs()
        ptt.reset_global_scope()
        with ptt.unique_name.guard():
            seqs, scores = _infer(ptt, tmt)
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(ptt.default_startup_program())
        if i == 0:
            ptt.load_numpy_params(trained_nmt, ptt.global_scope(),
                                  ptt.CPUPlace())
            ptt.io.save_params(exe, str(tmp_path / "mt"))
        else:
            ptt.io.load_params(exe, str(tmp_path / "mt"))
        outs.append(exe.run(feed=feed, fetch_list=[seqs, scores]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_infer_net_defaults_to_the_card():
    """Without a place the executor that runs the decode program targets
    CUDAPlace(0), which raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _infer(ptt, tmt)
    with pytest.raises(UnavailableError):
        ptt.Executor().run(ptt.default_startup_program())
