"""Generation through the model zoo: `transformer_lm_generate` and
`transformer_generate` of the port against the JAX package's.

Test width: 2 layers, d_model 32, 4 heads, d_inner 64, max_gen 6, batch 4;
the LM over a vocabulary of 50, the encoder-decoder over 40 with ragged
sources of at most 7 tokens; greedy (beam 1) and beam 3. Both packages
build the program (equal JSON, startup included); the JAX startup draws
the weights, which reach the port through `load_numpy_params`; both
executors decode on the CPU with the fusion passes on and
`use_bf16_matmul` off (the LM's fc layers are bfloat16 otherwise).

Tokens must be equal and scores agree to 1e-4. A near-tie would let
float32 noise pick another token, so every beam_search step the port runs
records the gap between its last kept and first dropped candidate (and
between kept neighbours): each must exceed 1e-4, the tolerance the
comparison relies on.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework.passes import apply_fusion_passes as japply
from paddle_tpu.models import transformer as jtr

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.passes import apply_fusion_passes as tapply
from paddle_tpu_torch.framework.program import Program as PortProgram
from paddle_tpu_torch.models import transformer as ttr

B, G, LAYERS = 4, 6, 2
LM = dict(vocab=50, max_gen=G, d_model=32, d_inner=64, num_heads=4,
          num_layers=LAYERS)
NMT = dict(src_vocab=40, tgt_vocab=40, max_src_len=7, max_gen=G,
           d_model=32, d_inner=64, num_heads=4, num_layers=LAYERS)
GENERATORS = {"lm": ("transformer_lm_generate", LM),
              "nmt": ("transformer_generate", NMT)}
CASES = [(g, k) for g in GENERATORS for k in (1, 3)]
IDS = [f"{g}_beam{k}" for g, k in CASES]


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


def _build(pkg, module, gen, beam):
    fn, dims = GENERATORS[gen]
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        seqs, scores = getattr(module, fn)(beam_size=beam, **dims)
    return main, start, [seqs.name, scores.name]


def _feed(gen):
    r = np.random.RandomState(5)
    if gen == "lm":
        return {"prompt": r.randint(0, LM["vocab"], (B, 1)).astype("int64")}
    return {"src": r.randint(2, NMT["src_vocab"],
                             (B, NMT["max_src_len"])).astype("int64"),
            "src@SEQLEN": np.array([7, 3, 5, 1], "int32")}


def _fused(program):
    return sum(op.type == "fused_decode_attention"
               for blk in program.blocks for op in blk.ops)


@pytest.mark.parametrize("gen,beam", CASES, ids=IDS)
def test_program_matches_jax(gen, beam):
    jmain, jstart, jnames = _build(pt, jtr, gen, beam)
    tmain, tstart, tnames = _build(ptt, ttr, gen, beam)
    assert tnames == jnames
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    assert PortProgram.from_json(jmain.to_json()).to_json() == \
        tmain.to_json()


@pytest.mark.parametrize("gen,beam", CASES, ids=IDS)
def test_fusion_pass_rewrites_as_jax(gen, beam):
    """Each layer's cached self-attention becomes one
    fused_decode_attention (K4 on the card). The encoder-decoder's
    cross-attention reads [B,1,nh,Ts,dh], so it fuses only at beam 1;
    at beam 3 it stays a batched matmul, which the card's executor
    accepts (require_fused counts decode chains only)."""
    jmain, _, names = _build(pt, jtr, gen, beam)
    tmain, _, _ = _build(ptt, ttr, gen, beam)
    want = LAYERS * (2 if gen == "nmt" and beam == 1 else 1)
    jf = _fused(japply(jmain, protected=names))
    tf = _fused(tapply(tmain, protected=names, require_fused=True))
    assert tf == jf == want


def _record_beam_margins(monkeypatch):
    """Wrap the port's beam_search lowering: for each step, the smallest
    gap among the K+1 best totals (the K kept, in order, and the first
    dropped), over the rows."""
    opdef = treg.lookup_op("beam_search")
    lower = opdef.lower
    gaps = []

    def recording(ctx, ins, attrs):
        pre_ids, pre, scores = (ins[s][0] for s in
                                ("PreIds", "PreScores", "Scores"))
        b, k, v = scores.shape
        total = pre[:, :, None] + scores
        end = torch.arange(v) == attrs["end_id"]
        frozen = torch.where(end, pre[:, :, None], -float("inf"))
        total = torch.where((pre_ids == attrs["end_id"])[:, :, None],
                            frozen, total).reshape(b, -1)
        top = torch.topk(total, k + 1, dim=1).values.double()
        gaps.append(float((top[:, :-1] - top[:, 1:]).min()))
        return lower(ctx, ins, attrs)

    monkeypatch.setattr(opdef, "lower", recording)
    return gaps


@pytest.mark.parametrize("gen,beam", CASES, ids=IDS)
def test_tokens_and_scores_match_jax(gen, beam, monkeypatch):
    jmain, jstart, names = _build(pt, jtr, gen, beam)
    tmain, _, _ = _build(ptt, ttr, gen, beam)
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    scope = ptt.load_numpy_params(
        {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()},
        ptt.Scope(), ptt.CPUPlace())
    feed = _feed(gen)
    gaps = _record_beam_margins(monkeypatch)
    tseq, tsc = ptt.Executor(ptt.CPUPlace()).run(
        tmain, feed=feed, fetch_list=names, scope=scope)
    jseq, jsc = pt.Executor().run(jmain, feed=feed, fetch_list=names,
                                  scope=jscope)
    assert len(gaps) == G and min(gaps) > 1e-4, gaps
    assert tseq.shape == (B, G, beam) and tsc.shape == (B, beam)
    np.testing.assert_array_equal(tseq, np.asarray(jseq))
    np.testing.assert_allclose(tsc, np.asarray(jsc), rtol=0, atol=1e-4)
    vocab = GENERATORS[gen][1].get("vocab", NMT["tgt_vocab"])
    assert ((tseq >= 0) & (tseq < vocab)).all()
    # best first along the beam axis
    assert (np.diff(tsc, axis=1) <= 0).all()


def test_lm_generation_conditions_on_the_prompt_values():
    """bos_id is only a fallback start: the fed prompt token seeds each
    row, so two prompts differing in one row differ only there."""
    tmain, tstart, names = _build(ptt, ttr, "lm", 1)
    exe = ptt.Executor(ptt.CPUPlace())
    scope = ptt.Scope()
    exe.run(tstart, scope=scope)
    prompt = np.array([[3], [3], [7], [9]], "int64")
    a = exe.run(tmain, feed={"prompt": prompt}, fetch_list=names,
                scope=scope)[0]
    prompt[1, 0] = 41
    b = exe.run(tmain, feed={"prompt": prompt}, fetch_list=names,
                scope=scope)[0]
    np.testing.assert_array_equal(a[0], a[1])
    np.testing.assert_array_equal(a[[0, 2, 3]], b[[0, 2, 3]])
