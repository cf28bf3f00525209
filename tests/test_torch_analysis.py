"""The static analyzers (`framework/analysis.py`) against the JAX package.

On small zoo programs (the Transformer LM, the GRU-attention NMT model,
ResNet-8, DeepFM, the BiLSTM-CRF and both generators), built in both
packages with equal `to_json`:

- `infer_program`'s types equal the JAX package's, 64-bit types mapped to
  their 32-bit forms (the port keeps int64 / float64, ROADMAP.md §3; the
  JAX package with x64 off narrows them), with the same op counts,
  inferred / skipped split and diagnostics;
- `infer_coverage()` is equal;
- `verify_program` / `analyze_program` give the same diagnostic codes,
  locations and messages on seeded faulty programs (use before def, a
  duplicate writer, a bad attribute; a cache-write aliasing race through
  `dataflow.cache_write_aliasing`) and on the clean zoo programs (none);
- a pass that breaks a program raises `PassSanitizerError` naming it in
  both packages, and passes through with the sanitizer off;
- `check_program`, `op_loc` and `peak_live_bytes` agree.
"""

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework import analysis as ja
from paddle_tpu.framework import passes as jpasses

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import analysis as ta
from paddle_tpu_torch.framework import passes as tpasses

_WIDE = {"int64": "int32", "float64": "float32"}


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh programs, scope, names, profiler and flight recorder for the
    port; float32 matmuls in both packages. Both packages memoize inferred
    types by op, attrs and input types, not by the flag, so the memos are
    cleared too: a test of another file in this process may have filled
    them with bfloat16 matmuls."""
    from paddle_tpu_torch import profiler as tprof
    from paddle_tpu_torch.observability import flight_recorder as tfr
    saved = (jflags.get_flag("use_bf16_matmul"),
             tflags.get_flag("use_bf16_matmul"))
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)
    ja._MEMO.clear()
    ta._MEMO.clear()
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    tprof.reset()
    tfr.reset()
    with ptt.unique_name.guard():
        yield
    tprof.reset()
    tfr.reset()
    jflags.set_flag("use_bf16_matmul", saved[0])
    tflags.set_flag("use_bf16_matmul", saved[1])


# -- the zoo at test width ---------------------------------------------------

def _lm(pkg):
    loss, _ = pkg.models.transformer.transformer_lm(
        vocab=64, max_len=8, d_model=32, d_inner=64, num_heads=4,
        num_layers=2)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)


def _nmt(pkg):
    L = pkg.layers
    src = L.data("src", shape=[6], dtype="int64")
    src_lens = L.data("src_lens", shape=[], dtype="int64")
    tgt_in = L.data("tgt_in", shape=[5], dtype="int64")
    tgt_out = L.data("tgt_out", shape=[5], dtype="int64")
    tgt_mask = L.data("tgt_mask", shape=[5], dtype="float32")
    loss, _ = pkg.models.machine_translation.train_net(
        src, src_lens, tgt_in, tgt_out, tgt_mask, dict_size=30,
        embed_dim=16, hidden_dim=32)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)


def _resnet8(pkg):
    img = pkg.layers.data("img", shape=[16, 16, 3], dtype="float32")
    loss, _, _ = pkg.models.resnet.resnet_cifar10(img=img, depth=8)
    pkg.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)


def _deepfm(pkg):
    loss, _ = pkg.models.deepfm.deepfm(num_fields=5, vocab_size=500,
                                       embed_dim=8, fc_sizes=(32,))
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)


def _crf(pkg):
    L = pkg.layers
    seq = L.sequence
    words = L.data("words", shape=[7], dtype="int64", lod_level=1)
    label = L.data("label", shape=[7], dtype="int64")
    length = seq.get_seqlen(words)
    emb = seq.tag_sequence(L.embedding(words, size=[30, 8]), length)
    fwd_in = seq.tag_sequence(L.fc(emb, size=64, num_flatten_dims=2),
                              length)
    fwd, _ = seq.dynamic_lstm(fwd_in, size=64)
    emission = L.fc(fwd, size=5, num_flatten_dims=2)
    crf_cost = L.linear_chain_crf(emission, label, length,
                                  param_attr=pkg.ParamAttr(name="crfw"))
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(L.mean(crf_cost))
    seq.crf_decoding(emission, length, param_attr=pkg.ParamAttr(name="crfw"))


def _lm_generate(pkg):
    pkg.models.transformer.transformer_lm_generate(
        vocab=50, max_gen=4, d_model=32, d_inner=64, num_heads=4,
        num_layers=2, beam_size=2)


def _nmt_generate(pkg):
    pkg.models.transformer.transformer_generate(
        src_vocab=40, tgt_vocab=40, max_src_len=7, max_gen=4, d_model=32,
        d_inner=64, num_heads=4, num_layers=2, beam_size=2)


ZOO = {"lm": _lm, "nmt": _nmt, "resnet8": _resnet8, "deepfm": _deepfm,
       "crf": _crf, "lm_generate": _lm_generate,
       "nmt_generate": _nmt_generate}


def build(pkg, name):
    """(main, startup) of zoo program `name` built in `pkg`."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        ZOO[name](pkg)
    return main, start


def build_pair(name):
    """The JAX package's and the port's `name`, with equal JSON."""
    j, t = build(pt, name)[0], build(ptt, name)[0]
    assert t.to_json() == j.to_json()
    return j, t


def type_key(struct):
    """(shape, dtype name) of an inferred type, 64-bit mapped to 32."""
    dt = struct.dtype
    name = (np.dtype(dt).name if not hasattr(dt, "is_floating_point")
            else str(dt).replace("torch.", ""))
    return tuple(int(d) for d in struct.shape), _WIDE.get(name, name)


def diag_keys(diags):
    return [(d.code, d.loc, d.message, d.severity) for d in diags]


# -- inference ---------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ZOO))
def test_infer_program_types_equal_jax(name):
    j, t = build_pair(name)
    jr, tr = ja.infer_program(j), ta.infer_program(t)
    assert (tr.n_ops, tr.n_inferred, tr.n_skipped) == \
        (jr.n_ops, jr.n_inferred, jr.n_skipped)
    assert sorted(tr.types) == sorted(jr.types)
    assert {k: type_key(v) for k, v in tr.types.items()} == \
        {k: type_key(v) for k, v in jr.types.items()}
    assert diag_keys(tr.diagnostics) == diag_keys(jr.diagnostics)


def test_bf16_matmuls_infer_as_jax():
    """With bfloat16 matmuls (the LM's default) the fc outputs infer as
    bfloat16 against their float32 declarations: the relaxation both
    packages allow, so no diagnostic. Both packages memoize inferred
    types by op, attrs and input types, not by the flag, so the memos are
    cleared first (the float32 tests of this file filled them)."""
    ja._MEMO.clear()
    ta._MEMO.clear()
    jflags.set_flag("use_bf16_matmul", True)
    tflags.set_flag("use_bf16_matmul", True)
    j, t = build_pair("lm")
    jr, tr = ja.infer_program(j), ta.infer_program(t)
    assert diag_keys(tr.diagnostics) == diag_keys(jr.diagnostics) == []
    assert {k: type_key(v) for k, v in tr.types.items()} == \
        {k: type_key(v) for k, v in jr.types.items()}
    assert any(type_key(v)[1] == "bfloat16" for v in tr.types.values())
    ta.check_program(t)
    ja._MEMO.clear()
    ta._MEMO.clear()


def test_infer_coverage_equal_jax():
    """In a fresh interpreter, as the op registry gate compares the
    registries: other tests of a session register ops of their own."""
    import json
    import os
    import subprocess
    import sys
    code = ("import json; from paddle_tpu.framework import analysis as j; "
            "from paddle_tpu_torch.framework import analysis as t; "
            "print(json.dumps([j.infer_coverage(), t.infer_coverage()]))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    jcov, tcov = json.loads(out.stdout.splitlines()[-1])
    assert tcov == jcov
    assert len(tcov[0]) == 229 - len(tcov[1])
    assert ta.INFER_WAIVED == ja.INFER_WAIVED


def test_infer_op_runs_the_lowering_on_meta_tensors():
    """A lowering with a hand-written kernel takes its plain version's
    shape logic on meta tensors: the flash-attention op and the fused LSTM
    infer without computing, and agree with the JAX package."""
    b, t, h = 2, 5, 8
    jf = ja.infer_op("fused_lstm", {
        "Input": [np.zeros((b, t, 4 * h), "float32")],
        "Weight": [np.zeros((h, 4 * h), "float32")],
        "SeqLen": [np.zeros((b,), "int32")]}, {})
    tf = ta.infer_op("fused_lstm", {
        "Input": [ta.ShapeDtype((b, t, 4 * h), "float32")],
        "Weight": [ta.ShapeDtype((h, 4 * h), "float32")],
        "SeqLen": [ta.ShapeDtype((b,), "int32")]}, {})
    assert {k: [type_key(s) for s in v] for k, v in tf.items()} == \
        {k: [type_key(s) for s in v] for k, v in jf.items()}
    with pytest.raises(NotImplementedError):
        ta.infer_op("while", {}, {})


# -- verification ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_programs_verify_clean_as_jax(name):
    j, t = build_pair(name)
    assert diag_keys(ta.verify_program(t)) == \
        diag_keys(ja.verify_program(j)) == []
    ta.check_program(t)
    assert diag_keys(ta.analyze_program(t)) == \
        diag_keys(ja.analyze_program(j))
    # the declared dtype's width in both packages (the lifetime walk does
    # not narrow 64-bit types in the JAX package either)
    assert ta.peak_live_bytes(t) == ja.peak_live_bytes(j)


def _seed_fault(pkg, fault):
    """A small program with one seeded fault, built the same way in
    either package."""
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        L = pkg.layers
        if fault == "cache_alias":
            cache = L.data("cache", shape=[4, 8], dtype="float32")
            new = L.data("new", shape=[4, 1], dtype="float32")
            pos = L.data("pos", shape=[], dtype="int64")
            L.cache_write(cache, new, pos, axis=1, out=cache)
            L.cache_write(cache, new, pos, axis=1, out=cache)
            return main
        x = L.data("x", shape=[4], dtype="float32")
        y = L.fc(x, size=3)
        block = main.global_block()
        if fault == "use_before_def":
            ghost = block.create_var(name="ghost", shape=[-1, 3],
                                     dtype="float32")
            out = block.create_var(name="early", shape=[-1, 3],
                                   dtype="float32")
            block.append_op(type="elementwise_add",
                            inputs={"X": [y.name], "Y": [ghost.name]},
                            outputs={"Out": [out.name]}, attrs={"axis": -1})
        elif fault == "duplicate_writer":
            block.append_op(type="scale", inputs={"X": [x.name]},
                            outputs={"Out": [y.name]},
                            attrs={"scale": 2.0})
        elif fault == "bad_attr":
            block.ops[-1].attrs["op_role"] = 3
    return main


@pytest.mark.parametrize("fault", ["use_before_def", "duplicate_writer",
                                   "bad_attr", "cache_alias"])
def test_seeded_faults_give_the_jax_diagnostics(fault):
    """The cache-write race is the serving lint's detector
    (`dataflow.cache_write_aliasing`), outside verify_program in both
    packages; the other three are verify_program's."""
    from paddle_tpu.framework import dataflow as jdf
    from paddle_tpu_torch.framework import dataflow as tdf
    j, t = _seed_fault(pt, fault), _seed_fault(ptt, fault)
    assert t.to_json() == j.to_json()
    if fault == "cache_alias":
        jd, td = jdf.cache_write_aliasing(j), tdf.cache_write_aliasing(t)
        assert [d.code for d in jd] == ["serving-cache-write-alias"]
        assert diag_keys(td) == diag_keys(jd)
        return
    jd, td = ja.verify_program(j), ta.verify_program(t)
    assert jd, fault
    assert diag_keys(td) == diag_keys(jd)
    assert diag_keys(ta.analyze_program(t)) == \
        diag_keys(ja.analyze_program(j))
    with pytest.raises(ta.ProgramAnalysisError) as te:
        ta.check_program(t)
    with pytest.raises(ja.ProgramAnalysisError) as je:
        ja.check_program(j)
    assert diag_keys(te.value.diagnostics) == diag_keys(je.value.diagnostics)
    block = t.global_block()
    idx = len(block.ops) - 1
    assert ta.op_loc(block, idx, block.ops[idx]) == ja.op_loc(
        j.global_block(), idx, j.global_block().ops[idx])


def _breaking_pass(mod, registry_name):
    class Breaks(mod.Pass):
        """Deletes the program's first op, so its output is read before
        any producer."""
        name = registry_name

        def apply(self, program, scope=None):
            program.global_block().ops.pop(0)
            return program
    return Breaks


def test_a_pass_that_breaks_a_program_is_named_by_the_sanitizer():
    j, t = build_pair("deepfm")
    with pytest.raises(ja.PassSanitizerError) as je:
        _breaking_pass(jpasses, "breaks_pass")()(j)
    with pytest.raises(ta.PassSanitizerError) as te:
        _breaking_pass(tpasses, "breaks_pass")()(t)
    assert te.value.pass_name == je.value.pass_name == "breaks_pass"
    assert diag_keys(te.value.diagnostics) == \
        diag_keys(je.value.diagnostics)
    # the sanitizer off: the same apply goes through
    tflags.set_flag("verify_passes", False)
    try:
        _breaking_pass(tpasses, "breaks_pass")()(build(ptt, "deepfm")[0])
    finally:
        tflags.set_flag("verify_passes", True)
    assert ta.sanitizer_enabled()


def test_check_pass_and_graph_viz_pass_run(tmp_path):
    t = build(ptt, "lm")[0]
    assert tpasses.get_pass("check_pass")(t) is t
    bad = _seed_fault(ptt, "use_before_def")
    with pytest.raises(Exception, match="program check failed"):
        tpasses.get_pass("check_pass")(bad)
    path = str(tmp_path / "g.dot")
    tpasses.get_pass("graph_viz_pass", path=path)(t)
    text = open(path).read()
    assert text.startswith("digraph G {") and "vjp_region" in text
