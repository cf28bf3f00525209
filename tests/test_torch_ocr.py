"""OCR: the port's CTC ops (`warpctc`, `ctc_align`) and `im2sequence`
against the JAX package's lowerings, and the CRNN-CTC recognizer at test width
(tests/test_models.py:259's build: 10 classes and the blank, 1x32x64
images, 4 labels, hidden 32, batch 2) through both packages.

Tolerances: CTC losses at 1e-5 relative (infeasible rows give about 1e30
in both, finite), gradients through autograd against jax.grad within 1e-5
of each gradient's largest element; alignments exactly. CRNN: programs
equal; three Adam steps in both packages, each from the JAX package's
state (carried with `load_numpy_params`), with both GRUs fused (the port's
plain K6 on the CPU): the loss at 1e-5 relative and each gradient within
1e-5 of its largest element; then the greedy CTC decode of a batch
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.framework import registry as jreg

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.executor import as_numpy

from tests.port_env import port_jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


R = np.random.RandomState(29)

# rows: an ordinary one; label length 0; repeated labels that fit exactly
# (2, blank, 2 in 3 steps); a label longer than its 2 steps allow; repeats
# needing 5 steps in 4; a row whose input is a single step
CTC_LOGITS = R.randn(6, 8, 6).astype("float32") * 2
CTC_LABEL = np.int64([[1, 2, 3, 4], [0, 0, 0, 0], [2, 2, 0, 0],
                      [1, 2, 3, 4], [3, 3, 3, 0], [4, 0, 0, 0]])
CTC_LABEL_LEN = np.int64([4, 0, 2, 4, 3, 1])
CTC_LOGIT_LEN = np.int64([8, 8, 3, 2, 4, 1])
INFEASIBLE = [3, 4]


def _ctc():
    # no label within its row's length is 0 or 5, either blank
    return {"Logits": CTC_LOGITS, "Label": CTC_LABEL,
            "LogitsLength": CTC_LOGIT_LEN, "LabelLength": CTC_LABEL_LEN}


@pytest.mark.parametrize("attrs", [
    {"blank": 0}, {"blank": 0, "norm_by_times": True}, {"blank": 5}],
    ids=["blank0", "norm_by_times", "blank_last"])
def test_warpctc_loss_and_gradient_match_jax(attrs):
    """Loss [B, 1] and d(sum(loss * w))/d(logits) against the JAX package:
    infeasible rows give a loss of about 1e30 and finite gradients (not
    torch.nn.functional.ctc_loss's inf), a label of length 0 the
    all-blank path, repeated labels need their blank."""
    ins = _ctc()
    w = R.uniform(0.5, 1.5, (6, 1)).astype("float32")
    rest = {s: a for s, a in ins.items() if s != "Logits"}

    def jloss(lg):
        out = jreg.lookup_op("warpctc").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"Logits": [lg], **{s: [jnp.asarray(a)] for s, a in rest.items()}},
            dict(attrs))["Loss"][0]
        return jnp.sum(jnp.where(out > 1e29, 0.0, out) * w), out

    (_, jl), jg = jloss(jnp.asarray(ins["Logits"])), jax.grad(
        lambda lg: jloss(lg)[0])(jnp.asarray(ins["Logits"]))
    lg = torch.from_numpy(ins["Logits"].copy()).requires_grad_()
    tl = treg.lookup_op("warpctc").lower(
        treg.LowerCtx(), {"Logits": [lg], **{s: [torch.from_numpy(a)]
                                             for s, a in rest.items()}},
        dict(attrs))["Loss"][0]
    (torch.where(tl > 1e29, 0.0, tl) * torch.from_numpy(w)).sum().backward()
    tl, jl, jg = as_numpy(tl.detach()), np.asarray(jl), np.asarray(jg)
    assert tl.shape == (6, 1)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert np.isfinite(tl).all()
    big = 1e30 / (CTC_LOGIT_LEN[INFEASIBLE] if attrs.get("norm_by_times")
                  else 1)
    np.testing.assert_allclose(tl[INFEASIBLE, 0], big, rtol=1e-3)
    assert (tl[[0, 1, 2, 5], 0] < 1e3).all()
    g = as_numpy(lg.grad)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5 * np.abs(jg).max())


def test_warpctc_infeasible_rows_have_finite_gradients():
    """The whole loss, infeasible rows included: its gradient is finite in
    both packages (the double-where log-sum-exp), and equal."""
    ins = _ctc()
    rest = {s: a for s, a in ins.items() if s != "Logits"}

    def jloss(lg):
        return jnp.sum(jreg.lookup_op("warpctc").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"Logits": [lg], **{s: [jnp.asarray(a)] for s, a in rest.items()}},
            {"blank": 0})["Loss"][0])

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(ins["Logits"])))
    lg = torch.from_numpy(ins["Logits"].copy()).requires_grad_()
    treg.lookup_op("warpctc").lower(
        treg.LowerCtx(), {"Logits": [lg], **{s: [torch.from_numpy(a)]
                                             for s, a in rest.items()}},
        {"blank": 0})["Loss"][0].sum().backward()
    g = as_numpy(lg.grad)
    assert np.isfinite(g).all() and np.isfinite(jg).all()
    np.testing.assert_allclose(g, jg, rtol=0, atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("blank,pad", [(0, 0), (3, -1)])
def test_ctc_align_matches_jax(blank, pad):
    """Repeats merged then blanks dropped, rows cut at their lengths,
    left-packed and padded: exactly the JAX package's."""
    x = np.int64([[1, 1, 0, 2, 2, 2, 0, 1], [0, 0, 0, 0, 3, 3, 3, 0],
                  [3, 1, 3, 1, 3, 1, 3, 1], [2, 2, 2, 2, 2, 2, 2, 2]])
    xlen = np.int64([8, 8, 5, 0])
    attrs = {"blank": blank, "padding_value": pad}
    jout = jreg.lookup_op("ctc_align").lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {"Input": [jnp.asarray(x)], "InputLength": [jnp.asarray(xlen)]},
        attrs)
    tout = treg.lookup_op("ctc_align").lower(
        treg.LowerCtx(), {"Input": [torch.from_numpy(x)],
                          "InputLength": [torch.from_numpy(xlen)]}, attrs)
    for slot in ("Output", "OutputLength"):
        np.testing.assert_array_equal(as_numpy(tout[slot][0]),
                                      np.asarray(jout[slot][0]))


@pytest.mark.parametrize("kernels,strides", [([2, 3], [1, 2]),
                                              ([32, 4], [1, 4])])
def test_im2sequence_matches_jax(kernels, strides):
    """Every patch a row, channel-major within the row: the JAX package's
    conv_general_dilated_patches order (the second case: a CRNN-style
    full-height column of 4)."""
    x = R.randn(2, 3, 32, 16).astype("float32")
    attrs = {"kernels": kernels, "strides": strides}
    jout = jreg.lookup_op("im2sequence").lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {"X": [jnp.asarray(x)]}, attrs)["Out"][0]
    tout = treg.lookup_op("im2sequence").lower(
        treg.LowerCtx(), {"X": [torch.from_numpy(x)]}, attrs)["Out"][0]
    np.testing.assert_array_equal(as_numpy(tout), np.asarray(jout))


# ---- CRNN-CTC at test width -----------------------------------------------

CB, CL, CNC, CH = 2, 4, 10, 32


def _crnn(pkg, hidden=CH):
    from importlib import import_module
    ocr = import_module(pkg.__name__ + ".models.ocr_crnn")
    L = pkg.layers
    loss, logits, seqlen = ocr.crnn_ctc(num_classes=CNC,
                                        image_shape=(1, 32, 64),
                                        max_label_len=CL, hidden=hidden)
    pkg.optimizer.Adam(learning_rate=3e-3).minimize(loss)
    dec, dec_len = L.sequence.ctc_greedy_decoder(
        L.softmax(logits), blank=CNC, input_length=seqlen)
    return loss, [dec, dec_len]


def _crnn_programs():
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss, dec = _crnn(pkg)
        progs.append((main, start, loss.name, [v.name for v in dec]))
    return progs


def _crnn_feeds(n):
    r = np.random.RandomState(31)
    return [{"img": r.rand(CB, 1, 32, 64).astype("float32"),
             "label": r.randint(0, CNC, (CB, CL)).astype("int64")}
            for _ in range(n)]


def test_crnn_programs_match():
    (jmain, jstart, _, _), (tmain, tstart, _, _) = _crnn_programs()
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()


def test_crnn_steps_and_decode_match_jax():
    (jmain, jstart, loss, dec), (tmain, _, _, _) = _crnn_programs()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    names = [p.name for p in tmain.all_parameters()]
    fetch = [loss] + [n + "@GRAD" for n in names]
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    *feeds, held = _crnn_feeds(4)
    for i, feed in enumerate(feeds):
        state = {n: np.asarray(jscope.get(n))
                 for n in jscope.local_var_names()}
        tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
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
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    jout = jexe.run(jmain, feed=held, fetch_list=dec, scope=jscope)
    tout = texe.run(tmain, feed=held, fetch_list=dec, scope=tscope)
    for n, a, b in zip(dec, tout, jout):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=n)


@pytest.mark.parametrize("hidden", [CH, 96])
def test_crnn_fuses_both_grus_into_k6(hidden):
    """The executor's fused clone runs both GRUs as fused_gru (K6 on a
    card), the reversed one included, at test width and at the default
    hidden 96 (the JAX package's Pallas gate needs 128 | H; the port's
    kernel serves any H)."""
    _crnn(ptt, hidden)
    from paddle_tpu_torch.framework.passes import apply_fusion_passes
    fused = apply_fusion_passes(ptt.default_main_program())
    ops = [op for op in fused.global_block().ops if op.type == "fused_gru"]
    assert [op.attrs.get("is_reverse", False) for op in ops] == \
        [False, True]
    assert all(op.type != "dynamic_gru" for op in fused.global_block().ops)


def test_crnn_loss_falls_and_decodes_classes():
    """tests/test_models.py's claim through the port: the loss falls over
    Adam steps on one batch and the decode emits only real classes."""
    _, (tmain, tstart, loss, dec) = _crnn_programs()
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(tstart, scope=scope)
    feed = _crnn_feeds(1)[0]
    first = float(exe.run(tmain, feed=feed, fetch_list=[loss],
                          scope=scope)[0])
    for _ in range(12):
        last = float(exe.run(tmain, feed=feed, fetch_list=[loss],
                             scope=scope)[0])
    assert np.isfinite(last) and last < first
    d, dl = exe.run(tmain, feed=feed, fetch_list=dec, scope=scope)
    for b in range(CB):
        assert (as_numpy(d)[b, :int(dl[b, 0])] < CNC).all()


def test_crnn_defaults_to_the_card():
    """Without a place the executor that trains CRNN targets CUDAPlace(0),
    which raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    _crnn(ptt)
    with pytest.raises(UnavailableError):
        ptt.Executor().run(ptt.default_startup_program())
