"""The recurrent slice's kernel modules against the JAX package.

- The whole-sequence cells (`fusion/recurrent.py`): the port's
  `fused_lstm_sequence` / `fused_gru_sequence`, which take their plain
  versions on CPU tensors, against the JAX functions with the Pallas
  kernels in interpret mode (B=4, T=6, H=128, forward and reversed, ragged
  lengths with a 1 and a 0) at the tolerance tests/test_fusion.py holds the
  Pallas kernels to (2e-6: the same float32 math in another summation
  order); their gradients (autograd through the port's manual backward)
  against jax.grad of the JAX functions' XLA backend at 1e-4.
- The unfused `dynamic_lstm` / `dynamic_gru` lowerings, which run the
  non-default activations, through both registries at 1e-5.
- `fused_decode_attention` at the NMT decoder's rank-3 form ([B, 1, H]
  over [B, T, H]): its gradient (the port's autograd function) against
  jax.grad of the JAX op at 1e-5.
Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fusion import decode_attention as jda
from paddle_tpu.fusion import recurrent as jrec
from paddle_tpu.framework import registry as jreg

import paddle_tpu_torch as ptt
from paddle_tpu_torch import kernels
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.passes import apply_fusion_passes
from paddle_tpu_torch.fusion import decode_attention as tda
from paddle_tpu_torch.fusion import recurrent as trec

from tests.port_env import port_jax_compile_cache  # noqa: F401

B, T, H = 4, 6, 128
LENGTHS = {"ragged": [T, T - 2, 1, T], "with_zero": [T, 0, 1, T - 2]}


@pytest.fixture(autouse=True)
def fresh_port_state():
    """Fresh default programs, scope and name generator for the port."""
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _args(kind, lengths, seed=0):
    r = np.random.RandomState(seed)
    g = 4 if kind == "lstm" else 3
    return {"x": (r.randn(B, T, g * H) * .3).astype("float32"),
            "h0": (r.randn(B, H) * .1).astype("float32"),
            "c0": (r.randn(B, H) * .1).astype("float32"),
            "w": (r.randn(H, g * H) * .1).astype("float32"),
            "seqlen": np.asarray(lengths, "int32")}


def _jax_fn(kind, a, reverse, backend):
    if kind == "lstm":
        return lambda x, h0, c0, w: jrec.fused_lstm_sequence(
            x, h0, c0, w, jnp.asarray(a["seqlen"]), reverse=reverse,
            backend=backend)
    return lambda x, h0, c0, w: (jrec.fused_gru_sequence(
        x, h0, w, jnp.asarray(a["seqlen"]), reverse=reverse,
        backend=backend),)


def _port_fn(kind, a, reverse):
    sl = torch.from_numpy(a["seqlen"])
    if kind == "lstm":
        return lambda x, h0, c0, w: trec.fused_lstm_sequence(
            x, h0, c0, w, sl, reverse=reverse)
    return lambda x, h0, c0, w: (trec.fused_gru_sequence(
        x, h0, w, sl, reverse=reverse),)


@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fused_cell_matches_pallas_interpret(kind, reverse, lengths):
    a = _args(kind, LENGTHS[lengths])
    jouts = _jax_fn(kind, a, reverse, "pallas_interpret")(
        *(jnp.asarray(a[k]) for k in ("x", "h0", "c0", "w")))
    kernels.reset_launch_counts()
    touts = _port_fn(kind, a, reverse)(
        *(torch.from_numpy(a[k]) for k in ("x", "h0", "c0", "w")))
    assert not any(kernels.LAUNCHES.values())    # CPU: the plain version
    for jo, to in zip(jouts, touts):
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6,
                                   rtol=2e-6)
    if 0 in LENGTHS[lengths]:
        row = LENGTHS[lengths].index(0)
        assert (touts[0][row] == torch.from_numpy(a["h0"][row])).all()


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_fused_cell_gradients_match_jax(kind, reverse):
    """d(x, h0, c0, w) of a weighted sum of the outputs: the port's manual
    reverse-time backward against jax.grad through the JAX package's."""
    a = _args(kind, LENGTHS["with_zero"], seed=1)
    r = np.random.RandomState(2)
    cot = [r.randn(B, T, H).astype("float32") for _ in range(2)]
    names = ["x", "h0", "c0", "w"] if kind == "lstm" else ["x", "h0", "w"]
    jfn = _jax_fn(kind, a, reverse, "xla")

    def jloss(*args):
        full = dict(zip(names, args))
        outs = jfn(full["x"], full["h0"], full.get("c0"), full["w"])
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    jgrads = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jnp.asarray(a[n]) for n in names))
    leaves = {n: torch.from_numpy(a[n]).requires_grad_() for n in names}
    touts = _port_fn(kind, a, reverse)(
        leaves["x"], leaves["h0"], leaves.get("c0"), leaves["w"])
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(touts, cot))
    tgrads = torch.autograd.grad(loss, [leaves[n] for n in names])
    for n, jg, tg in zip(names, jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                                   rtol=1e-4, err_msg=f"d{n}")


def test_stash_only_when_a_gradient_is_wanted(monkeypatch):
    """Under no_grad (the executor outside a vjp_region) the cells run
    without the gate stash, as the JAX forward without vjp does."""
    asked = []
    plain = trec.lstm_seq_plain

    def spy(*args):
        asked.append(args[-1])
        return plain(*args)
    monkeypatch.setattr(trec, "lstm_seq_plain", spy)
    a = _args("lstm", LENGTHS["ragged"])
    x, h0, c0, w = (torch.from_numpy(a[k]) for k in ("x", "h0", "c0", "w"))
    sl = torch.from_numpy(a["seqlen"])
    with torch.no_grad():
        trec.fused_lstm_sequence(x.requires_grad_(), h0, c0, w, sl)
    trec.fused_lstm_sequence(x, h0, c0, w, sl)
    assert asked == [False, True]


def test_cuda_wrappers_refuse_cpu_tensors():
    a = _args("gru", LENGTHS["ragged"])
    x, h0, w = (torch.from_numpy(a[k]) for k in ("x", "h0", "w"))
    with pytest.raises(ValueError, match="CUDA"):
        trec.gru_seq_cuda(x, h0, w, torch.from_numpy(a["seqlen"]), False,
                          False)


@pytest.mark.parametrize("n_gates,hd,ug,groups,blocks,hp", [
    (4, 1100, 4, 3, 92, 1100),   # the LSTM at H = 1100 on 132 SMs
    (4, 2048, 4, 4, 128, 2048),  # the LSTM at H = 2048
    (4, 10, 4, 2, 2, 12),        # rows rounded up to 4, units past H
    (3, 1100, 8, 2, 69, 1100),   # the GRU at H = 1100, before K6's redesign
    (3, 7, 2, 1, 4, 7),
    (3, 1100, 4, 3, 92, 1100),   # the GRU at H = 1100 on 132 SMs
    (3, 2048, 4, 4, 128, 2048),  # the GRU at H = 2048
    (3, 10, 4, 2, 2, 12),        # rows rounded up to 4, units past H
])
def test_relay_w_layout_round_trip(n_gates, hd, ug, groups, blocks, hp):
    """The copy of w the kernels stream where a block's gate columns do not
    fit shared memory: block g's column group c holds, at [k, gate·ug + u],
    w[k, gate·H + j] for unit j = (g·groups + c)·ug + u. Every weight is
    read back from where the kernel reads it; rows and units past H are
    zeros."""
    w = np.random.RandomState(hd).randn(hd, n_gates * hd).astype("float32")
    rel = trec.relay_w(torch.from_numpy(w), n_gates, ug, groups, blocks,
                       hp).numpy()
    assert rel.shape == (blocks, groups, hp, n_gates * ug)
    assert not rel[:, :, hd:].any()
    back = np.full_like(w, np.nan)
    for blk in range(blocks):
        for cg in range(groups):
            for u in range(ug):
                j = (blk * groups + cg) * ug + u
                cols = [gate * ug + u for gate in range(n_gates)]
                if j < hd:
                    back[:, j::hd] = rel[blk, cg, :hd, cols].T
                else:
                    assert not rel[blk, cg, :, cols].any()
    np.testing.assert_array_equal(back, w)


def _seq_op_ins(kind, seed=3):
    a = _args(kind, LENGTHS["with_zero"], seed)
    g = 4 if kind == "lstm" else 3
    bias = np.random.RandomState(seed).randn(
        (7 if kind == "lstm" else 3) * H).astype("float32") * .1
    ins = {"Input": [a["x"][..., :g * H]], "Weight": [a["w"]],
           "Bias": [bias], "SeqLen": [a["seqlen"]], "H0": [a["h0"]]}
    if kind == "lstm":
        ins["C0"] = [a["c0"]]
    return ins


@pytest.mark.parametrize("op_type,attrs", [
    ("dynamic_lstm", {"candidate_activation": "relu", "is_reverse": True}),
    ("dynamic_lstm", {"gate_activation": "sigmoid",
                      "cell_activation": "identity"}),
    ("dynamic_lstm", {}),
    ("dynamic_gru", {"activation": "relu"}),
    ("dynamic_gru", {"is_reverse": True}),
])
def test_unfused_cell_op_matches_jax(op_type, attrs):
    ins = _seq_op_ins("lstm" if op_type == "dynamic_lstm" else "gru")
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()},
        dict(attrs))
    tout = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {s: [torch.from_numpy(v) for v in vs]
                          for s, vs in ins.items()}, dict(attrs))
    assert set(tout) == set(jout)
    for slot in jout:
        np.testing.assert_allclose(tout[slot][0].numpy(),
                                   np.asarray(jout[slot][0]), atol=1e-5,
                                   rtol=1e-5, err_msg=slot)
    fusable = (trec.lstm_attrs_fusable if op_type == "dynamic_lstm"
               else trec.gru_attrs_fusable)(attrs)
    assert fusable == (jrec.lstm_attrs_fusable if op_type == "dynamic_lstm"
                       else jrec.gru_attrs_fusable)(attrs)


@pytest.mark.parametrize("op_type", ["fused_lstm", "fused_gru"])
def test_fused_cell_op_matches_jax(op_type):
    """The registered fused ops, [7H] peephole bias included, against the
    JAX package's (XLA backend: its composite on the CPU)."""
    kind = "lstm" if op_type == "fused_lstm" else "gru"
    ins = _seq_op_ins(kind, seed=4)
    attrs = {"is_reverse": True, "backend": "xla"}
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {s: [jnp.asarray(v) for v in vs] for s, vs in ins.items()}, attrs)
    tout = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {s: [torch.from_numpy(v) for v in vs]
                          for s, vs in ins.items()}, attrs)
    for slot in jout:
        np.testing.assert_allclose(tout[slot][0].numpy(),
                                   np.asarray(jout[slot][0]), atol=1e-5,
                                   rtol=1e-5, err_msg=slot)


def test_non_default_activation_stays_unfused_and_flag_off_raises_on_cuda():
    """The pass rewrites default-activation cells only; with the flag off an
    executor on a CUDA device refuses a fusable cell (checked at planning,
    before anything runs)."""
    from paddle_tpu_torch.core import flags
    prog = ptt.Program()
    with ptt.program_guard(prog, ptt.Program()):
        x = ptt.layers.data("x", shape=[T, 4 * H], dtype="float32",
                            lod_level=1)
        h1, _ = ptt.layers.dynamic_lstm(x, size=4 * H)
        ptt.layers.dynamic_lstm(x, size=4 * H, candidate_activation="relu")
        proj = ptt.layers.sequence.tag_sequence(
            ptt.layers.fc(h1, size=3 * H, num_flatten_dims=2),
            h1.seqlen_var)
        ptt.layers.dynamic_gru(proj, size=H)
    fused = apply_fusion_passes(prog)
    assert [op.type for op in fused.global_block().ops
            if "lstm" in op.type or "gru" in op.type] == \
        ["fused_lstm", "dynamic_lstm", "fused_gru"]
    assert fused is not prog and \
        [op.type for op in prog.global_block().ops].count("fused_lstm") == 0
    apply_fusion_passes(prog, require_fused=True)       # all fused: fine
    prev = flags.get_flag("fuse_recurrent_cells")
    flags.set_flag("fuse_recurrent_cells", False)
    try:
        assert apply_fusion_passes(prog) is prog
        with pytest.raises(InvalidArgumentError,
                           match="fuse_recurrent_cells"):
            apply_fusion_passes(prog, require_fused=True)
    finally:
        flags.set_flag("fuse_recurrent_cells", prev)


def test_decode_attention_gradient_at_nmt_form_matches_jax():
    """q [B, 1, H] over the encoder's [B, T, H] (K = V), a [B, 1, T] mask:
    d(q, enc, bias) of a weighted sum of the output."""
    r = np.random.RandomState(5)
    b, t, h = 3, 7, 40
    q = r.randn(b, 1, h).astype("float32")
    enc = r.randn(b, t, h).astype("float32")
    lens = np.array([[7], [2], [5]])
    bias = np.where(np.arange(t)[None] < lens, 0.0, -1e9).astype(
        "float32")[:, None, :]
    cot = r.randn(b, 1, h).astype("float32")

    def jloss(q_, e_, b_):
        out = jda.fused_decode_attention(q_, e_, e_, b_, scale=1.0,
                                         backend="xla")
        return jnp.sum(out * cot)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(enc),
                                           jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, enc, bias)]
    out = tda.fused_decode_attention(leaves[0], leaves[1], leaves[1],
                                     leaves[2], scale=1.0)
    assert out.grad_fn is not None
    tg = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), leaves)
    for name, a, bb in zip(("q", "enc", "bias"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(bb), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")


def _probe_edits():
    import probe_recurrent
    return [(kind, name, edits)
            for kind, variants in probe_recurrent.VARIANTS.items()
            for name, edits in variants.items()]


@pytest.mark.parametrize("kind,name,edits", _probe_edits(),
                         ids=[f"{k}-{n}" for k, n, _ in _probe_edits()])
def test_probe_variants_match_the_kernel_source(kind, name, edits):
    """probe_recurrent.py splits a step of K5 or K6 by part by editing the
    text of csrc/recurrent.cu (the FMAs, the staging, each grid barrier,
    the stores): each text it replaces must occur exactly once, in its own
    kernel, so that the variant removes that part and nothing else."""
    import probe_recurrent
    with open(probe_recurrent.SOURCE) as f:
        text = f.read()
    k6 = text.index("// --- K6")
    for old, _ in edits:
        assert text.count(old) == 1, (kind, name, old)
        at = text.index(old)
        if kind == "gru":
            assert at > k6, (name, old)
        else:
            assert at + len(old) <= k6 + len("// --- K6"), (name, old)


# ---------------------------------------------------------------------------
# bfloat16 cells: the plain version against the JAX package's XLA composite
# (which the JAX package takes for any type but float32), both rounding
# every op to bfloat16 and carrying h and c in bfloat16
# ---------------------------------------------------------------------------

TB = 12     # T of the bfloat16 cases (T <= 16: the tolerance grows with T)


def _bf16_args(kind, seed=4):
    r = np.random.RandomState(seed)
    g = 4 if kind == "lstm" else 3
    return {"x": (r.randn(B, TB, g * H) * .3).astype("float32"),
            "h0": (r.randn(B, H) * .1).astype("float32"),
            "c0": (r.randn(B, H) * .1).astype("float32"),
            "w": (r.randn(H, g * H) * .1).astype("float32"),
            "seqlen": np.asarray([TB, 0, 1, TB - 3], "int32")}


def _bf16(a):
    return ({k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in a.items()
             if k != "seqlen"},
            {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in a.items()
             if k != "seqlen"})


def _jax_steps(kind, x, hp, cp, w, valid):
    """The JAX composite's step from given states, every (row, step) a row
    of its own: x [B, T, G·H], hp/cp [B, T, H] → the step's outputs, each
    [B, T, ·], as float32 numpy."""
    b, t, gh = x.shape
    flat = lambda a: jnp.asarray(a.float().numpy()).astype(
        jnp.bfloat16).reshape(b * t, 1, -1)
    sl = jnp.asarray(valid.reshape(b * t).numpy().astype("int32"))
    xs = flat(x)
    h0 = flat(hp)[:, 0]
    wj = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    if kind == "lstm":
        outs = jrec._xla_lstm_seq(xs, h0, flat(cp)[:, 0], wj, sl, False,
                                  True)
    else:
        outs = jrec._xla_gru_seq(xs, h0, wj, sl, False, True)
    return [np.asarray(o.astype(jnp.float32)).reshape(b, t, -1)
            for o in outs]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bf16_plain_step_matches_the_xla_composite(kind, reverse):
    """Step by step: from the states the port's plain version carried into
    each step, its step and the JAX composite's step differ by at most
    twice the per-term slack of one per-op rounded step
    (`lstm_step_slack` / `gru_step_slack` with kernel=False: each rounded
    term moves by at most bfloat16's unit roundoff 2⁻⁸ of its size)."""
    a = _bf16_args(kind)
    _, tb = _bf16(a)
    sl = torch.from_numpy(a["seqlen"])
    if kind == "lstm":
        outs = trec.lstm_seq_plain(tb["x"], tb["h0"], tb["c0"], tb["w"], sl,
                                   reverse, True)
        hp = trec._prev_states(outs[0], tb["h0"])
        cp = trec._prev_states(outs[1], tb["c0"])
        slacks = trec.lstm_step_slack(tb["x"], hp, cp, tb["w"], kernel=False)
    else:
        outs = trec.gru_seq_plain(tb["x"], tb["h0"], tb["w"], sl, reverse,
                                  True)
        hp, cp = trec._prev_states(outs[0], tb["h0"]), None
        slacks = trec.gru_step_slack(tb["x"], hp, tb["w"], kernel=False)
    assert all(o.dtype == torch.bfloat16 for o in outs)
    valid = trec._step_valid(sl, TB, reverse)
    jouts = _jax_steps(kind, tb["x"], hp, cp, tb["w"], valid[..., 0])
    for n, (o, jo, s) in enumerate(zip(outs, jouts, slacks)):
        err = np.abs(o.float().numpy() - jo)
        assert (err <= 2 * s.numpy()).all(), (n, err.max(),
                                              (err / (2 * s.numpy())).max())
    ok, _, _ = trec.recurrent_step_check(kind, tb["x"], tb["h0"], tb["c0"],
                                         tb["w"], sl, reverse, outs,
                                         kernel=False)
    assert ok


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bf16_sequence_matches_the_xla_composite(kind, reverse):
    """The whole sequence, bfloat16 in and out, against
    `fused_lstm_sequence` / `fused_gru_sequence` of the JAX package in
    bfloat16 (its XLA composite on the CPU): the two may drift apart by
    the sum over the T steps of each step's largest twofold slack, and a
    row of length 0 keeps h0 exactly."""
    a = _bf16_args(kind, seed=5)
    jb, tb = _bf16(a)
    sl = torch.from_numpy(a["seqlen"])
    jsl = jnp.asarray(a["seqlen"])
    if kind == "lstm":
        jo = jrec.fused_lstm_sequence(jb["x"], jb["h0"], jb["c0"], jb["w"],
                                      jsl, reverse=reverse)
        to = trec.fused_lstm_sequence(tb["x"], tb["h0"], tb["c0"], tb["w"],
                                      sl, reverse=reverse)
    else:
        jo = (jrec.fused_gru_sequence(jb["x"], jb["h0"], jb["w"], jsl,
                                      reverse=reverse),)
        to = (trec.fused_gru_sequence(tb["x"], tb["h0"], tb["w"], sl,
                                      reverse=reverse),)
    # the step slacks along the JAX package's own trajectory
    xs = torch.flip(tb["x"], (1,)) if reverse else tb["x"]
    js = [torch.tensor(np.asarray(o.astype(jnp.float32))).to(
        torch.bfloat16) for o in jo]
    if reverse:
        js = [torch.flip(o, (1,)) for o in js]
    hp = trec._prev_states(js[0], tb["h0"])
    if kind == "lstm":
        cp = trec._prev_states(js[1], tb["c0"])
        slack = trec.lstm_step_slack(xs, hp, cp, tb["w"], kernel=False)[:2]
    else:
        slack = trec.gru_step_slack(xs, hp, tb["w"], kernel=False)[:1]
    for o, j, s in zip(to, js, slack):
        assert o.dtype == torch.bfloat16
        tol = float((2 * s).amax(dim=(0, 2)).sum())
        if reverse:
            j = torch.flip(j, (1,))
        err = float((o.float() - j.float()).abs().max())
        assert err <= tol, (err, tol)
    assert (to[0][1] == tb["h0"][1]).all()


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bf16_step_check_rejects_wrong_cells(kind):
    """`recurrent_step_check`, phase 3's gate for the bfloat16 kernels,
    passes the plain version's own outputs and rejects three wrong cells:
    the gate columns of w rotated, the length freeze dropped, and the
    freeze taken at the reversed steps."""
    a = _bf16_args(kind, seed=6)
    _, tb = _bf16(a)
    sl = torch.from_numpy(a["seqlen"])
    g = 4 if kind == "lstm" else 3
    states = (tb["h0"], tb["c0"]) if kind == "lstm" else (tb["h0"],)

    def run(x, w, seqlen, reverse=False):
        fn = trec.lstm_seq_plain if kind == "lstm" else trec.gru_seq_plain
        return fn(x, *states, w, seqlen, reverse, True)

    def check(outs):
        return trec.recurrent_step_check(kind, tb["x"], tb["h0"], tb["c0"],
                                         tb["w"], sl, False, outs)[0]

    assert check(run(tb["x"], tb["w"], sl))
    rotated = torch.roll(tb["w"].reshape(H, g, H), 1, dims=1).reshape(H, -1)
    assert not check(run(tb["x"], rotated, sl))
    assert not check(run(tb["x"], tb["w"], torch.full_like(sl, TB)))
    assert not check(run(tb["x"], tb["w"], sl, reverse=True))


@pytest.mark.parametrize("kind", ["lstm", "gru"])
def test_bf16_gradients_come_back_in_the_inputs_type(kind):
    """The manual backward in float32 from bfloat16 residuals returns
    bfloat16 gradients, as `_fused_lstm_bwd` / `_fused_gru_bwd` cast them,
    close to the JAX package's: both differentiate the same stash up to the
    forward's roundings, so within 2⁻⁸·T of the largest gradient."""
    a = _bf16_args(kind, seed=7)
    jb, tb = _bf16(a)
    names = ["x", "h0", "c0", "w"] if kind == "lstm" else ["x", "h0", "w"]
    cot = np.random.RandomState(8).randn(B, TB, H).astype("float32")
    jsl = jnp.asarray(a["seqlen"])

    def jloss(*args):
        f = dict(zip(names, args))
        if kind == "lstm":
            hs, _ = jrec.fused_lstm_sequence(f["x"], f["h0"], f["c0"],
                                             f["w"], jsl)
        else:
            hs = jrec.fused_gru_sequence(f["x"], f["h0"], f["w"], jsl)
        return jnp.sum(hs.astype(jnp.float32) * cot)

    jg = jax.grad(jloss, argnums=tuple(range(len(names))))(
        *(jb[n] for n in names))
    leaves = {n: tb[n].clone().requires_grad_() for n in names}
    sl = torch.from_numpy(a["seqlen"])
    if kind == "lstm":
        hs, _ = trec.fused_lstm_sequence(leaves["x"], leaves["h0"],
                                         leaves["c0"], leaves["w"], sl)
    else:
        hs = trec.fused_gru_sequence(leaves["x"], leaves["h0"], leaves["w"],
                                     sl)
    tg = torch.autograd.grad((hs.float() * torch.from_numpy(cot)).sum(),
                             [leaves[n] for n in names])
    for n, j, t in zip(names, jg, tg):
        assert t.dtype == torch.bfloat16, n
        jf = np.asarray(j.astype(jnp.float32))
        tol = 2.0 ** -8 * TB * max(1.0, float(np.abs(jf).max()))
        np.testing.assert_allclose(t.float().numpy(), jf, atol=tol, rtol=0,
                                   err_msg=f"d{n}")
