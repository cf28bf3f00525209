"""The image slice's ops — conv2d, conv3d, depthwise_conv2d,
conv2d_transpose, conv3d_transpose, pool2d, pool3d, batch_norm — against
the JAX package's lowerings, values and gradients.

One numpy input dict (made from a seed, or picked by hand for the edge
cases) goes through both registries, as tests/test_torch_ops.py does, and
d(sum(out · w))/d(inputs) through the port's autograd against jax.grad
through the JAX lowering. Tolerances: float32 values and gradients at
1e-5 of the largest magnitude of the reference's result (summation
order); bfloat16 results at 2^-6 of it (two bfloat16 steps: the
libraries round the float32 accumulation once, but sum in another
order); max-pool gradients on tied windows exactly (both pick the first
maximum of a window).
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
import paddle_tpu_torch as ptt
from paddle_tpu.framework import registry as jreg
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.executor import as_numpy

from tests.port_env import port_jax_compile_cache  # noqa: F401

R = np.random.RandomState(10)


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def f32(*shape):
    return R.randn(*shape).astype("float32")


def _bn_ins(x, c, shift=0.0):
    return {"X": [x], "Scale": [f32(c)], "Bias": [f32(c)],
            "Mean": [(f32(c) * 0.1 + shift).astype("float32")],
            "Variance": [(np.abs(f32(c)) + 0.5).astype("float32")]}


def _bn_constant_channel():
    """Channel 0 holds 2.5 everywhere and its running mean is 0.5: the
    shifted moments are exact (2 and 4), so the variance is exactly 0 in
    both packages and 1/sqrt(0 + eps) is compared, not a rounding
    residue."""
    ins = _bn_ins(np.concatenate([np.full((4, 1, 3, 3), 2.5, "float32"),
                                  f32(4, 2, 3, 3)], 1), 3)
    ins["Mean"][0][0] = 0.5
    return ins


def _pool(ptype, k, s, p, **kw):
    return dict({"pooling_type": ptype, "ksize": k, "strides": s,
                 "paddings": p}, **kw)


def _conv(s=(1, 1), p=(0, 0), d=(1, 1), g=1, fmt="NCHW", bf16=False):
    return {"strides": list(s), "paddings": list(p), "dilations": list(d),
            "groups": g, "data_format": fmt, "use_bf16": bf16}


# (id, op type, ins, attrs, input dtypes {slot: dtype}, slots fed to the
#  gradient check)
CASES = [
    ("conv2d_nchw", "conv2d", {"Input": [f32(2, 3, 9, 8)],
                               "Filter": [f32(4, 3, 3, 3)]},
     _conv((2, 1), (1, 2), (1, 2)), {}, ("Input", "Filter")),
    ("conv2d_nhwc", "conv2d", {"Input": [f32(2, 9, 8, 3)],
                               "Filter": [f32(4, 3, 3, 3)]},
     _conv((2, 1), (1, 2), (1, 2), fmt="NHWC"), {}, ("Input", "Filter")),
    ("conv2d_nhwc_7x7_s2", "conv2d", {"Input": [f32(2, 16, 16, 3)],
                                      "Filter": [f32(8, 3, 7, 7)]},
     _conv((2, 2), (3, 3), fmt="NHWC"), {}, ("Input", "Filter")),
    ("conv2d_groups", "conv2d", {"Input": [f32(2, 4, 7, 7)],
                                 "Filter": [f32(6, 2, 3, 3)]},
     _conv(p=(1, 1), g=2), {}, ("Input", "Filter")),
    ("conv2d_groups_nhwc", "conv2d", {"Input": [f32(2, 6, 6, 8)],
                                      "Filter": [f32(8, 2, 3, 3)]},
     _conv((2, 2), (1, 1), g=4, fmt="NHWC"), {}, ("Input", "Filter")),
    ("depthwise_nchw", "depthwise_conv2d", {"Input": [f32(2, 5, 7, 6)],
                                            "Filter": [f32(5, 1, 3, 3)]},
     _conv(p=(1, 1)), {}, ("Input", "Filter")),
    ("depthwise_nhwc_mult2", "depthwise_conv2d",
     {"Input": [f32(2, 7, 6, 3)], "Filter": [f32(6, 1, 3, 3)]},
     _conv((2, 2), (1, 1), fmt="NHWC"), {}, ("Input", "Filter")),
    ("conv2d_bf16_nhwc", "conv2d", {"Input": [f32(2, 8, 8, 16)],
                                    "Filter": [f32(8, 16, 3, 3)]},
     _conv(p=(1, 1), fmt="NHWC", bf16=True), {}, ("Input", "Filter")),
    ("conv2d_bf16_act_nchw", "conv2d", {"Input": [f32(2, 16, 6, 6)],
                                        "Filter": [f32(8, 16, 1, 1)]},
     _conv(bf16=True), {"Input": "bfloat16"}, ("Input", "Filter")),
    ("conv3d_ncdhw", "conv3d", {"Input": [f32(2, 3, 5, 6, 4)],
                                "Filter": [f32(4, 3, 3, 2, 3)]},
     {"strides": [1, 2, 1], "paddings": [1, 0, 1],
      "dilations": [1, 1, 2], "groups": 1}, {}, ("Input", "Filter")),
    ("conv3d_ndhwc", "conv3d", {"Input": [f32(2, 5, 6, 4, 3)],
                                "Filter": [f32(4, 3, 3, 3, 3)]},
     {"strides": [2, 1, 1], "paddings": [1, 1, 1], "dilations": [1, 1, 1],
      "groups": 1, "data_format": "NDHWC"}, {}, ("Input", "Filter")),
    ("conv2d_transpose_s2_d2", "conv2d_transpose",
     {"Input": [f32(2, 3, 5, 4)], "Filter": [f32(3, 4, 3, 2)]},
     {"strides": [2, 3], "paddings": [1, 0], "dilations": [2, 1]}, {},
     ("Input", "Filter")),
    ("conv2d_transpose_pad_past_k", "conv2d_transpose",
     {"Input": [f32(1, 2, 6, 6)], "Filter": [f32(2, 3, 3, 3)]},
     {"strides": [2, 2], "paddings": [3, 2], "dilations": [1, 1]}, {},
     ("Input", "Filter")),
    ("conv3d_transpose", "conv3d_transpose",
     {"Input": [f32(1, 2, 3, 4, 3)], "Filter": [f32(2, 3, 2, 3, 2)]},
     {"strides": [2, 1, 2], "paddings": [0, 1, 1], "dilations": [1, 2, 1]},
     {}, ("Input", "Filter")),
    # pool2d / pool3d
    ("max_resnet_pool1_nhwc", "pool2d", {"X": [f32(2, 9, 8, 3)]},
     _pool("max", [3, 3], [2, 2], [1, 1], data_format="NHWC"), {}, ("X",)),
    ("max_resnet_pool1_nchw", "pool2d", {"X": [f32(2, 3, 9, 8)]},
     _pool("max", [3, 3], [2, 2], [1, 1]), {}, ("X",)),
    ("max_pad_past_half_window", "pool2d", {"X": [f32(2, 3, 7, 6)]},
     _pool("max", [2, 3], [2, 2], [2, 2]), {}, ("X",)),
    ("max_ceil", "pool2d", {"X": [f32(2, 3, 8, 7)]},
     _pool("max", [3, 3], [2, 2], [0, 1], ceil_mode=True), {}, ("X",)),
    ("max_ceil_window_in_padding", "pool2d", {"X": [f32(1, 2, 5, 5)]},
     _pool("max", [2, 2], [3, 3], [2, 2], ceil_mode=True,
           data_format="NHWC"), {}, ("X",)),
    ("avg_ceil_exclusive", "pool2d", {"X": [f32(2, 3, 8, 7)]},
     _pool("avg", [3, 3], [2, 2], [1, 1], ceil_mode=True), {}, ("X",)),
    ("avg_ceil_inclusive", "pool2d", {"X": [f32(2, 8, 7, 3)]},
     _pool("avg", [3, 3], [2, 2], [1, 1], ceil_mode=True, exclusive=False,
           data_format="NHWC"), {}, ("X",)),
    ("avg_ceil_exclusive_no_pad", "pool2d", {"X": [f32(2, 3, 8, 7)]},
     _pool("avg", [3, 2], [2, 3], [0, 0], ceil_mode=True), {}, ("X",)),
    ("avg_pad_past_half_window_nhwc", "pool2d", {"X": [f32(2, 6, 7, 3)]},
     _pool("avg", [2, 2], [2, 2], [2, 1], data_format="NHWC"), {}, ("X",)),
    ("avg_global_nhwc", "pool2d", {"X": [f32(2, 7, 7, 5)]},
     _pool("avg", [1, 1], [1, 1], [0, 0], global_pooling=True,
           data_format="NHWC"), {}, ("X",)),
    ("max_global_nchw", "pool2d", {"X": [f32(2, 5, 4, 6)]},
     _pool("max", [1, 1], [1, 1], [0, 0], global_pooling=True), {}, ("X",)),
    ("avg_global_bf16", "pool2d", {"X": [f32(2, 7, 7, 8)]},
     _pool("avg", [1, 1], [1, 1], [0, 0], global_pooling=True,
           data_format="NHWC"), {"X": "bfloat16"}, ("X",)),
    ("max_bf16_nhwc", "pool2d", {"X": [f32(2, 9, 9, 4)]},
     _pool("max", [3, 3], [2, 2], [1, 1], data_format="NHWC"),
     {"X": "bfloat16"}, ("X",)),
    ("pool3d_avg_ceil_ndhwc", "pool3d", {"X": [f32(1, 5, 6, 4, 2)]},
     _pool("avg", [2, 3, 2], [2, 2, 2], [1, 1, 0], ceil_mode=True,
           data_format="NDHWC"), {}, ("X",)),
    ("pool3d_max_ncdhw", "pool3d", {"X": [f32(1, 2, 5, 6, 4)]},
     _pool("max", [3, 3, 2], [2, 2, 2], [1, 1, 1]), {}, ("X",)),
    # batch_norm
    ("bn_train_nchw", "batch_norm", _bn_ins(f32(4, 3, 5, 4) * 2 + 1, 3),
     {"data_layout": "NCHW"}, {}, ("X", "Scale", "Bias")),
    ("bn_train_nhwc_shifted", "batch_norm",
     _bn_ins(f32(4, 5, 4, 6) + 30.0, 6, shift=29.0),
     {"data_layout": "NHWC", "momentum": 0.8, "epsilon": 1e-3}, {},
     ("X", "Scale", "Bias")),
    ("bn_train_2d_nhwc", "batch_norm", _bn_ins(f32(8, 6), 6),
     {"data_layout": "NHWC"}, {}, ("X", "Scale", "Bias")),
    ("bn_train_bf16_nhwc", "batch_norm", _bn_ins(f32(4, 3, 3, 8), 8),
     {"data_layout": "NHWC"}, {"X": "bfloat16"}, ("X", "Scale", "Bias")),
    ("bn_train_constant_channel", "batch_norm",
     _bn_constant_channel(), {"data_layout": "NCHW"}, {},
     ("X", "Scale", "Bias")),
    ("bn_test_nhwc", "batch_norm", _bn_ins(f32(2, 3, 3, 4), 4),
     {"data_layout": "NHWC", "is_test": True}, {}, ("X", "Scale", "Bias")),
    # Scale's and Bias's gradients here are bfloat16 reductions over N·H·W,
    # which the reference's CPU backend accumulates in bfloat16, a rounding
    # an add; they are held in float32 by bn_test_nhwc
    ("bn_test_bf16_nchw", "batch_norm", _bn_ins(f32(2, 4, 3, 3), 4),
     {"data_layout": "NCHW", "is_test": True}, {"X": "bfloat16"}, ("X",)),
]


def _to_jax(a, dtype):
    return jnp.asarray(a, dtype=getattr(jnp, dtype)) if dtype \
        else jnp.asarray(a)


def _to_torch(a, dtype):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)) if dtype else t


def _np(v):
    if isinstance(v, torch.Tensor):
        return as_numpy(v)
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                      else v)


def _close(got, want, bf16, what):
    scale = max(1.0, float(np.abs(want[np.isfinite(want)]).max(initial=0)))
    tol = (2 ** -6 if bf16 else 1e-5) * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, equal_nan=True,
                               err_msg=what)


def _lower(op_type, ins, attrs, in_dtypes):
    jins = {s: [_to_jax(a, in_dtypes.get(s)) for a in v]
            for s, v in ins.items()}
    tins = {s: [_to_torch(a, in_dtypes.get(s)) for a in v]
            for s, v in ins.items()}
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)), jins, dict(attrs))
    tout = treg.lookup_op(op_type).lower(treg.LowerCtx(), tins, dict(attrs))
    return jout, tout


def _main_out(op_type):
    return {"batch_norm": "Y", "pool2d": "Out",
            "pool3d": "Out"}.get(op_type, "Output")


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_image_op_matches_jax_lowering(case):
    _, op_type, ins, attrs, in_dtypes, _ = case
    jout, tout = _lower(op_type, ins, attrs, in_dtypes)
    assert set(tout) == set(jout)
    for slot, jvals in jout.items():
        jv, tv = jvals[0], tout[slot][0]
        jdt, tdt = str(jv.dtype), str(tv.dtype).replace("torch.", "")
        assert tdt == jdt, (slot, jdt, tdt)
        assert tuple(tv.shape) == tuple(jv.shape), (slot, tv.shape, jv.shape)
        _close(_np(tv), _np(jv), tdt == "bfloat16", slot)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_image_op_gradient_matches_jax(case):
    """d(sum(out · w))/d(each float input) against jax.grad; a gradient
    of a bfloat16 input comes back bfloat16 in both. Where the op computes
    in bfloat16 (a bfloat16 input, or use_bf16), every gradient passed
    through bfloat16 arithmetic and is held at the bfloat16 tolerance."""
    name, op_type, ins, attrs, in_dtypes, slots = case
    out_slot = _main_out(op_type)
    jout, _ = _lower(op_type, ins, attrs, in_dtypes)
    w = np.random.RandomState(zlib.crc32(name.encode())).randn(
        *jout[out_slot][0].shape).astype("float32")

    def jloss(*vals):
        jins = {s: [_to_jax(a, in_dtypes.get(s)) for a in v]
                for s, v in ins.items()}
        jins.update({s: [v] for s, v in zip(slots, vals)})
        out = jreg.lookup_op(op_type).lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)), jins,
            dict(attrs))[out_slot][0]
        return jnp.sum(jnp.where(jnp.isfinite(out), out, 0)
                       .astype(jnp.float32) * w)

    jgrads = jax.grad(jloss, argnums=tuple(range(len(slots))))(
        *[_to_jax(ins[s][0], in_dtypes.get(s)) for s in slots])
    tins = {s: [_to_torch(a, in_dtypes.get(s)) for a in v]
            for s, v in ins.items()}
    leaves = [tins[s][0].requires_grad_() for s in slots]
    out = treg.lookup_op(op_type).lower(treg.LowerCtx(), tins,
                                        dict(attrs))[out_slot][0]
    (torch.where(out.isfinite(), out, 0).float()
     * torch.from_numpy(w)).sum().backward()
    in_bf16 = bool(in_dtypes) or attrs.get("use_bf16", False)
    for s, jg, leaf in zip(slots, jgrads, leaves):
        assert str(leaf.grad.dtype).replace("torch.", "") == str(jg.dtype)
        _close(_np(leaf.grad), _np(jg), in_bf16, f"d/d{s}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["NHWC", "NCHW"])
def test_max_pool_ties_pick_the_same_element(dtype, fmt):
    """ResNet's pool1 (3x3, stride 2, pad 1) on integer-valued relu
    outputs: most windows hold tied maxima (zeros, or equal integers).
    XLA's select-and-scatter and torch's max_pool backward both give a
    window's gradient to its first maximum, so the gradients are equal
    bit for bit, through the relu before the pool as well."""
    shape = (3, 11, 10, 4) if fmt == "NHWC" else (3, 4, 11, 10)
    pre = R.randint(-3, 3, shape).astype("float32")
    attrs = _pool("max", [3, 3], [2, 2], [1, 1], data_format=fmt)
    x = np.maximum(pre, 0)
    jout, _ = _lower("pool2d", {"X": [x]}, attrs, {"X": dtype})
    w = R.randint(1, 5, jout["Out"][0].shape).astype("float32")

    def jloss(p):
        out = jreg.lookup_op("pool2d").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"X": [jax.nn.relu(p)]}, dict(attrs))["Out"][0]
        return jnp.sum(out.astype(jnp.float32) * w)

    jg = _np(jax.grad(jloss)(_to_jax(pre, dtype)))
    tp = _to_torch(pre, dtype).requires_grad_()
    out = treg.lookup_op("pool2d").lower(
        treg.LowerCtx(), {"X": [torch.relu(tp)]}, dict(attrs))["Out"][0]
    (out.float() * torch.from_numpy(w)).sum().backward()
    tg = as_numpy(tp.grad)
    windows = jout["Out"][0].size
    assert (tg != 0).sum() < windows      # ties: some windows share a max
    np.testing.assert_array_equal(tg, jg)


def test_batch_norm_updates_running_stats_in_place():
    """batch_norm whose MeanOut / VarianceOut are its Mean / Variance (what
    the layer appends) moves the running statistics in the tensors it
    reads; the values equal the out-of-place update."""
    from paddle_tpu_torch.framework.program import Program
    from paddle_tpu_torch.framework.registry import LowerCtx
    ins = _bn_ins(f32(4, 3, 3, 5), 5)
    attrs = {"data_layout": "NHWC", "momentum": 0.9, "epsilon": 1e-5}
    block = Program().global_block()
    op = block.append_op(
        "batch_norm",
        inputs={s: [s.lower()] for s in ins},
        outputs={"Y": ["y"], "MeanOut": ["mean"],
                 "VarianceOut": ["variance"], "SavedMean": ["sm"],
                 "SavedVariance": ["sv"]}, attrs=attrs)
    tins = {s: [torch.from_numpy(v[0].copy())] for s, v in ins.items()}
    fresh = treg.lookup_op("batch_norm").lower(
        LowerCtx(), {s: [t[0].clone()] for s, t in tins.items()}, attrs)
    out = treg.lookup_op("batch_norm").lower(LowerCtx(op=op), tins, attrs)
    for slot, src in (("MeanOut", "Mean"), ("VarianceOut", "Variance")):
        assert out[slot][0] is tins[src][0], slot
        assert torch.equal(out[slot][0], fresh[slot][0]), slot


def test_batch_norm_backward_saves_no_float32_activation():
    """The closed-form backward keeps x as it is (bfloat16 here) and
    [C]-sized statistics: no saved tensor is a float32 activation."""
    x = torch.from_numpy(f32(4, 6, 6, 8)).to(torch.bfloat16)
    ins = {k: [torch.from_numpy(v[0])] for k, v in _bn_ins(
        f32(4, 6, 6, 8), 8).items()}
    ins["X"] = [x.requires_grad_()]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        treg.lookup_op("batch_norm").lower(
            treg.LowerCtx(), ins, {"data_layout": "NHWC"})
    assert saved
    big = [t for t in saved if t.numel() > 8]
    assert all(t.dtype == torch.bfloat16 for t in big), \
        [(t.dtype, tuple(t.shape)) for t in saved]


@pytest.mark.parametrize("kind", ["2d", "3d"])
def test_conv_transpose_output_size_layer_matches_jax(kind):
    """The conv{2,3}d_transpose layers' output_size path (the filter size
    derived from it), stride and dilation > 1: the same program in both
    packages, the same output from the JAX package's initial weights."""
    outs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            if kind == "2d":
                x = pkg.layers.data("x", shape=[3, 5, 4])
                y = pkg.layers.conv2d_transpose(
                    x, num_filters=4, output_size=[11, 9], stride=2,
                    padding=1, act="relu")
            else:
                x = pkg.layers.data("x", shape=[2, 3, 4, 3])
                y = pkg.layers.conv3d_transpose(
                    x, num_filters=3, output_size=[7, 9, 7], stride=[2, 2, 1],
                    padding=[1, 0, 1], dilation=[2, 1, 2])
        outs.append((main, start, y))
    (jm, js, jy), (tm, _, ty) = outs
    assert jm.to_json() == tm.to_json()
    assert list(ty.shape) == list(jy.shape)
    jscope = pt.Scope()
    pt.Executor().run(js, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    feed = {"x": R.randn(2, *jy.block.var("x").shape[1:]).astype("float32")}
    jv = np.asarray(pt.Executor().run(jm, feed=feed, fetch_list=[jy],
                                      scope=jscope)[0])
    tv = ptt.Executor(ptt.CPUPlace()).run(tm, feed=feed, fetch_list=[ty],
                                          scope=tscope)[0]
    assert tv.shape == jv.shape and tv.shape[2:] == tuple(
        [11, 9] if kind == "2d" else [7, 9, 7])
    _close(tv, jv, False, kind)
