"""The registry parity gate: the port lowers every op the JAX package
registers, and no other; `layers` has every public layer of the JAX
package's; every entry of API.spec (the JAX package's frozen public API)
resolves in the port but the two excluded on purpose; no module of the
port (nor chip_smoke.py) imports jax or the JAX package. A later gap
fails here, naming the missing names."""

import ast
import importlib
import inspect
import json
import os
import subprocess
import sys

import pytest

import paddle_tpu.layers as jlayers

import paddle_tpu_torch.layers as tlayers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# public names of paddle_tpu.layers that are not layers: the modules'
# imports (typing, numpy, helpers, initializers) reached through
# `from .nn import *`
NOT_LAYERS = {"ConstantInitializer", "InvalidArgumentError", "LayerHelper",
              "List", "NormalInitializer", "Optional", "ParamAttr",
              "Sequence", "Union", "Variable", "annotations", "dtype_name",
              "enforce", "np"}
# layers that wait for a later slice, each named in ROADMAP.md: none
WAITING_LAYERS = set()


# ops of the JAX package's parallel package that wait, with their item:
# none: the pipeline's boundary ops and region are ported
WAITING_OPS = set()


def test_port_registers_exactly_the_jax_ops():
    """In a fresh interpreter that imports both packages and both
    `parallel` packages (each registers its ops on import): other tests
    in the same process register ops of their own, or import JAX modules
    that register more."""
    code = ("import json, paddle_tpu as pt, paddle_tpu.parallel, "
            "paddle_tpu_torch as ptt, paddle_tpu_torch.parallel; "
            "print(json.dumps([pt.registered_ops(), "
            "ptt.registered_ops()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    jops, tops = (set(x) for x in json.loads(out.stdout.splitlines()[-1]))
    assert sorted(jops - tops) == sorted(WAITING_OPS), \
        "ops the port does not lower"
    assert sorted(tops - jops) == [], "ops only the port registers"
    assert len(jops) == 240 and len(tops) == 240


def test_port_layers_have_every_jax_layer():
    jnames = {n for n in dir(jlayers) if not n.startswith("_")}
    tnames = {n for n in dir(tlayers) if not n.startswith("_")}
    assert sorted(jnames - tnames - NOT_LAYERS) == sorted(WAITING_LAYERS)
    for n in sorted(jnames & tnames):
        j, t = getattr(jlayers, n), getattr(tlayers, n)
        if inspect.isfunction(j):
            # the same named parameters, so code written for one builds in
            # both (the port's unary layers all take **attrs)
            assert _named(t) == _named(j), n


def _named(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind != p.VAR_KEYWORD]


@pytest.mark.parametrize("module", ["nets", "metrics", "evaluator"])
def test_port_modules_have_the_jax_public_names(module):
    j = __import__(f"paddle_tpu.{module}", fromlist=["_"])
    t = __import__(f"paddle_tpu_torch.{module}", fromlist=["_"])
    jn = {n for n in dir(j) if not n.startswith("_") and callable(
        getattr(j, n)) and getattr(getattr(j, n), "__module__", "")
        .startswith("paddle_tpu.")}
    tn = {n for n in dir(t) if not n.startswith("_")}
    assert sorted(jn - tn) == []


# API.spec paths the port spells with CUDA where the JAX package says TPU
RENAMED = {"TPUPlace": "CUDAPlace", "is_compiled_with_tpu":
           "is_compiled_with_cuda"}
# deliberately not ported: the dataset downloader and its md5 cache (the
# port needs no network; data/common.py keeps tokenize and build_word_dict)
EXCLUDED = {"paddle_tpu.data.download", "paddle_tpu.data.md5file"}
# modules and names ported by the later slices (the generators, the
# single-card API, the transpilers, the host-side utilities)
PORTED_API = (
    "paddle_tpu.layers", "paddle_tpu.models", "paddle_tpu.initializer",
    "paddle_tpu.fusion", "paddle_tpu.observability.memory",
    "paddle_tpu.observability.scoped_tags",
    "paddle_tpu.observability.tracing.scoped_tags",
    "paddle_tpu.observability.tracing.current_tags",
    "paddle_tpu.observability.tracing.force_enable",
    "paddle_tpu.Executor.run_steps", "paddle_tpu.io.Executor.run_steps",
    "paddle_tpu.trainer.Executor.run_steps",
    "paddle_tpu.inferencer.Executor.run_steps", "paddle_tpu.io.as_numpy",
    "paddle_tpu.Pass", "paddle_tpu.registered_passes", "paddle_tpu.Analyzer",
    "paddle_tpu.SelectedRows", "paddle_tpu.device_count",
    "paddle_tpu.devices", "paddle_tpu.transpiler", "paddle_tpu.concurrency",
    "paddle_tpu.data.RecordIOScanner", "paddle_tpu.data.RecordIOWriter",
    "paddle_tpu.data.ParallelRecordLoader",
    "paddle_tpu.data.read_numpy_records",
    "paddle_tpu.data.write_numpy_records")


def _spec_paths():
    with open(os.path.join(ROOT, "API.spec")) as f:
        return [line.split("(")[0].split()[0] for line in f if line.strip()]


def _covers(prefix, path):
    return path == prefix or path.startswith(prefix + ".")


def _resolves(path):
    """`path` with paddle_tpu → paddle_tpu_torch and the TPU names mapped:
    the longest importable module prefix, then attributes."""
    parts = ["paddle_tpu_torch"] + [RENAMED.get(p, p)
                                    for p in path.split(".")[1:]]
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        try:
            for a in parts[i:]:
                obj = getattr(obj, a)
        except AttributeError:
            return False
        return True
    return False


def test_every_api_spec_entry_resolves_or_waits_on_a_named_item():
    """Every entry resolves in the port but the two excluded on purpose:
    no entry waits on a ROADMAP item any more."""
    paths = _spec_paths()
    assert len(paths) == 1375
    missing = [p for p in paths if not _resolves(p)]
    assert sorted(missing) == sorted(EXCLUDED)
    # the modules and names the later slices ported resolve too
    assert [p for p in paths if any(_covers(s, p) for s in PORTED_API)
            and not _resolves(p)] == []
    print(f"API.spec: {len(paths) - len(missing)} of {len(paths)} entries "
          f"resolve in the port, {len(EXCLUDED)} excluded")


def _sources():
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                if top in ("jax", "jaxlib", "paddle_tpu"):
                    bad.append(f"{os.path.relpath(path, ROOT)}:"
                               f"{node.lineno} {m}")
    # the native programs' C++ includes nothing of the JAX package (nor
    # of TensorFlow, which its native programs run on)
    native = os.path.join(ROOT, "paddle_tpu_torch", "csrc", "native")
    sources = sorted(f for f in os.listdir(native)
                     if f.endswith((".cc", ".h")))
    assert sources
    for f in sources:
        for lineno, line in enumerate(open(os.path.join(native, f)), 1):
            if line.lstrip().startswith("#include") and (
                    "paddle_tpu/" in line or "tensorflow" in line):
                bad.append(f"csrc/native/{f}:{lineno} {line.strip()}")
    assert bad == []


def _every_new_layer(pkg):
    """One program through the layers slice 15 added, on data layers:
    the fetch list of each one's outputs (nce's, which draws, last)."""
    L = pkg.layers
    D = L.detection
    x = L.data("x", shape=[6], stop_gradient=False)
    y = L.data("y", shape=[6])
    img = L.data("img", shape=[4, 6, 6], stop_gradient=False)
    lab = L.data("lab", shape=[1], dtype="int64")
    prob = L.softmax(x)
    outs = []
    for name in ("abs", "sin", "square", "round", "relu6", "softplus",
                 "softsign", "gelu", "silu", "logsigmoid", "tanh_shrink",
                 "leaky_relu", "elu", "hard_sigmoid", "swish", "brelu",
                 "soft_shrink", "hard_shrink", "thresholded_relu"):
        outs.append(getattr(L, name)(x))
    outs += [L.log(prob), L.rsqrt(prob), L.maxout(img, groups=2),
             L.prelu(img, mode="channel"), L.stack([x, y], axis=1),
             L.pad(x, [0, 0, 2, 1], pad_value=0.5), L.flatten(img, axis=2),
             L.scatter(x, L.argmin(y, axis=0), L.reduce_sum(y, dim=[0],
                                                           keep_dim=True)),
             L.label_smooth(prob, epsilon=0.1),
             L.cross_entropy(prob, lab), L.square_error_cost(x, y),
             L.smooth_l1(x, y), L.huber_loss(x, y, 0.7),
             L.log_loss(L.sigmoid(x), L.sigmoid(y)), L.hinge_loss(x, y),
             L.rank_loss(L.sigmoid(y), x, y),
             L.margin_rank_loss(L.sign(y), x, y),
             L.dice_loss(prob, lab), L.cos_sim(x, y),
             L.squared_l2_distance(x, y), L.squared_l2_norm(x),
             L.l2_normalize(x, axis=1), L.lrn(img, n=3),
             L.bilinear_tensor_product(x, y, size=3),
             L.image_resize(img, out_shape=[4, 9]),
             L.resize_bilinear(img, scale=0.5),
             L.image_resize_short(img, 3), L.spp(img, pyramid_height=2),
             L.hsigmoid(x, lab, num_classes=6),
             L.ones([2, 3]), L.zeros([2], dtype="int64"), L.zeros_like(x),
             L.reverse(x, axis=[0, 1]), L.argsort(y, axis=1)[1]]
    outs += list(L.split(img, 2, dim=1)) + list(L.auc(prob, lab)[1])
    outs += list(L.positive_negative_pair(
        L.reduce_sum(x, dim=[1], keep_dim=True), L.cast(lab, "float32"),
        lab))
    outs += [pkg.nets.glu(x), pkg.nets.scaled_dot_product_attention(
        L.reshape(x, [-1, 2, 3]), L.reshape(y, [-1, 2, 3]),
        L.reshape(y, [-1, 2, 3]))]
    seq = L.data("seq", shape=[5, 4], stop_gradient=False)
    seqlen = L.data("seqlen", shape=[], dtype="int64")
    labels = L.data("labels", shape=[2], dtype="int64")
    lablen = L.data("lablen", shape=[], dtype="int64")
    outs += [L.warpctc(seq, labels, seqlen, lablen, blank=3)]
    outs += list(L.ctc_greedy_decoder(seq, 3, seqlen))
    boxes, var = D.prior_box(img, img, [2.0], [4.0], [2.0], flip=True,
                             clip=True)
    dboxes, _ = D.density_prior_box(img, img, [2], [2.0])
    anchors, _ = D.anchor_generator(img, [4.0], [1.0], [2.0, 2.0])
    flat = L.reshape(boxes, [-1, 4])
    gt = L.data("gt", shape=[3, 4])
    iou = D.iou_similarity(gt, flat)
    match, _ = D.bipartite_match(iou)
    tgt, _ = D.target_assign(gt, match)
    outs += [boxes, var, dboxes, anchors, iou, match, tgt,
             D.box_coder(flat, L.reshape(var, [-1, 4]),
                         L.reshape(gt, [-1, 4]))]
    return outs


def test_new_layers_build_the_jax_programs_and_run():
    """The layers this slice added append the JAX package's ops with its
    attributes and shapes (equal program JSON), and the port's program
    runs on the CPU to the declared shapes and the JAX package's values
    from the same parameters, at 1e-5."""
    import numpy as np
    import paddle_tpu as pt
    import paddle_tpu_torch as ptt
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            outs = _every_new_layer(pkg)
        progs.append((main, start, outs))
    (jmain, jstart, _), (tmain, tstart, touts) = progs
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()
    r = np.random.RandomState(3)
    gt = np.sort(r.uniform(0, 1, (2, 3, 2, 2)), axis=2).reshape(2, 3, 4)
    feed = {"x": r.randn(2, 6).astype("float32"),
            "y": r.randn(2, 6).astype("float32"),
            "img": r.randn(2, 4, 6, 6).astype("float32"),
            "lab": r.randint(0, 6, (2, 1)).astype("int64"),
            "seq": r.randn(2, 5, 4).astype("float32"),
            "seqlen": np.int64([5, 3]), "labels": np.int64([[1, 2], [0, 0]]),
            "lablen": np.int64([2, 1]),
            "gt": gt[..., [0, 2, 1, 3]].astype("float32")}
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    scope = ptt.load_numpy_params(
        {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()},
        ptt.Scope(), ptt.CPUPlace())
    names = [v.name for v in touts]
    got = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                           fetch_list=names, scope=scope)
    want = pt.Executor().run(jmain, feed=feed, fetch_list=names,
                             scope=jscope)
    for v, a, b in zip(touts, got, want):
        # a declared -1 is a dim known only at run time
        assert len(np.shape(a)) == len(v.shape) and all(
            d in (-1, n) for d, n in zip(v.shape, np.shape(a))), \
            (v.name, np.shape(a), v.shape)
        np.testing.assert_allclose(np.asarray(a, "float64"),
                                   np.asarray(b, "float64"), rtol=1e-5,
                                   atol=1e-5, equal_nan=True,
                                   err_msg=v.name)
