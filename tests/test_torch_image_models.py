"""The image slice as a whole: the port's image models built, trained and
served against the JAX package's, uint8 feed staging, and the device
prefetcher.

Both packages build the same program (`Program.to_json` equal, for every
image model at its default size); the JAX package's startup program
initializes it and its persistable state, BN running statistics included,
carries across with `load_numpy_params`; feeds come from a numpy seed;
both executors take Momentum steps on the CPU in float32. Dropout, where a
model has it, is set to 0 in both programs (jax and torch draw different
masks).

Tolerances. ResNet-8 (cifar) and the MNIST conv net: losses at rtol
1e-5, every persistable (parameters, velocities, BN running statistics)
at 1e-5 of its largest magnitude, after 3 steps. ResNet-50 at 64x64 and
VGG-16 (cifar), batch 4: their gradients at initialization are chaotic
in float32. Forward differences of summation order grow through the BN
layers to ~1e-3 of an activation at ResNet-50's last block, and flip
relus near 0; the reference's own step-2 loss moves by 1.6e-3 when the
images are scaled by 1 + 2^-22. So these take one step, held as
`test_deep_image_model_step_matches_jax` says.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.data import feeder as jfeeder

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.data import feeder as tfeeder
from paddle_tpu_torch.framework.executor import as_numpy


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


def _no_dropout(program):
    for block in program.blocks:
        for op in block.ops:
            if op.type == "dropout":
                op.attrs["dropout_prob"] = 0.0


def _resnet50(pkg, L, M):
    img = L.data("img", shape=[64, 64, 3])
    return M.resnet.resnet_imagenet(img=img, depth=50, class_num=10,
                                    use_bf16=False)


def _resnet8(pkg, L, M):
    img = L.data("img", shape=[32, 32, 3], staging_dtype="uint8")
    return M.resnet.resnet_cifar10(img=img, depth=8)


def _conv_net(pkg, L, M):
    return M.mnist.conv_net()


def _vgg16(pkg, L, M):
    return M.vgg.vgg16_cifar()


# model -> (its build function, image shape of one example, classes)
SMALL = {"resnet8": (_resnet8, (32, 32, 3), 10),
         "resnet50_64px": (_resnet50, (64, 64, 3), 10),
         "mnist_conv_net": (_conv_net, (1, 28, 28), 10),
         "vgg16_cifar": (_vgg16, (3, 32, 32), 10)}


def _build(which, lr):
    out = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss, _, logits = SMALL[which][0](pkg, pkg.layers, pkg.models)
            pkg.optimizer.Momentum(learning_rate=lr,
                                   momentum=0.9).minimize(loss)
        _no_dropout(main)
        out.append((main, start, loss, logits))
    return out


def _feeds(which, n, batch, seed=0):
    _, shape, classes = SMALL[which]
    r = np.random.RandomState(seed)
    return [{"img": r.rand(batch, *shape).astype("float32"),
             "label": r.randint(0, classes, (batch, 1)).astype("int64")}
            for _ in range(n)]


def _jax_state(start):
    scope = pt.Scope()
    pt.Executor().run(start, scope=scope)
    return {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}


def _jax_scope(state):
    scope = pt.Scope()
    for n, v in state.items():
        scope.set_var(n, v.copy())
    return scope


def _assert_state_close(tstate, jstate, what):
    """Every persistable at 1e-5 of its largest magnitude."""
    assert set(tstate) == set(jstate)
    for n, jv in jstate.items():
        tol = 1e-5 * max(1.0, float(np.abs(jv).max()))
        diff = float(np.abs(tstate[n] - jv).max())
        assert diff <= tol, (what, n, diff, tol)


# -------------------------------------------------------------- programs
def _all_models(pkg):
    """Every image model at its default size, with a Momentum step."""
    L, M = pkg.layers, pkg.models
    builds = {
        "resnet_imagenet_50": lambda: M.resnet.resnet_imagenet(depth=50),
        "resnet_imagenet_18_nchw": lambda: M.resnet.resnet_imagenet(
            depth=18, data_format="NCHW", use_bf16=False),
        "resnet_cifar10": lambda: M.resnet.resnet_cifar10(),
        "se_resnext_imagenet": lambda: M.se_resnext.se_resnext_imagenet(),
        "vgg16": lambda: M.vgg.vgg(depth=16),
        "vgg16_cifar": lambda: M.vgg.vgg16_cifar(),
        "mnist_mlp": lambda: M.mnist.mlp(),
        "mnist_conv_net": lambda: M.mnist.conv_net(),
        "alexnet_imagenet": lambda: M.alexnet.alexnet_imagenet(
            use_bf16=True),
        "googlenet_imagenet": lambda: M.googlenet.googlenet_imagenet(),
        "resnet50_uint8": lambda: M.resnet.resnet_imagenet(
            img=L.data("img", shape=[224, 224, 3], staging_dtype="uint8"),
            depth=50, use_bf16=True),
    }
    return builds


@pytest.mark.parametrize("name", sorted(_all_models(pt)))
def test_image_model_program_matches_jax(name):
    """The same main and startup programs, op for op and name for name."""
    jsons = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss, _, _ = _all_models(pkg)[name]()
            pkg.optimizer.Momentum(learning_rate=0.1,
                                   momentum=0.9).minimize(loss)
        jsons.append((main.to_json(), start.to_json()))
    assert jsons[0][0] == jsons[1][0]
    assert jsons[0][1] == jsons[1][1]
    port = ptt.Program.from_json(jsons[0][0])
    assert port.to_json() == jsons[0][0]


# -------------------------------------------------------------- training
@pytest.mark.parametrize("which", ["resnet8", "mnist_conv_net"])
def test_small_image_model_trains_like_jax(which):
    """3 Momentum steps from the JAX package's initial state: the same
    losses, parameters, velocities and BN running statistics; then the
    trained program's is_test clone gives the same logits."""
    (jm, js, jl, jlog), (tm, _, tl, tlog) = _build(which, 0.05)
    state = _jax_state(js)
    jscope = _jax_scope(state)
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    feeds = _feeds(which, 4, 4)
    for i, feed in enumerate(feeds[:3]):
        jv = float(jexe.run(jm, feed=feed, fetch_list=[jl],
                            scope=jscope)[0])
        tv = float(texe.run(tm, feed=feed, fetch_list=[tl],
                            scope=tscope)[0])
        np.testing.assert_allclose(tv, jv, rtol=1e-5, err_msg=f"step {i}")
    _assert_state_close({n: as_numpy(tscope.get(n)) for n in state},
                        {n: np.asarray(jscope.get(n)) for n in state},
                        which)
    jtest, ttest = jm.clone(for_test=True), tm.clone(for_test=True)
    jv = np.asarray(jexe.run(jtest, feed=feeds[-1], fetch_list=[jlog],
                             scope=jscope)[0])
    tv = texe.run(ttest, feed=feeds[-1], fetch_list=[tlog], scope=tscope)[0]
    np.testing.assert_allclose(tv, jv, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jv).max()))


def _cosine(a, b):
    a, b = a.ravel().astype("float64"), b.ravel().astype("float64")
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


@pytest.mark.parametrize("which", ["resnet50_64px", "vgg16_cifar"])
def test_deep_image_model_step_matches_jax(which):
    """One Momentum step (lr 1e-3, batch 4) of ResNet-50 at 64x64 (the
    bottleneck blocks, the 7x7 stem, max pool 3/2/1, NHWC) and of VGG-16
    (cifar, NCHW, BN on the 2-D fc output), float32. The loss at rtol
    1e-4; the BN running statistics at 1e-3 of each one's largest
    magnitude; each parameter's update and velocity (the gradient) at a
    cosine of at least 0.99 with the reference's and a norm within 2%
    (measured: >= 0.9966 and 1.2% for ResNet-50). Module docstring: why
    one step, and not element-wise."""
    (jm, js, jl, jlog), (tm, _, tl, tlog) = _build(which, 1e-3)
    state = _jax_state(js)
    jscope = _jax_scope(state)
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    feed = _feeds(which, 1, 4)[0]
    jv = float(pt.Executor().run(jm, feed=feed, fetch_list=[jl],
                                 scope=jscope)[0])
    tv = float(ptt.Executor(ptt.CPUPlace()).run(
        tm, feed=feed, fetch_list=[tl], scope=tscope)[0])
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    running = {n for op in tm.global_block().ops if op.type == "batch_norm"
               for n in (op.inputs["Mean"][0], op.inputs["Variance"][0])}
    assert running
    steps = {}               # name -> (reference's step, port's step)
    for n, start in state.items():
        j, t = np.asarray(jscope.get(n)), as_numpy(tscope.get(n))
        if n in running:
            assert np.abs(t - j).max() <= 1e-3 * np.abs(j).max(), n
        elif "velocity" in n:              # the gradient
            steps[n] = (j, t)
        else:                              # a parameter: its update / lr
            steps[n] = ((j - start) / 1e-3, (t - start) / 1e-3)
    gmax = max(np.abs(j).max() for j, _ in steps.values())
    checked = 0
    for n, (j, t) in steps.items():
        if max(np.abs(j).max(), np.abs(t).max()) <= 1e-5 * gmax:
            # rounding noise: a conv bias under BN has an analytic
            # gradient of 0, and the learning rate does not move
            continue
        assert _cosine(t, j) >= 0.99, (n, _cosine(t, j))
        nj = np.linalg.norm(j)
        assert abs(np.linalg.norm(t) - nj) <= 0.02 * nj, n
        checked += 1
    assert checked >= len(steps) // 2


def test_batch_norm_running_stats_are_updated_in_place_by_a_step():
    """The scope's running-mean tensor is the one a training step updates
    (a bound PreparedStep keeps its tensors); an is_test run leaves it."""
    (_, js, _, _), (tm, _, tl, tlog) = _build("resnet8", 0.05)
    scope = ptt.load_numpy_params(_jax_state(js), ptt.Scope(),
                                  ptt.CPUPlace())
    name = next(op.inputs["Mean"][0] for op in tm.global_block().ops
                if op.type == "batch_norm")
    before = scope.get(name)
    snapshot = before.clone()
    exe = ptt.Executor(ptt.CPUPlace())
    feed = _feeds("resnet8", 1, 4)[0]
    step = exe.prepare(tm, feed=feed, fetch_list=[tl], scope=scope)
    step.bind(feed)
    step.run_bound()
    assert scope.get(name) is before
    assert not torch.equal(before, snapshot)
    moved = before.clone()
    exe.run(tm.clone(for_test=True), feed=feed, fetch_list=[tlog],
            scope=scope)
    assert torch.equal(scope.get(name), moved)


# -------------------------------------------------------------- staging
def _staged_resnet8():
    (jm, js, jl, _), (tm, _, tl, _) = _build("resnet8", 0.05)
    state = _jax_state(js)
    return jm, jl, tm, tl, state


def test_uint8_staging_matches_jax_and_the_float_feed():
    """A uint8 feed of the data var declared staging_dtype="uint8" is cast
    and scaled by 1/255 in the step: the same loss as the JAX package fed
    the same bytes, bit-equal to the port fed uint8 · float32(1/255) as
    float32, through Executor.run and a bound PreparedStep alike. The
    host half (stage_array: round and clip) matches the JAX package's."""
    jm, jl, tm, tl, state = _staged_resnet8()
    r = np.random.RandomState(3)
    raw = (r.rand(4, 32, 32, 3) * 1.1 - 0.05).astype("float32")
    label = r.randint(0, 10, (4, 1)).astype("int64")
    specs = tfeeder.staging_specs(tm)
    assert specs == {"img": (torch.uint8, 1.0 / 255.0)}
    wire = tfeeder.stage_batch({"img": raw, "label": label}, specs)
    jwire = jfeeder.stage_batch({"img": raw, "label": label},
                                jfeeder.staging_specs(jm))
    assert wire["img"].dtype == np.uint8 and wire["label"] is label
    np.testing.assert_array_equal(wire["img"], jwire["img"])
    assert wire["img"].min() == 0 and wire["img"].max() == 255   # clipped
    inside = (raw >= 0) & (raw <= 1)
    assert np.abs(wire["img"] / np.float32(255.0) - raw)[inside].max() \
        <= 1 / 510 + 1e-7
    dequant = wire["img"].astype("float32") * np.float32(1.0 / 255.0)
    losses = []
    for feed in (wire, {"img": dequant, "label": label}):
        scope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
        tmain = tm.clone(for_test=True)
        losses.append(ptt.Executor(ptt.CPUPlace()).run(
            tmain, feed=feed, fetch_list=[tl], scope=scope)[0])
    assert losses[0] == losses[1]
    jscope = _jax_scope(state)
    jv = np.asarray(pt.Executor().run(jm.clone(for_test=True), feed=wire,
                                      fetch_list=[jl], scope=jscope)[0])
    np.testing.assert_allclose(losses[0], jv, rtol=1e-5)
    scope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    step = ptt.Executor(ptt.CPUPlace()).prepare(
        tm.clone(for_test=True), feed=wire, fetch_list=[tl], scope=scope)
    step.bind(wire)
    assert as_numpy(step.run_bound()[0]) == losses[0]


def test_staging_refuses_another_dtype():
    """Only the declared dtype (float32) and the wire dtype (uint8) may be
    fed; int32 pixels would be scaled into garbage, so they raise, as in
    the JAX package."""
    _, _, tm, tl, state = _staged_resnet8()
    scope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    feed = {"img": np.ones((2, 32, 32, 3), "int32"),
            "label": np.zeros((2, 1), "int64")}
    with pytest.raises(TypeError, match="staging dtype uint8"):
        ptt.Executor(ptt.CPUPlace()).run(tm, feed=feed, fetch_list=[tl],
                                         scope=scope)


def test_data_layer_staging_defaults_to_one_255th():
    img = ptt.layers.data("img", shape=[8, 8, 3], staging_dtype=np.uint8)
    assert img.staging == (torch.uint8, 1.0 / 255.0)
    f = ptt.layers.data("f", shape=[4], staging_dtype="int8",
                        staging_scale=0.5)
    assert f.staging == (torch.int8, 0.5)
    assert ptt.layers.data("g", shape=[4]).staging is None


# -------------------------------------------------------------- prefetcher
def _batches(n, log=None):
    def gen():
        for i in range(n):
            if log is not None:
                log.append(i)
            yield {"img": np.full((2, 4, 4, 3), i / 255.0, "float32"),
                   "label": np.full((2, 1), i, "int64")}
    return gen


def test_prefetcher_keeps_order_and_stages_uint8():
    """Three workers stage batches concurrently; the batches come out in
    the reader's order, as tensors, the staged entry as uint8."""
    specs = {"img": (torch.uint8, 1.0 / 255.0)}
    got = list(ptt.data.DevicePrefetcher(
        _batches(12), capacity=2, place=ptt.CPUPlace(), staging=specs,
        stage_threads=3))
    assert [int(b["label"][0, 0]) for b in got] == list(range(12))
    assert all(b["img"].dtype == torch.uint8 for b in got)
    assert [int(b["img"][0, 0, 0, 0]) for b in got] == list(range(12))


def test_prefetcher_releases_its_threads_when_abandoned():
    """Breaking out of the loop stops the producer: it reads at most
    `capacity` batches ahead, then exits, and the worker threads end."""
    # the threads alive before the loop: only those the prefetcher starts
    # are watched, so a thread of an earlier test that ends meanwhile
    # does not change the count
    base = set(threading.enumerate())
    pulled = []
    pf = ptt.data.DevicePrefetcher(_batches(10_000, pulled), capacity=2,
                                   place=ptt.CPUPlace(), stage_threads=2)
    for i, _ in enumerate(pf):
        if i == 2:
            break

    def started():
        return [t for t in threading.enumerate() if t not in base]

    deadline = time.time() + 10
    while any(t.is_alive() for t in started()) and time.time() < deadline:
        time.sleep(0.05)
    assert not started()
    # 3 consumed, `capacity` queued, one put after the last get and one
    # read while the producer waited for room
    assert len(pulled) <= 3 + 2 + 2, len(pulled)


def test_prefetcher_reports_the_reader_error():
    def bad():
        yield {"x": np.zeros(2, "float32")}
        raise ValueError("reader broke")

    it = iter(ptt.data.DevicePrefetcher(bad, place=ptt.CPUPlace()))
    assert torch.equal(next(it)["x"], torch.zeros(2))
    with pytest.raises(ValueError, match="reader broke"):
        next(it)


def test_prefetcher_defaults_to_the_card():
    """Without a place the prefetcher targets CUDAPlace(0), which raises
    where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(UnavailableError):
        ptt.data.DevicePrefetcher(_batches(1))


@pytest.mark.parametrize("name,args", [
    ("glu", (None,)), ("scaled_dot_product_attention", (None, None, None))])
def test_nets_not_ported_raise_naming_the_roadmap_item(name, args):
    """These nets once raised naming their ROADMAP item, waiting on
    `split`; now each builds the JAX package's composite: the same
    program, and its output and gradients from the same parameters at
    1e-5."""
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[4, 8], stop_gradient=False)
            h = pkg.layers.fc(x, size=8, num_flatten_dims=2)
            if name == "glu":
                out = pkg.nets.glu(h, dim=-1)
            else:
                out = pkg.nets.scaled_dot_product_attention(h, x, x,
                                                            num_heads=2)
            loss = pkg.layers.mean(out)
        progs.append((main, start, out.name, loss.name))
    (jmain, jstart, out, loss), (tmain, _, _, _) = progs
    assert tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    feed = {"x": np.random.RandomState(6).randn(3, 4, 8).astype("float32")}
    fetch = [out, loss] + [p.name + "@GRAD" for p in tmain.all_parameters()]
    with pt.program_guard(jmain, jstart):
        pt.append_backward(jmain.global_block().var(loss))
    with ptt.program_guard(tmain):
        ptt.append_backward(tmain.global_block().var(loss))
    jout = pt.Executor().run(jmain, feed=feed, fetch_list=fetch,
                             scope=jscope)
    tout = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                            fetch_list=fetch, scope=tscope)
    for n, a, b in zip(fetch, tout, jout):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("pool_type", ["max", "average"])
def test_sequence_conv_pool_matches_jax(pool_type):
    """nets.sequence_conv_pool (sequence_conv + sequence_pool) over ragged
    sequences: the same program, its output and its gradients as the JAX
    package's, from the same parameters, at 1e-5."""
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            x = pkg.layers.data("x", shape=[6, 5], lod_level=1)
            pooled = pkg.nets.sequence_conv_pool(x, num_filters=4,
                                                 filter_size=3,
                                                 pool_type=pool_type)
            loss = pkg.layers.mean(pooled)
            pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
        progs.append((main, start, pooled.name, loss.name))
    (jmain, jstart, out, loss), (tmain, _, _, _) = progs
    assert tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    r = np.random.RandomState(4)
    feed = {"x": r.randn(3, 6, 5).astype("float32"),
            "x@SEQLEN": np.array([6, 2, 4], "int32")}
    fetch = [out, loss] + [p.name + "@GRAD" for p in tmain.all_parameters()]
    jout = pt.Executor().run(jmain, feed=feed, fetch_list=fetch,
                             scope=jscope)
    tout = ptt.Executor(ptt.CPUPlace()).run(tmain, feed=feed,
                                            fetch_list=fetch, scope=tscope)
    for n, a, b in zip(fetch, tout, jout):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
