"""Sparse embedding gradients in the port, against the JAX package.

tests/test_sparse_optimizer.py's cases, run through both packages: an
`is_sparse` table's gradient ships as rows and values (the perturbation
trick in `run_vjp_region`), and the sparse branches of sgd, momentum and
adam update only the looked-up rows (momentum decays velocity table-wide,
adam is lazy). Each program is the JAX package's (`to_json` equal); both
start from the JAX startup program's state (carried with
`load_numpy_params`) and take the same steps on the same ids. Tolerances:
losses at 1e-6 relative, every persistable at 1e-6 + 1e-6|x| (float32,
the same arithmetic; sums of duplicate rows in another order); untouched
rows bit-equal. Then the sparse-table ops through both registries, the
no-[vocab, dim]-tensor property of the merged-rows path, and DeepFM and
Wide&Deep at tests/test_models.py:112-130's sizes, sparse and dense.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework import registry as jreg

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.executor import as_numpy
from paddle_tpu_torch.framework.selected_rows import TracedSelectedRows

from tests.port_env import port_jax_compile_cache  # noqa: F401

VOCAB, DIM = 32, 4


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = (jflags.get_flag("sparse_dense_apply_max_bytes"),
             tflags.get_flag("sparse_dense_apply_max_bytes"))
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    jflags.set_flag("sparse_dense_apply_max_bytes", saved[0])
    tflags.set_flag("sparse_dense_apply_max_bytes", saved[1])


def _max_bytes(n):
    jflags.set_flag("sparse_dense_apply_max_bytes", n)
    tflags.set_flag("sparse_dense_apply_max_bytes", n)


def _table_model(make_opt, is_sparse=True, padding_idx=None):
    def build(pkg):
        ids = pkg.layers.data("ids", shape=[3], dtype="int64")
        emb = pkg.layers.embedding(ids, size=[VOCAB, DIM],
                                   is_sparse=is_sparse,
                                   padding_idx=padding_idx,
                                   param_attr=pkg.ParamAttr(name="emb_w"))
        loss = pkg.layers.reduce_mean(pkg.layers.elementwise_mul(emb, emb))
        make_opt(pkg).minimize(loss)
        return loss
    return build


def _run_both(build, feeds, state=None, fetch_extra=()):
    """One program through both packages from the JAX startup state (or
    `state`). Returns the port's scope, the initial state, the port's last
    fetches and its losses."""
    progs = []
    for pkg in (pt, ptt):
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss = build(pkg)
        progs.append((main, start, loss))
    (jmain, jstart, jloss), (tmain, _, tloss) = progs
    assert tmain.to_json() == jmain.to_json()
    jscope = pt.Scope()
    jexe = pt.Executor()
    jexe.run(jstart, scope=jscope)
    if state is not None:
        for n, v in state.items():
            jscope.set_var(n, jnp.asarray(v))
    init = {n: np.asarray(jscope.get(n)).copy()
            for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(init, ptt.Scope(), ptt.CPUPlace())
    texe = ptt.Executor(ptt.CPUPlace())
    out, losses = None, []
    for feed in feeds:
        jl = jexe.run(jmain, feed=feed, fetch_list=[jloss, *fetch_extra],
                      scope=jscope)
        out = texe.run(tmain, feed=feed, fetch_list=[tloss, *fetch_extra],
                       scope=tscope)
        np.testing.assert_allclose(out[0], jl[0], rtol=1e-6)
        losses.append(float(out[0]))
    for n in init:
        np.testing.assert_allclose(as_numpy(tscope.get(n)),
                                   np.asarray(jscope.get(n)), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    return SimpleNamespace(scope=tscope, init=init, out=out, losses=losses)


def _ids(*rows):
    return [{"ids": np.array(r, "int64")} for r in rows]


def test_sgd_sparse_matches_dense_and_jax(rng):
    """SGD is linear in the gradient: the sparse scatter-add equals the
    dense update, and both equal the JAX package's."""
    feeds = [{"ids": rng.randint(0, VOCAB, (4, 3)).astype("int64")}]
    sgd = lambda pkg: pkg.optimizer.SGD(learning_rate=0.1)  # noqa: E731
    r = _run_both(_table_model(sgd, True), feeds)
    sparse, init = r.scope, r.init
    dense = _run_both(_table_model(sgd, False), feeds, state=init).scope
    np.testing.assert_allclose(as_numpy(sparse.get("emb_w")),
                               as_numpy(dense.get("emb_w")), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_untouched_rows_unchanged(opt):
    make = {"sgd": lambda pkg: pkg.optimizer.SGD(learning_rate=0.5),
            "adam": lambda pkg: pkg.optimizer.Adam(learning_rate=0.1)}[opt]
    r = _run_both(_table_model(make), _ids([[1, 5, 9]], [[5, 2, 2]]))
    tscope, init = r.scope, r.init
    w0, w1 = init["emb_w"], as_numpy(tscope.get("emb_w"))
    for r in range(VOCAB):
        if r in (1, 2, 5, 9):
            assert not np.allclose(w0[r], w1[r]), r
        else:
            np.testing.assert_array_equal(w0[r], w1[r])


@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_sparse_is_not_lazy(nesterov):
    """Velocity decays on every row each step: sparse equals dense on
    disjoint id sets, including rows absent from the second step."""
    make = lambda pkg: pkg.optimizer.Momentum(  # noqa: E731
        learning_rate=0.2, momentum=0.9, use_nesterov=nesterov)
    feeds = _ids([[1, 3, 5]], [[2, 4, 6]])
    r = _run_both(_table_model(make, True), feeds)
    sparse, init = r.scope, r.init
    dense = _run_both(_table_model(make, False), feeds, state=init).scope
    np.testing.assert_allclose(as_numpy(sparse.get("emb_w")),
                               as_numpy(dense.get("emb_w")), rtol=1e-6,
                               atol=1e-7)
    assert not np.allclose(as_numpy(sparse.get("emb_w"))[1],
                           init["emb_w"][1])


@pytest.mark.parametrize("max_bytes", [1 << 30, 0],
                         ids=["dense_masked", "merged_rows"])
def test_lazy_adam_against_numpy_and_jax(max_bytes):
    """Two steps with duplicate ids against a hand-computed lazy Adam
    (tests/test_sparse_optimizer.py's reference), on both apply paths."""
    _max_bytes(max_bytes)
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.1
    make = lambda pkg: pkg.optimizer.Adam(  # noqa: E731
        learning_rate=lr, beta1=b1, beta2=b2, epsilon=eps)
    step_ids = _ids([[1, 1, 7]], [[7, 2, 2]])
    r = _run_both(_table_model(make), step_ids)
    tscope, init = r.scope, r.init
    w = init["emb_w"].astype(np.float64)
    m, v = np.zeros_like(w), np.zeros_like(w)
    b1p, b2p = b1, b2
    for feed in step_ids:
        flat = feed["ids"].reshape(-1)
        g = np.zeros_like(w)
        np.add.at(g, flat, 2.0 * w[flat] / (flat.size * DIM))
        rows = np.unique(flat)
        m[rows] = b1 * m[rows] + (1 - b1) * g[rows]
        v[rows] = b2 * v[rows] + (1 - b2) * g[rows] ** 2
        lr_t = lr * np.sqrt(1 - b2p) / (1 - b1p)
        w[rows] -= lr_t * m[rows] / (np.sqrt(v[rows]) + eps)
        b1p, b2p = b1p * b1, b2p * b2
    np.testing.assert_allclose(as_numpy(tscope.get("emb_w")), w, rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("max_bytes", [1 << 30, 0],
                         ids=["dense_masked", "merged_rows"])
def test_duplicate_ids_aggregate_before_update(max_bytes):
    """[3, 3, 3] moves row 3 by one Adam step on the summed gradient."""
    _max_bytes(max_bytes)
    make = lambda pkg: pkg.optimizer.Adam(learning_rate=0.1)  # noqa: E731
    r = _run_both(_table_model(make), _ids([[3, 3, 3]]))
    tscope, init = r.scope, r.init
    w0, w1 = init["emb_w"], as_numpy(tscope.get("emb_w"))
    assert not np.allclose(w0[3], w1[3])
    mask = np.arange(VOCAB) != 3
    np.testing.assert_array_equal(w0[mask], w1[mask])


def test_dense_masked_equals_merged_rows(rng):
    """The two apply paths of lazy Adam agree, untouched rows bit-equal."""
    batches = [rng.randint(0, VOCAB, (4, 3)).astype("int64")
               for _ in range(3)]
    batches[1][0, :2] = batches[1][0, 2]
    feeds = [{"ids": b} for b in batches]
    make = lambda pkg: pkg.optimizer.Adam(learning_rate=0.1)  # noqa: E731
    _max_bytes(0)
    r = _run_both(_table_model(make), feeds)
    rows_scope, init = r.scope, r.init
    _max_bytes(1 << 30)
    masked_scope = _run_both(_table_model(make), feeds, state=init).scope
    for n in init:
        np.testing.assert_allclose(as_numpy(masked_scope.get(n)),
                                   as_numpy(rows_scope.get(n)), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    seen = set(np.concatenate(batches).ravel())
    untouched = sorted(set(range(VOCAB)) - seen)
    np.testing.assert_array_equal(
        as_numpy(masked_scope.get("emb_w"))[untouched],
        init["emb_w"][untouched])


def test_grad_fetch_forces_dense():
    sgd = lambda pkg: pkg.optimizer.SGD(learning_rate=0.1)  # noqa: E731
    g = _run_both(_table_model(sgd), _ids([[1, 5, 9]]),
                  fetch_extra=["emb_w@GRAD"]).out[1]
    assert g.shape == (VOCAB, DIM)
    assert {r for r in range(VOCAB) if np.any(g[r] != 0)} == {1, 5, 9}


@pytest.mark.parametrize("padding_idx", [0, -1])
@pytest.mark.parametrize("opt", ["adam", "momentum"])
def test_padding_idx(padding_idx, opt):
    """The padding row's values are zeroed: its lookup gives zeros, its
    gradient is zero (lazy Adam still counts it touched, as the JAX
    package does)."""
    make = {"adam": lambda pkg: pkg.optimizer.Adam(learning_rate=0.1),
            "momentum": lambda pkg: pkg.optimizer.Momentum(
                learning_rate=0.1, momentum=0.9)}[opt]
    pad = padding_idx % VOCAB
    _run_both(_table_model(make, padding_idx=padding_idx),
              _ids([[pad, 4, pad]], [[4, 9, pad]], [[2, pad, 2]]))


def test_out_of_range_rows_are_dropped():
    """A row outside [0, height) (after [-height, 0) wraps) adds nothing
    and counts as untouched, on both merge forms."""
    rows = torch.tensor([5, 40, 1, 5, -2, -40, 1, 7])
    value = torch.arange(16, dtype=torch.float32).reshape(8, 2) + 1
    g = TracedSelectedRows(rows, value, 10)
    want = np.zeros((10, 2), "float32")
    for r, val in zip(rows.tolist(), value.numpy()):
        r = r + 10 if -10 <= r < 0 else r
        if 0 <= r < 10:
            want[r] += val
    np.testing.assert_array_equal(g.to_dense().numpy(), want)
    mrows, mval, n_valid = g.merged()
    assert int(n_valid) == 4
    assert mrows.tolist() == [1, 5, 7, 8, 8, 8, 8, 8]
    np.testing.assert_array_equal(mval[:4].numpy(), want[[1, 5, 7, 8]])
    assert not mval[4:].any()
    none = TracedSelectedRows(torch.tensor([10, -11]), torch.ones(2, 2), 10)
    mrows, mval, n_valid = none.merged()
    assert int(n_valid) == 0 and not mval.any()
    assert ((mrows >= 0) & (mrows < 10)).all()


class _NewTensors(TorchDispatchMode):
    """Shapes of the tensors ops create (in-place results excluded)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {id(a) for a in args if isinstance(a, torch.Tensor)}
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor) and id(o) not in ins:
                self.shapes.append((str(func), tuple(o.shape)))
        return out


def test_merged_rows_step_forms_no_table_sized_tensor():
    """With the merged-rows path, a whole training step (the region's
    forward and backward, and Adam) creates no [vocab, dim] tensor: the
    table takes no dense gradient and its update is in place. The
    dense-masked path's only table-sized tensors come from the apply."""
    big = 4096
    main, start = ptt.Program(), ptt.Program()
    with ptt.program_guard(main, start):
        ids = ptt.layers.data("ids", shape=[3], dtype="int64")
        emb = ptt.layers.embedding(ids, size=[big, DIM], is_sparse=True)
        loss = ptt.layers.reduce_mean(ptt.layers.elementwise_mul(emb, emb))
        ptt.optimizer.Adam(learning_rate=0.1).minimize(loss)
    scope = ptt.Scope()
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(start, scope=scope)
    feed = {"ids": np.random.RandomState(0).randint(0, big, (4, 3))}
    for max_bytes, allowed in ((0, set()), (1 << 30, {"adam"})):
        tflags.set_flag("sparse_dense_apply_max_bytes", max_bytes)
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)  # planned
        seen = _NewTensors()
        region_ops = []
        real = treg.lookup_op("adam").lower

        @contextlib.contextmanager
        def tag_adam():
            op = treg.lookup_op("adam")

            def lower(ctx, ins, attrs):
                region_ops.append(len(seen.shapes))
                out = real(ctx, ins, attrs)
                region_ops.append(len(seen.shapes))
                return out
            op.lower = lower
            try:
                yield
            finally:
                op.lower = real
        with tag_adam(), seen:
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        lo, hi = region_ops
        table = [i for i, (_, s) in enumerate(seen.shapes)
                 if s in ((big, DIM), (big,), (big, 1))]
        if not allowed:
            assert not table, [seen.shapes[i] for i in table]
        else:
            assert table and all(lo <= i < hi for i in table)


# -- the sparse-table ops ---------------------------------------------------

@pytest.mark.parametrize("case", ["split_ids", "merge_ids",
                                  "lookup_sparse_table"])
def test_sparse_table_op_matches_jax(case):
    ids = np.array([5, 0, 9, 3, 4, 11, 8, 2, -1, 7], "int64")
    rng = np.random.RandomState(3)
    if case == "split_ids":
        ins, attrs = {"Ids": [ids[:8].reshape(8, 1)]}, {"num_shards": 3}
    elif case == "merge_ids":
        n = 3
        pos = [np.cumsum(ids[:8] % n == s) - 1 for s in range(n)]
        ins = {"Ids": [ids[:8]],
               "X": [np.where(ids[:8] % n == s, ids[:8], -1)
                     for s in range(n)],
               "Rows": [rng.randn(8, 4).astype("float32") for _ in pos]}
        attrs = {}
    else:
        ins = {"W": [rng.randn(12, 4).astype("float32")],
               "Ids": [ids.reshape(10, 1)]}
        attrs = {}
    jout = jreg.lookup_op(case).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()}, attrs)
    tout = treg.lookup_op(case).lower(
        treg.LowerCtx(), {s: [torch.from_numpy(a) for a in v]
                          for s, v in ins.items()}, attrs)
    assert set(tout) == set(jout)
    for slot in jout:
        assert len(tout[slot]) == len(jout[slot])
        for j, t in zip(jout[slot], tout[slot]):
            j, t = np.asarray(j), as_numpy(t)
            assert t.dtype == j.dtype and t.shape == j.shape, slot
            np.testing.assert_array_equal(t, j, err_msg=slot)


# -- the CTR models ---------------------------------------------------------

def _deepfm(is_sparse):
    def build(pkg):
        loss, _ = pkg.models.deepfm.deepfm(
            num_fields=5, vocab_size=500, embed_dim=8, fc_sizes=(32,),
            is_sparse=is_sparse)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return loss
    return build


def _wide_and_deep(is_sparse):
    def build(pkg):
        loss, _ = pkg.models.deepfm.wide_and_deep(
            wide_fields=4, deep_fields=6, wide_vocab=300, deep_vocab=300,
            embed_dim=4, fc_sizes=(16,))
        block = pkg.default_main_program().global_block()
        for op in block.ops:       # wide_and_deep takes no is_sparse
            if op.type == "lookup_table":
                op.attrs["is_sparse"] = is_sparse
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return loss
    return build


@pytest.mark.parametrize("is_sparse", [True, False],
                         ids=["sparse", "dense"])
@pytest.mark.parametrize("model", ["deepfm", "wide_and_deep"])
def test_ctr_model_matches_jax(model, is_sparse):
    """tests/test_models.py's sizes, 4 Adam steps: losses and every
    persistable equal to the JAX package's, and the loss falls."""
    rng = np.random.RandomState(5)
    if model == "deepfm":
        build = _deepfm(is_sparse)
        feeds = [{"feat_ids": rng.randint(0, 500, (16, 5)).astype("int64"),
                  "feat_vals": rng.rand(16, 5).astype("float32"),
                  "label": rng.randint(0, 2, (16, 1)).astype("float32")}]
    else:
        build = _wide_and_deep(is_sparse)
        feeds = [{"wide_ids": rng.randint(0, 300, (8, 4)).astype("int64"),
                  "deep_ids": rng.randint(0, 300, (8, 6)).astype("int64"),
                  "label": rng.randint(0, 2, (8, 1)).astype("float32")}]
    losses = _run_both(build, feeds * 4).losses
    assert losses[-1] < losses[0], losses


def test_deepfm_row_pad_moments_stay_zero():
    """row_pad: the pad columns take a zero gradient, so lazy Adam leaves
    their moments at exactly 0 (as the JAX package)."""
    def build(pkg):
        loss, _ = pkg.models.deepfm.deepfm(
            num_fields=5, vocab_size=500, embed_dim=8, fc_sizes=(32,),
            is_sparse=True, row_pad=16)
        pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
        return loss
    rng = np.random.RandomState(6)
    feeds = [{"feat_ids": rng.randint(0, 500, (16, 5)).astype("int64"),
              "feat_vals": rng.rand(16, 5).astype("float32"),
              "label": rng.randint(0, 2, (16, 1)).astype("float32")}] * 2
    r = _run_both(build, feeds)
    tscope, init = r.scope, r.init
    for n in init:
        if "moment" in n and init[n].shape == (500, 16):
            assert not as_numpy(tscope.get(n))[:, 9:].any(), n
