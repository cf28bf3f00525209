"""The port's mesh, collectives, ring attention and sharded embedding
against the JAX package (paddle_tpu/parallel) and numpy.

One gloo world of 4 CPU processes per file (a module-scoped fixture over
`paddle_tpu_torch.distributed.launch` with a file store under tmp_path)
runs every scenario once; its worlds of 2 are meshes over ranks [0, 1] of
it. The world's collectives time out after 90 s, so a hung collective
fails these tests instead of the suite. The JAX references run here, in
the test process, on the virtual CPU devices.

Tolerances: collectives exact (sums of 2-4 float32 terms at 1e-6
relative); quantized payloads and scales byte-equal to the JAX
`quantize_blocks`; ring attention in float32 at 1e-5 relative (atol
1e-6) against the JAX ring with backend="xla".
"""

import functools
import json
import os
import traceback

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt

WORLD = 4
B, T, H, D = 2, 16, 2, 8
#: sums of 2-4 float32 terms, in another order than numpy's
SUM_TOL = dict(rtol=1e-6, atol=1e-6)
RING_CASES = [(2, True, False), (4, True, False), (2, True, True),
              (4, False, True)]


def _x(r, shape, seed=0):
    return np.random.RandomState(100 * seed + r).randn(*shape).astype(
        np.float32)


def _qkv(seed):
    rng = np.random.RandomState(seed)
    q, k, v, w = (rng.randn(B, T, H, D).astype(np.float32)
                  for _ in range(4))
    return q, k, v, w


def _segments(seed):
    """Packed rows: sorted ids, so a query block meets some K/V blocks
    with none of its segments (rows that see no key there)."""
    rng = np.random.RandomState(seed)
    seg = np.zeros((B, T), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, T), 2, replace=False))
        for c in cuts:
            seg[b, c:] += 1
    return seg


# ---------------------------------------------------------------------------
# the world: every scenario once, results to rank<r>.npz
# ---------------------------------------------------------------------------


def _collectives(rank, mesh, n, out):
    from paddle_tpu_torch.parallel import collective as C
    if not mesh.in_mesh:
        return
    p = f"c{n}_"
    with mesh:
        x = torch.from_numpy(_x(rank, (8, 3)))
        out[p + "axis"] = np.array([C.axis_index("dp"), C.axis_size("dp")])
        out[p + "all_reduce"] = C.all_reduce(x, "dp").numpy()
        out[p + "all_reduce_mean"] = C.all_reduce_mean(x, "dp").numpy()
        out[p + "reduce_scatter"] = C.reduce_scatter(x, "dp", 0).numpy()
        out[p + "all_gather"] = C.all_gather(x[:2], "dp", 1).numpy()
        out[p + "all_to_all"] = C.all_to_all(x, "dp", 0, 1).numpy()
        out[p + "shift_right"] = C.shift_right(x, "dp", n).numpy()
        out[p + "shift_left"] = C.shift_left(x, "dp", n).numpy()
        out[p + "ppermute"] = C.ppermute(x, "dp", [(0, 1)]).numpy()
        flat = torch.from_numpy(_x(rank, (n * 300,), seed=1))
        for wire in ("int8", "bf16"):
            out[p + f"qrs_{wire}"] = C.quantized_reduce_scatter_flat(
                flat, "dp", wire_dtype=wire, block=64).numpy()
            out[p + f"qar_{wire}"] = C.quantized_all_reduce_flat(
                flat, "dp", wire_dtype=wire, block=64, mean=True).numpy()
            out[p + f"qag_{wire}"] = C.quantized_all_gather_flat(
                flat[:300], "dp", wire_dtype=wire, block=64).numpy()
        # the transposes: d/dx of sum(w_r * f(x_r)) over every rank
        for name, f in (("all_reduce", lambda t: C.all_reduce(t, "dp")),
                        ("all_gather", lambda t: C.all_gather(t, "dp", 0)),
                        ("reduce_scatter",
                         lambda t: C.reduce_scatter(t, "dp", 0)),
                        ("all_to_all",
                         lambda t: C.all_to_all(t, "dp", 0, 1)),
                        ("shift_right",
                         lambda t: C.shift_right(t, "dp", n))):
            xg = x.clone().requires_grad_()
            y = f(xg)
            w = torch.from_numpy(_x(rank, tuple(y.shape), seed=2))
            (y * w).sum().backward()
            out[p + "grad_" + name] = xg.grad.numpy()


def _ring(rank, mesh, case, out):
    from paddle_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_attention_live_blocks, ring_attention_sharded)
    n, causal, packed = case
    if not mesh.in_mesh:
        return
    key = "ring_%d_%d_%d_" % case
    q, k, v, w = _qkv(n)
    seg = _segments(n) if packed else None
    i, t = mesh.axis_index("sp"), T // n
    blk = slice(i * t, (i + 1) * t)
    ql, kl, vl = (torch.from_numpy(a[:, blk].copy()).requires_grad_()
                  for a in (q, k, v))
    with mesh:
        o = ring_attention(ql, kl, vl, causal=causal,
                           segment_ids=None if seg is None else
                           torch.from_numpy(seg[:, blk].copy()))
    (o * torch.from_numpy(w[:, blk].copy())).sum().backward()
    out[key + "o"] = o.detach().numpy()
    out[key + "dq"], out[key + "dk"], out[key + "dv"] = (
        ql.grad.numpy(), kl.grad.numpy(), vl.grad.numpy())
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    segt = None if seg is None else torch.from_numpy(seg)
    out[key + "sharded"] = ring_attention_sharded(
        mesh, tq, tk, tv, causal=causal, segment_ids=segt).detach().numpy()
    _, live = ring_attention_live_blocks(mesh, tq, tk, tv, causal=causal,
                                         segment_ids=segt)
    out[key + "live"] = np.array(live)


def _embedding(rank, mesh, n, out):
    from paddle_tpu_torch.parallel.sharded_embedding import (
        embedding_table_sharding, sharded_embedding_lookup)
    if not mesh.in_mesh:
        return
    table = torch.from_numpy(_x(0, (8, 5), seed=3)).requires_grad_()
    ids = torch.from_numpy(np.random.RandomState(4).randint(0, 8, (3, 4)))
    got = sharded_embedding_lookup(mesh, table, ids)
    (got * torch.from_numpy(_x(0, (3, 4, 5), seed=5))).sum().backward()
    out[f"emb{n}_out"] = got.detach().numpy()
    out[f"emb{n}_grad"] = table.grad.numpy()
    out[f"emb{n}_place"] = np.array(
        embedding_table_sharding(mesh) == ("tp", None))


def _world(rank, world, outdir):
    from paddle_tpu_torch.parallel import DeviceMesh
    out, errors = {}, {}
    # every rank builds every mesh, in one order (new_group is collective)
    dp = {2: DeviceMesh(ranks=[0, 1], axes={"dp": 2}),
          4: DeviceMesh(axes={"dp": 4})}
    sp = {2: DeviceMesh(ranks=[0, 1], axes={"sp": 2}),
          4: DeviceMesh(axes={"sp": 4})}
    tp = {2: DeviceMesh(ranks=[0, 1], axes={"tp": 2}),
          4: DeviceMesh(axes={"tp": 4})}
    jobs = [(f"collectives{n}", _collectives, dp[n], n) for n in (2, 4)]
    jobs += [("ring_%d_%d_%d" % c, _ring, sp[c[0]], c) for c in RING_CASES]
    jobs += [(f"emb{n}", _embedding, tp[n], n) for n in (2, 4)]
    for name, fn, mesh, arg in jobs:
        try:
            fn(rank, mesh, arg, out)
        except Exception:
            errors[name] = traceback.format_exc()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"errors{rank}.json"), "w") as f:
        json.dump(errors, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel_world")
    ptt.distributed.launch(f"{os.path.abspath(__file__)}:_world", WORLD,
                           args=[str(d)], timeout_s=90, store_dir=str(d),
                           place="cpu")
    res, errs = [], []
    for r in range(WORLD):
        res.append(dict(np.load(os.path.join(d, f"rank{r}.npz"))))
        errs.append(json.load(open(os.path.join(d, f"errors{r}.json"))))
    return res, errs


def _get(world, rank, key, job):
    res, errs = world
    assert job not in errs[rank], errs[rank][job]
    return res[rank][key]


# ---------------------------------------------------------------------------
# the mesh (no world needed)
# ---------------------------------------------------------------------------


def test_mesh_coordinates_and_groups_match_jax():
    import jax

    from paddle_tpu.parallel.mesh import DeviceMesh as JMesh
    from paddle_tpu_torch.parallel import DeviceMesh
    for axes in ({"dp": 2, "tp": 2, "sp": 2}, {"dp": 4, "tp": 2},
                 {"dp": 8}):
        j = JMesh(jax.devices(), axes)
        t = DeviceMesh(ranks=range(8), axes=axes)
        devs = np.vectorize(lambda d: d.id)(j.jax_mesh.devices)
        for r in range(8):
            coord = tuple(int(c) for c in np.argwhere(devs == r)[0])
            assert tuple(t.coords(r).values()) == coord
        for a, name in enumerate(axes):
            # the rank lists along one axis: JAX's devices varying in it
            moved = np.moveaxis(devs, a, -1).reshape(-1, axes[name])
            assert sorted(map(list, moved)) == sorted(t._axis_slices(name))
        assert tuple(t.pspec("dp", ("tp", "pp"), "xx", None)) == tuple(
            j.pspec("dp", ("tp", "pp"), "xx", None))
        assert t.axis_size("pp") == j.axis_size("pp") == 1
        assert t.num_devices == j.num_devices
        assert tuple(t.batch_sharding(3)) == tuple(j.batch_sharding(3).spec)


def test_a_mesh_with_no_world_refuses_collectives_over_a_wider_axis():
    """Without a joined world, a collective over an axis of size 1 is the
    identity, and over a larger one raises: it has no peers."""
    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    from paddle_tpu_torch.parallel import DeviceMesh
    from paddle_tpu_torch.parallel import collective as C
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    x = torch.from_numpy(_x(0, (8, 3)))
    with DeviceMesh(ranks=[0], axes={"dp": 1}):
        np.testing.assert_array_equal(C.all_reduce(x, "dp").numpy(),
                                      x.numpy())
        np.testing.assert_array_equal(C.all_gather(x, "dp", 0).numpy(),
                                      x.numpy())
    wide = DeviceMesh(ranks=range(4), axes={"dp": 2, "sp": 2})
    assert not wide.joined and wide.axis_size("dp") == 2
    with wide:
        for f in (lambda: C.all_reduce(x, "dp"),
                  lambda: C.all_reduce_mean(x, "dp"),
                  lambda: C.all_gather(x, "dp", 0),
                  lambda: C.reduce_scatter(x, "dp", 0),
                  lambda: C.all_to_all(x, "dp", 0, 1),
                  lambda: C.ppermute(x, "dp", [(0, 1)]),
                  lambda: C.shift_right(x, "sp", 2),
                  lambda: ring_attention(*(torch.zeros(1, 4, 1, 8),) * 3)):
            with pytest.raises(InvalidArgumentError,
                               match="no world was joined"):
                f()
        # an axis the mesh does not have is of size 1
        np.testing.assert_array_equal(C.all_reduce(x, "tp").numpy(),
                                      x.numpy())


def test_launch_runs_on_the_cards_unless_asked_for_the_cpu():
    import inspect

    from paddle_tpu_torch.core.enforce import InvalidArgumentError
    launch = ptt.distributed.launch
    assert inspect.signature(launch).parameters["place"].default == "cuda"
    with pytest.raises(InvalidArgumentError, match="unknown place"):
        launch("os:getcwd", 1, place="gpu")


def test_quantize_blocks_bytes_equal_jax():
    import jax.numpy as jnp

    from paddle_tpu.parallel import collective as JC
    from paddle_tpu_torch.parallel import collective as TC
    rng = np.random.RandomState(0)
    flat = (rng.randn(6 * 64) * 3).astype(np.float32)
    flat[64:128] = 0.0                         # a zero block: scale 1
    flat[128:192] = np.round(flat[128:192] * 2) / 2   # ties at .5
    jq, js = JC.quantize_blocks(jnp.asarray(flat), block=64)
    tq, ts = TC.quantize_blocks(torch.from_numpy(flat), block=64)
    assert np.asarray(jq).tobytes() == tq.numpy().tobytes()
    assert np.asarray(js).tobytes() == ts.numpy().tobytes()
    assert np.asarray(JC.dequantize_blocks(jq, js)).tobytes() == \
        TC.dequantize_blocks(tq, ts).numpy().tobytes()
    for wire in ("int8", "bf16"):
        jr = JC.quantization_residual_flat(jnp.asarray(flat), 4,
                                           wire_dtype=wire, block=64)
        tr = TC.quantization_residual_flat(torch.from_numpy(flat), 4,
                                           wire_dtype=wire, block=64)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        assert TC.compressed_size_ratio(wire, 64) == \
            JC.compressed_size_ratio(wire, 64)
    assert TC.ring_perm(4) == JC.ring_perm(4)


# ---------------------------------------------------------------------------
# collectives at world 2 and 4
# ---------------------------------------------------------------------------


def _np_quant(flat, block):
    xb = flat.reshape(-1, block)
    amax = np.max(np.abs(xb), axis=1, keepdims=True)
    scale = np.where(amax > 0, amax / np.float32(127.0),
                     np.float32(1.0)).astype(np.float32)
    q = np.clip(np.round(xb / scale), -127, 127)
    return (q * scale).reshape(-1).astype(np.float32)


def _np_wire(flat, wire, block):
    if wire == "int8":
        return _np_quant(flat, block)
    return torch.from_numpy(flat).to(torch.bfloat16).float().numpy()


def _np_chunks(flat, n, wire, block):
    chunk = flat.shape[0] // n
    cpad = -(-chunk // block) * block
    xb = np.pad(flat.reshape(n, chunk), ((0, 0), (0, cpad - chunk)))
    return _np_wire(xb.reshape(-1), wire, block).reshape(n, cpad)[:, :chunk]


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_against_numpy(world, n):
    xs = [_x(r, (8, 3)) for r in range(n)]
    tot = np.sum(xs, axis=0)
    job, p = f"collectives{n}", f"c{n}_"
    for r in range(n):
        g = lambda k: _get(world, r, p + k, job)  # noqa: E731
        np.testing.assert_array_equal(g("axis"), [r, n])
        np.testing.assert_allclose(g("all_reduce"), tot, **SUM_TOL)
        np.testing.assert_allclose(g("all_reduce_mean"), tot / n, **SUM_TOL)
        c = 8 // n
        np.testing.assert_allclose(g("reduce_scatter"),
                                   tot[r * c:(r + 1) * c], **SUM_TOL)
        np.testing.assert_array_equal(
            g("all_gather"), np.concatenate([x[:2] for x in xs], axis=1))
        np.testing.assert_array_equal(
            g("all_to_all"),
            np.concatenate([x[r * c:(r + 1) * c] for x in xs], axis=1))
        np.testing.assert_array_equal(g("shift_right"), xs[(r - 1) % n])
        np.testing.assert_array_equal(g("shift_left"), xs[(r + 1) % n])
        np.testing.assert_array_equal(
            g("ppermute"), xs[0] if r == 1 else np.zeros_like(xs[0]))


@pytest.mark.parametrize("n", [2, 4])
def test_quantized_collectives_against_numpy(world, n):
    flats = [_x(r, (n * 300,), seed=1) for r in range(n)]
    job, p = f"collectives{n}", f"c{n}_"
    for wire in ("int8", "bf16"):
        parts = np.sum([_np_chunks(f, n, wire, 64) for f in flats], axis=0)
        owned = [parts[r] for r in range(n)]
        for r in range(n):
            np.testing.assert_allclose(
                _get(world, r, p + f"qrs_{wire}", job), owned[r],
                rtol=1e-6, atol=1e-6)
            full = np.concatenate([_np_chunks(o / n, 1, wire, 64)[0]
                                   for o in owned])
            np.testing.assert_allclose(
                _get(world, r, p + f"qar_{wire}", job), full, rtol=1e-6,
                atol=1e-6)
            ag = np.concatenate([_np_chunks(f[:300], 1, wire, 64)[0]
                                 for f in flats])
            np.testing.assert_allclose(
                _get(world, r, p + f"qag_{wire}", job), ag, rtol=1e-6,
                atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_collective_gradients_are_the_jax_transposes(world, n):
    job, p = f"collectives{n}", f"c{n}_"
    c = 8 // n
    ws = {name: [_x(r, shape, seed=2) for r in range(n)]
          for name, shape in (("all_reduce", (8, 3)),
                              ("all_gather", (8 * n, 3)),
                              ("reduce_scatter", (c, 3)),
                              ("all_to_all", (c, 3 * n)),
                              ("shift_right", (8, 3)))}
    for r in range(n):
        g = lambda k: _get(world, r, p + "grad_" + k, job)  # noqa: E731
        np.testing.assert_allclose(g("all_reduce"),
                                   np.sum(ws["all_reduce"], axis=0),
                                   **SUM_TOL)
        np.testing.assert_allclose(
            g("all_gather"),
            np.sum([w[r * 8:(r + 1) * 8] for w in ws["all_gather"]], 0),
            **SUM_TOL)
        np.testing.assert_allclose(
            g("reduce_scatter"), np.concatenate(ws["reduce_scatter"]),
            **SUM_TOL)
        np.testing.assert_allclose(
            g("all_to_all"),
            np.concatenate([w[:, r * 3:(r + 1) * 3]
                            for w in ws["all_to_all"]]), **SUM_TOL)
        np.testing.assert_array_equal(g("shift_right"),
                                      ws["shift_right"][(r + 1) % n])


# ---------------------------------------------------------------------------
# ring attention at sp 2 and 4 against the JAX ring (backend="xla")
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_ring(case):
    """The JAX ring (backend="xla") on case's inputs: (out, (dq, dk, dv))
    of sum(out * w), as numpy."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel.mesh import DeviceMesh as JMesh
    from paddle_tpu.parallel.ring_attention import ring_attention_sharded
    n, causal, packed = case
    q, k, v, w = _qkv(n)
    seg = _segments(n) if packed else None
    mesh = JMesh(jax.devices()[:n], {"sp": n})
    jseg = None if seg is None else jnp.asarray(seg)

    def f(q, k, v):
        return ring_attention_sharded(mesh, q, k, v, causal=causal,
                                      segment_ids=jseg, backend="xla")
    ref = np.asarray(jax.jit(f)(q, k, v))
    grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(f(a, b, c) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return ref, tuple(np.asarray(g) for g in grads)


@pytest.mark.parametrize("case", RING_CASES,
                         ids=["sp%d-causal%d-packed%d" % c
                              for c in RING_CASES])
def test_ring_attention_matches_jax(world, case):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel.mesh import DeviceMesh as JMesh
    from paddle_tpu.parallel.ring_attention import ring_attention_live_blocks
    n, causal, packed = case
    q, k, v, w = _qkv(n)
    seg = _segments(n) if packed else None
    mesh = JMesh(jax.devices()[:n], {"sp": n})
    jseg = None if seg is None else jnp.asarray(seg)
    ref, grads = _jax_ring(case)
    if packed:
        # the count depends on the segment ids: the JAX package's
        _, live = ring_attention_live_blocks(mesh, q, k, v, causal=causal,
                                             segment_ids=jseg,
                                             backend="xla")
    else:
        # the JAX package's count for a causal ring of n blocks, as its
        # own tests/test_ring_attention_v2.py:192 asserts (its eager
        # shard_map call takes ~8 s here)
        live = n * (n + 1) // 2
    job, key = "ring_%d_%d_%d" % case, "ring_%d_%d_%d_" % case
    t = T // n
    tol = dict(rtol=1e-5, atol=1e-6)
    for r in range(n):
        blk = slice(r * t, (r + 1) * t)
        got = lambda s: _get(world, r, key + s, job)  # noqa: E731
        np.testing.assert_allclose(got("o"), ref[:, blk], **tol)
        for name, gref in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got(name), np.asarray(gref)[:, blk],
                                       **tol)
        np.testing.assert_allclose(got("sharded"), ref, **tol)
        assert int(got("live")) == int(live)
        assert np.isfinite(got("o")).all()


@pytest.mark.parametrize("case", RING_CASES,
                         ids=["sp%d-causal%d-packed%d" % c
                              for c in RING_CASES])
def test_one_process_ring_matches_jax(case):
    """The ring's schedule and block functions with every block held in
    one process (`ring_forward_local` / `ring_backward_local`, what the
    chip check runs at full width) against the JAX ring: o, and dq, dk,
    dv given the ring's own o and lse, float32 at 1e-5."""
    from paddle_tpu_torch.parallel.ring_attention import (
        ring_backward_local, ring_forward_local)
    n, causal, packed = case
    q, k, v, w = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  for a in _qkv(n))
    seg = torch.from_numpy(_segments(n)) if packed else None
    o, lse, live = ring_forward_local(q, k, v, n, causal=causal,
                                      segment_ids=seg)
    dq, dk, dv = ring_backward_local(q, k, v, o, lse, w, n, causal=causal,
                                     segment_ids=seg)
    ref, grads = _jax_ring(case)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(o.transpose(1, 2).numpy(), ref, **tol)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), grads):
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                   err_msg=name, **tol)
    if not packed:
        assert live == (n * (n + 1) // 2 if causal else n * n)


# ---------------------------------------------------------------------------
# the sharded embedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_embedding_lookup_and_gradient(world, n):
    table = _x(0, (8, 5), seed=3)
    ids = np.random.RandomState(4).randint(0, 8, (3, 4))
    w = _x(0, (3, 4, 5), seed=5)
    dense = np.zeros_like(table)
    np.add.at(dense, ids.reshape(-1), w.reshape(-1, 5))
    rows = 8 // n
    total = np.zeros_like(table)
    for r in range(n):
        job = f"emb{n}"
        np.testing.assert_allclose(_get(world, r, f"emb{n}_out", job),
                                   table[ids], rtol=1e-6)
        g = _get(world, r, f"emb{n}_grad", job)
        mine = np.zeros_like(dense)
        mine[r * rows:(r + 1) * rows] = dense[r * rows:(r + 1) * rows]
        np.testing.assert_allclose(g, mine, rtol=1e-6, atol=1e-7)
        total += g
        assert bool(_get(world, r, f"emb{n}_place", job))
    np.testing.assert_allclose(total, dense, rtol=1e-6, atol=1e-7)
