"""The port's elastic training (parallel/elastic.py, reshard.py,
process_world.py, trainer.Supervisor, distributed.elastic / master)
against the JAX package, with no torch.distributed world.

The JAX suite's cases (tests/test_elastic.py, test_process_world.py),
ported: the commit marker written last; uncommitted, truncated,
bit-flipped and meta-corrupted snapshots rejected naming their file;
retention and the ranking's ties; the fault-injection parse equal to the
JAX package's; the async path (the copy ordered before the next in-place
update); a same-world resume bitwise; the strict and seed refusals;
`_resize_replica_rows` and the error-feedback re-map equal to the JAX
package's on the same inputs; the reshard algebra against
`costs.reshard_wire_bytes`; the simulated world's barrier under
drop_rank / straggle_rank; the Supervisor's backoff, jitter, exhaustion
and healthy reset; PreemptionGuard, ElasticTrainer, Master /
MasterClient. Across packages: a JAX dp2 x tp2 snapshot restores into
the port's one-process Executor with the JAX values, and a port snapshot
restores in the JAX package. Two SIGKILL subprocesses (this file run as
a script): a supervised crash_at_step resume, bitwise equal to the
uninterrupted child, and a crash_mid_save at a random staged offset.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.parallel import elastic, process_world, reshard
from paddle_tpu_torch.parallel.process_world import ProcessWorld

from tests.port_env import port_jax_compile_cache  # noqa: F401

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))


@pytest.fixture(autouse=True)
def _fresh_port():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    yield


def _host_arrays(seed=7):
    rng = np.random.RandomState(seed)
    return {f"w_{k}": rng.randn(16, 4).astype("f4") for k in range(3)}


def _program(arrays, seed=0):
    prog, startup = ptt.Program(), ptt.Program()
    prog.random_seed = seed
    with ptt.program_guard(prog, startup):
        for name, val in arrays.items():
            prog.global_block().create_var(name=name, shape=list(val.shape),
                                           dtype="float32", persistable=True)
    return prog


def _save(root, arrays, step=0, **kw):
    """Mesh-free save: a program declaring the vars and a scope holding
    them is all save_train_state needs."""
    prog, scope = _program(arrays), ptt.Scope()
    for name, val in arrays.items():
        scope.set_var(name, torch.from_numpy(val.copy()))
    out = elastic.save_train_state(str(root), program=prog, scope=scope,
                                   step=step, **kw)
    return out, prog, scope


def _restore(path, template, **kw):
    prog, scope = _program(template), ptt.Scope()
    meta = elastic.restore_train_state(str(path), program=prog, scope=scope,
                                       **kw)
    return meta, {n: scope.get(n).numpy() for n in template
                  if scope.has_var(n)}


def _metric(name):
    return elastic.metrics_registry().get(name).value


# ---------------------------------------------------------------------------
# the commit protocol
# ---------------------------------------------------------------------------


def test_commit_marker_written_last_and_validates(tmp_path):
    path, _, _ = _save(tmp_path, _host_arrays(), step=5)
    assert os.path.basename(path).startswith(elastic.SNAPSHOT_PREFIX)
    assert elastic.is_committed(path)
    elastic.validate_snapshot(path)
    marker = json.load(open(os.path.join(path, elastic.COMMIT_MARKER)))
    assert marker["format"] == elastic.COMMIT_FORMAT == 2
    assert marker["commit_ts"] > 0 and marker["world"]["world_size"] == 1
    mtime = os.path.getmtime(os.path.join(path, elastic.COMMIT_MARKER))
    for name, entry in marker["files"].items():
        fpath = os.path.join(path, name)
        assert os.path.getsize(fpath) == entry["size"]
        assert elastic.file_digest(fpath) == entry["crc32"]
        assert os.path.getmtime(fpath) <= mtime      # the marker is last
    assert set(marker["files"]) == {"shard-0.pts", "manifest-0.json",
                                    elastic.META_FILE}
    meta = elastic.read_meta(path)
    assert meta["step"] == 5 and meta["format"] == elastic.META_FORMAT == 2


@pytest.mark.parametrize("damage", ["uncommitted", "truncated", "bitflip",
                                    "meta", "manifest"])
def test_damaged_snapshot_rejected_naming_its_file(tmp_path, damage):
    arrays = _host_arrays()
    p0, _, _ = _save(tmp_path, arrays, step=1)
    p1, _, _ = _save(tmp_path, arrays, step=2)
    shard = os.path.join(p1, "shard-0.pts")
    named = {"uncommitted": elastic.COMMIT_MARKER, "truncated": "shard-0.pts",
             "bitflip": "shard-0.pts", "meta": elastic.META_FILE,
             "manifest": "manifest-0.json"}[damage]
    if damage == "uncommitted":
        os.unlink(os.path.join(p1, elastic.COMMIT_MARKER))
        # uncommitted dirs are skipped: the older snapshot is the latest
        assert elastic.latest_snapshot(str(tmp_path)) == p0
        meta, _ = _restore(tmp_path, arrays)
        assert meta["step"] == 1
    elif damage == "truncated":
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
    elif damage == "bitflip":
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        elastic.validate_snapshot(p1, digests=False)   # size-blind
        fails0 = _metric("ptpu_ckpt_digest_failures_total")
    elif damage == "meta":
        with open(os.path.join(p1, elastic.META_FILE), "r+b") as f:
            f.write(b"XXXX")
    else:
        os.unlink(os.path.join(p1, "manifest-0.json"))
    with pytest.raises(EnforceError) as ei:
        elastic.validate_snapshot(p1)
    assert named in str(ei.value) and p1 in str(ei.value)
    if damage == "bitflip":
        assert isinstance(ei.value, elastic.SnapshotDigestError)
        assert _metric("ptpu_ckpt_digest_failures_total") == fails0 + 1
        with pytest.raises(EnforceError, match="digest"):
            _restore(p1, arrays)
    if damage == "truncated":
        assert "truncated" in str(ei.value)


def test_no_committed_snapshot_message(tmp_path):
    path, _, _ = _save(tmp_path, _host_arrays())
    os.unlink(os.path.join(path, elastic.COMMIT_MARKER))
    with pytest.raises(EnforceError, match="committed"):
        _restore(tmp_path, _host_arrays())


def test_retention_and_ranking_ties(tmp_path):
    arrays = _host_arrays()
    for step in range(5):
        _save(tmp_path / "a", arrays, step=step, max_snapshots=2)
    snaps = elastic.list_snapshots(str(tmp_path / "a"))
    assert len(snaps) == 2 and elastic.read_meta(snaps[-1][1])["step"] == 4
    # equal steps tie-break by commit_ts, not serial
    p0, _, _ = _save(tmp_path / "b", arrays, step=7)
    p1, _, _ = _save(tmp_path / "b", arrays, step=7)
    assert elastic.latest_snapshot(str(tmp_path / "b")) == p1
    marker = os.path.join(p0, elastic.COMMIT_MARKER)
    record = json.load(open(marker))
    record["commit_ts"] += 1e6
    json.dump(record, open(marker, "w"))
    assert elastic.latest_snapshot(str(tmp_path / "b")) == p0
    # a higher step beats a later serial, and retention ranks alike
    root = tmp_path / "c"
    p_new, _, _ = _save(root, arrays, step=100)
    for step in (50, 51, 52):
        _save(root, arrays, step=step, max_snapshots=2)
    assert elastic.latest_snapshot(str(root)) == p_new
    assert {elastic.read_meta(p)["step"]
            for _, p in elastic.list_snapshots(str(root))} == {52, 100}
    # a COMMIT of a newer format is skipped (counted once) and rejected
    pf, _, _ = _save(root, arrays, step=200)
    record = json.load(open(os.path.join(pf, elastic.COMMIT_MARKER)))
    record["format"] = elastic.COMMIT_FORMAT + 1
    json.dump(record, open(os.path.join(pf, elastic.COMMIT_MARKER), "w"))
    skipped0 = _metric("ptpu_ckpt_skipped_foreign_total")
    assert elastic.latest_snapshot(str(root)) == p_new
    assert elastic.latest_snapshot(str(root)) == p_new
    assert _metric("ptpu_ckpt_skipped_foreign_total") == skipped0 + 1
    with pytest.raises(EnforceError, match="newer"):
        elastic.validate_snapshot(pf)


def test_strict_and_seed_refusals(tmp_path):
    arrays = _host_arrays()
    _save(tmp_path, arrays)
    grown = dict(arrays, w_new=np.zeros((4, 4), np.float32))
    with pytest.raises(EnforceError, match="w_new"):
        _restore(tmp_path, grown)
    _, back = _restore(tmp_path, grown, strict=False)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    prog = _program(arrays, seed=1234)
    with pytest.raises(EnforceError, match="random_seed"):
        elastic.restore_train_state(str(tmp_path), program=prog,
                                    scope=ptt.Scope())


@pytest.mark.parametrize("raw", [
    "", "crash_at_step:3, slow_writer:0.5", "crash_mid_save:120",
    "crash_at_step:2,drop_rank:1@ack,straggle_rank:0@stage@0.5",
    "crash_rank:2@stage@17", "bogus:1", "crash_at_step", "drop_rank:1@nope"])
def test_fault_injection_parse_equals_jax(monkeypatch, raw):
    from paddle_tpu.parallel import elastic as jelastic
    from paddle_tpu.parallel import process_world as jpw
    monkeypatch.setenv("PTPU_FAULT_INJECT", raw)
    results = []
    for el, pw in ((elastic, process_world), (jelastic, jpw)):
        try:
            results.append((el.fault_injection_config(),
                            pw.world_fault_plan()))
        except Exception as e:   # both refuse alike
            results.append(type(e).__name__)
    assert results[0] == results[1]
    assert process_world.PHASES == jpw.PHASES


# ---------------------------------------------------------------------------
# the async path
# ---------------------------------------------------------------------------


def test_async_copy_is_ordered_before_in_place_updates(tmp_path,
                                                       monkeypatch):
    from paddle_tpu_torch.observability import tracing
    monkeypatch.setenv("PTPU_FAULT_INJECT", "slow_writer:0.3")
    arrays = _host_arrays()
    mark = tracing.mark()
    saves0 = _metric("ptpu_ckpt_saves_total")
    handle, prog, scope = _save(tmp_path, arrays, step=3, block=False)
    assert isinstance(handle, elastic.AsyncSnapshot)
    assert elastic.pending_async_count() == 1
    # the next step updates the live state IN PLACE while the writer
    # sleeps: the snapshot keeps the values of the save's boundary
    for name in arrays:
        scope.get(name).mul_(0.0).add_(5.0)
    path = handle.result(timeout=30)
    assert elastic.is_committed(path) and handle.done
    assert elastic.pending_async_count() == 0
    _, back = _restore(tmp_path, arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
    kinds = {(s.kind, s.name) for s in tracing.spans_since(mark)}
    assert {("checkpoint", "elastic/snapshot_d2h"),
            ("checkpoint", "elastic/snapshot_write"),
            ("checkpoint", "elastic/commit")} <= kinds
    assert _metric("ptpu_ckpt_saves_total") == saves0 + 1
    # two saves in flight commit distinct serials; wait_for_pending
    # drains both
    monkeypatch.setenv("PTPU_FAULT_INJECT", "slow_writer:0.2")
    h1, _, _ = _save(tmp_path / "o", arrays, step=1, block=False)
    h2, _, _ = _save(tmp_path / "o", {k: v + 1 for k, v in arrays.items()},
                     step=2, block=False)
    elastic.wait_for_pending(timeout=30)
    assert h1.done and h2.done and h1.result() != h2.result()
    # they commit in the order they were taken
    ts = [json.load(open(os.path.join(h.result(), elastic.COMMIT_MARKER)))[
        "commit_ts"] for h in (h1, h2)]
    assert ts[0] < ts[1]
    assert {elastic.read_meta(p)["step"] for _, p in
            elastic.list_snapshots(str(tmp_path / "o"))} == {1, 2}


# ---------------------------------------------------------------------------
# resume
# ---------------------------------------------------------------------------


def _fc_net(pkg, opt="adam"):
    L = pkg.layers
    x = L.data("x", shape=[16])
    label = L.data("label", shape=[1], dtype="int64")
    h = L.fc(x, size=32, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=4), label))
    if opt == "adam":
        pkg.optimizer.AdamOptimizer(learning_rate=1e-2).minimize(loss)
    elif opt == "momentum":
        pkg.optimizer.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)
    return loss


def _fc_feeds(n):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(8, 16).astype("float32"),
             "label": rng.randint(0, 4, (8, 1)).astype("int64")}
            for _ in range(n)]


def _port_pe(quant="int8"):
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        loss = _fc_net(ptt)
    ptt.Executor(ptt.CPUPlace()).run(ptt.default_startup_program())
    bst = BuildStrategy(reduce_strategy=ReduceStrategy.ReduceScatter,
                        quant_comm=quant, comm_error_feedback=bool(quant),
                        quant_comm_block=64)
    return loss, ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                  mesh=DeviceMesh(axes={"dp": 1}),
                                  build_strategy=bst)


def test_same_world_resume_is_bitwise_exact(tmp_path):
    """Parameters, accumulators, int8 error-feedback residuals and the
    run counter round-trip: the resumed losses and state equal the
    uninterrupted run's exactly; the placement check passes, and a
    mis-shaped block is caught."""
    feeds = _fc_feeds(5)
    loss, pe = _port_pe()
    ref = []
    for i, f in enumerate(feeds):
        ref.append(float(pe.run(feed=f, fetch_list=[loss])[0]))
        if i == 2:
            elastic.save_train_state(str(tmp_path), executor=pe, step=3)
    want = {n: ptt.global_scope().get(n).clone()
            for n in ptt.global_scope().local_var_names()}
    assert any(n.startswith("dp_comm_err") for n in want)
    loss, pe2 = _port_pe()
    meta = elastic.restore_train_state(str(tmp_path), executor=pe2)
    assert meta["step"] == 3 and pe2._run_counter == meta["run_counter"]
    assert meta["ef_layout"]["quant"] == "int8"
    got = [float(pe2.run(feed=f, fetch_list=[loss])[0]) for f in feeds[3:]]
    assert got == ref[3:]
    for n, v in want.items():
        assert torch.equal(ptt.global_scope().get(n), v), n
    prog = pe2.prepare_program()
    scope = ptt.global_scope()
    assert elastic.verify_restored_placement(pe2, prog, scope) == []
    ef = next(n for n in want if n.startswith("dp_comm_err"))
    scope.set_var(ef, torch.zeros(3, 5))
    bad = elastic.verify_restored_placement(pe2, prog, scope)
    assert bad and ef in bad[0]
    # the wire config must match the residuals'
    loss, pe3 = _port_pe(quant="bf16")
    with pytest.raises(EnforceError, match="quant"):
        elastic.restore_train_state(str(tmp_path), executor=pe3)


def test_resize_rows_and_ef_remap_equal_jax():
    from paddle_tpu.parallel import elastic as jelastic
    rng = np.random.RandomState(3)
    rows = rng.randn(4, 6).astype(np.float32)
    for m in (1, 2, 4, 8, 3):
        np.testing.assert_array_equal(elastic._resize_replica_rows(rows, m),
                                      jelastic._resize_replica_rows(rows, m))
    back = elastic._resize_replica_rows(elastic._resize_replica_rows(
        rows, 8), 4)
    np.testing.assert_array_equal(back, rows)

    def layout(dp, tp, tp_dims):
        """Two transfers: a sharded grad a [8, 6] and a bucket of b [4]
        and c [6, 4] (c tp-split on dim 1 when tp > 1)."""
        nl = lambda shape, d: int(np.prod(shape)) // (tp if d is not None
                                                      else 1)
        flat_b = nl([4], None) + nl([6, 4], tp_dims[1])
        return {"dp": dp, "tp": tp, "quant": "int8", "block": 64,
                "transfers": [
                    {"kind": "sharded", "grads": ["a"], "var": f"e{dp}{tp}_0",
                     "numels": [nl([8, 6], tp_dims[0])],
                     "flat": nl([8, 6], tp_dims[0]), "gshapes": [[8, 6]],
                     "tp_dims": [tp_dims[0]]},
                    {"kind": "bucket", "grads": ["b", "c"],
                     "var": f"e{dp}{tp}_1",
                     "numels": [nl([4], None), nl([6, 4], tp_dims[1])],
                     "flat": -(-flat_b // dp) * dp, "gshapes": [[4], [6, 4]],
                     "tp_dims": [None, tp_dims[1]]}]}

    class _Ckpt:
        def __init__(self, store):
            self.store = store

        def read(self, name):
            return self.store[name]

    for (odp, otp), (ndp, ntp) in (((2, 1), (4, 1)), ((4, 1), (2, 1)),
                                   ((2, 2), (4, 1)), ((2, 1), (1, 2))):
        old = layout(odp, otp, (0 if otp > 1 else None,
                                1 if otp > 1 else None))
        new = layout(ndp, ntp, (0 if ntp > 1 else None,
                                1 if ntp > 1 else None))
        store = {t["var"]: rng.randn(odp * otp, t["flat"]).astype(np.float32)
                 for t in old["transfers"]}
        got = elastic._remap_error_feedback(_Ckpt(store), old, new, ndp)
        want = jelastic._remap_error_feedback(_Ckpt(store), old, new, ndp)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# the reshard algebra
# ---------------------------------------------------------------------------


def test_reshard_schedule_balances_against_costs_and_equals_jax():
    from paddle_tpu.parallel import reshard as jreshard
    from paddle_tpu_torch.framework import costs
    steps = reshard.schedule_steps("v", (8, 4), 4, (2, 1), (4, 1))
    assert [s.kind for s in steps] == ["refine-slice"]
    nbytes = 16 * 48 * 4
    steps = reshard.schedule_steps("w", (16, 48), 4, (1, 2), (1, 1))
    assert [s.kind for s in steps] == ["all-gather"]
    assert steps[0].wire_bytes == nbytes / 2 == \
        costs.reshard_wire_bytes(nbytes, (1, 2), (1, 1))
    steps = reshard.schedule_steps("m", (8, 8), 4, (2, 1), (1, 2))
    assert [s.kind for s in steps] == ["refine-slice", "all-gather"]
    assert [s.kind for s in reshard.schedule_steps("i", (4,), 4, (2,),
                                                   (2,))] == ["identity"]
    rng = np.random.RandomState(0)
    for _ in range(60):
        rank = int(rng.randint(1, 4))
        old = tuple(int(rng.choice((1, 2, 4, 8))) for _ in range(rank))
        new = tuple(int(rng.choice((1, 2, 4, 8))) for _ in range(rank))
        shape = tuple(8 * max(o, n) for o, n in zip(old, new))
        steps = reshard.schedule_steps("v", shape, 4, old, new)
        got = sum(s.wire_bytes for s in steps)
        assert got == costs.reshard_wire_bytes(int(np.prod(shape)) * 4,
                                               old, new)
        assert [str(s) for s in steps] == [
            str(s) for s in jreshard.schedule_steps("v", shape, 4, old, new)]
    entry = {"chunks": [{"start": [0, 0], "shape": [4, 8]},
                        {"start": [4, 0], "shape": [4, 8]}]}
    assert reshard._coverage_factors(entry, (8, 8)) == (2, 1)


# ---------------------------------------------------------------------------
# the simulated world's barrier
# ---------------------------------------------------------------------------


class _MeshOnly:
    """An executor stand-in: a dp mesh of unjoined ranks and its policy
    (dim 0 of `sharded_*` split over dp, the rest replicated)."""

    def __init__(self, n):
        from paddle_tpu_torch.parallel import DeviceMesh
        self.mesh = DeviceMesh(ranks=range(n), axes={"dp": n})

    def state_sharding(self, program, name):
        return (self.mesh.sharding("dp", None) if name.startswith("sharded")
                else self.mesh.replicated())


def _world_save(root, world, generation=0, deadline=10.0, **kw):
    rng = np.random.RandomState(generation)
    arrays = {"sharded_w": rng.randn(8, 3).astype("f4"),
              "repl_w": rng.randn(5).astype("f4")}
    prog, scope = _program(arrays), ptt.Scope()
    for n, v in arrays.items():
        scope.set_var(n, torch.from_numpy(v))
    path = elastic.save_train_state(
        str(root), program=prog, scope=scope,
        executor=_MeshOnly(world.world_size), step=generation, world=world,
        barrier_deadline_s=deadline, **kw)
    return path, arrays


def test_barrier_binds_every_rank_in_one_commit(tmp_path):
    from paddle_tpu_torch.sharded_checkpoint import ShardedCheckpoint
    path, arrays = _world_save(tmp_path, ProcessWorld(4))
    elastic.validate_snapshot(path)
    marker = json.load(open(os.path.join(path, elastic.COMMIT_MARKER)))
    assert marker["manifests"] == 4
    assert marker["world"] == {"world_size": 4, "axes": {"dp": 4}}
    assert {f"shard-{r}.pts" for r in range(4)} <= set(marker["files"])
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith(elastic.STAGING_PREFIX)]
    ckpt = ShardedCheckpoint(path)
    for name, want in arrays.items():
        np.testing.assert_array_equal(ckpt.read(name).numpy(), want)
    assert len({c["file"] for c in ckpt.vars["sharded_w"]["chunks"]}) == 4
    meta = elastic.read_meta(path)
    assert meta["placements"]["sharded_w"] == [["dp"], None]
    assert meta["placements"]["repl_w"] == []
    handle, _ = _world_save(tmp_path / "a", ProcessWorld(2), block=False)
    elastic.validate_snapshot(handle.result(timeout=60))


@pytest.mark.parametrize("fault", ["straggle_rank:1@stage@1.0",
                                   "drop_rank:1@ack"])
def test_barrier_aborts_on_a_straggler_or_a_dropped_rank(tmp_path,
                                                         monkeypatch,
                                                         fault):
    world = ProcessWorld(2)
    monkeypatch.setenv("PTPU_FAULT_INJECT", fault)
    a0 = _metric("ptpu_ckpt_barrier_aborts_total")
    path, _ = _world_save(tmp_path, world, deadline=0.3)
    assert path is None
    assert _metric("ptpu_ckpt_barrier_aborts_total") == a0 + 1
    assert elastic.latest_snapshot(str(tmp_path)) is None
    monkeypatch.delenv("PTPU_FAULT_INJECT")
    path, _ = _world_save(tmp_path, world, generation=1, deadline=0.5)
    if fault.startswith("straggle"):
        # the next attempt commits and sweeps the straggler's staging
        time.sleep(1.0)
        path, _ = _world_save(tmp_path, world, generation=2)
        elastic.validate_snapshot(path)
    else:
        # a dead rank never stages again: every attempt aborts
        assert path is None and world.dead == {1}
        assert _metric("ptpu_ckpt_barrier_aborts_total") == a0 + 2


def test_process_world_messages_and_deaths():
    w = ProcessWorld(3)
    w.send(0, 1, "ack", serial=2)
    assert w.recv(1, timeout=1) == {"kind": "ack", "src": 0, "serial": 2}
    assert w.recv(1, timeout=0.05) is None
    w.send(0, 2, "x")
    w.drain(2)
    assert w.recv(2, timeout=0.05) is None

    def fn(rank):
        if rank == 1:
            raise process_world.RankDead(1, "ack")
        return rank * 10

    assert w.run(fn) == [0, None, 20] and w.dead == {1}
    assert w.live_ranks() == [0, 2]
    with pytest.raises(ValueError):
        w.run(lambda r: (_ for _ in ()).throw(ValueError("bug")))


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

VOCAB, T, D = 32, 4, 16


def _lm(pkg):
    loss, _ = pkg.models.transformer.transformer_lm(
        vocab=VOCAB, max_len=T, d_model=D, d_inner=2 * D, num_heads=2,
        num_layers=2, mean_loss=True)
    pkg.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    return loss


def test_jax_dp2_tp2_snapshot_restores_in_the_port(tmp_path):
    """The JAX package saves from dp2 x tp2 on 4 virtual devices (Reduce,
    tp-annotated); the port's one-process Executor restores every var
    whole with the JAX values, and its next loss is the JAX run's."""
    import jax

    import paddle_tpu as pt
    from paddle_tpu.parallel import ParallelExecutor as JPE
    from paddle_tpu.parallel import annotate_tp
    from paddle_tpu.parallel import elastic as jelastic
    from paddle_tpu.parallel.mesh import DeviceMesh as JMesh
    from paddle_tpu.parallel.strategy import BuildStrategy, ReduceStrategy
    rng = np.random.RandomState(5)
    feeds = [{"tokens": rng.randint(0, VOCAB, (8, T)).astype("int64"),
              "tokens@SEQLEN": np.full((8,), T, dtype="int32"),
              "targets": rng.randint(0, VOCAB, (8, T)).astype("int64")}
             for _ in range(2)]
    old = pt.core.flags.get_flag("use_bf16_matmul")
    pt.core.flags.set_flag("use_bf16_matmul", False)
    ptt.flags.set_flag("use_bf16_matmul", False)
    try:
        with pt.core.unique_name.guard():
            jloss = _lm(pt)
        assert annotate_tp()
        pt.Executor().run(pt.default_startup_program())
        jpe = JPE(loss_name=jloss.name,
                  build_strategy=BuildStrategy(
                      reduce_strategy=ReduceStrategy.Reduce),
                  mesh=JMesh(jax.devices()[:4], {"dp": 2, "tp": 2}))
        jpe.run(fetch_list=[jloss], feed=feeds[0])
        snap = jelastic.save_train_state(str(tmp_path), executor=jpe,
                                         step=1)
        jscope = pt.global_scope()
        jvals = {n: np.asarray(jscope.get(n))
                 for n in jelastic.read_meta(snap)["var_names"]}
        jnext = float(np.asarray(jpe.run(fetch_list=[jloss],
                                         feed=feeds[1])[0]))
        with ptt.unique_name.guard():
            loss = _lm(ptt)
        exe = ptt.Executor(ptt.CPUPlace())
        exe.run(ptt.default_startup_program())
        meta = elastic.restore_train_state(snap, executor=exe)
        assert meta["world"] == {"dp": 2, "tp": 2}
        scope = ptt.global_scope()
        for n, v in jvals.items():
            got = scope.get(n)
            assert tuple(got.shape) == v.shape, n
            np.testing.assert_array_equal(got.numpy(), v, err_msg=n)
        got = float(exe.run(feed=feeds[1], fetch_list=[loss])[0])
        np.testing.assert_allclose(got, jnext, atol=1e-5)
    finally:
        pt.core.flags.set_flag("use_bf16_matmul", old)
        ptt.flags.set_flag("use_bf16_matmul", True)


def test_port_snapshot_restores_in_the_jax_package(tmp_path):
    import paddle_tpu as pt
    from paddle_tpu.parallel import elastic as jelastic
    with ptt.unique_name.guard():
        loss = _fc_net(ptt)
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    exe.run(feed=_fc_feeds(1)[0], fetch_list=[loss])
    path = elastic.save_train_state(str(tmp_path), executor=exe, step=1)
    want = {n: ptt.global_scope().get(n).numpy().copy()
            for n in elastic.read_meta(path)["var_names"]}
    with pt.core.unique_name.guard():
        _fc_net(pt)
    jexe = pt.Executor()
    jexe.run(pt.default_startup_program())
    meta = jelastic.restore_train_state(path, executor=jexe)
    assert meta["run_counter"] == exe._run_counter == jexe._run_counter
    for n, v in want.items():
        np.testing.assert_array_equal(np.asarray(pt.global_scope().get(n)),
                                      v, err_msg=n)


# ---------------------------------------------------------------------------
# trainer, Supervisor, distributed.elastic and the master
# ---------------------------------------------------------------------------


def _trainer(root, **kw):
    def train_func():
        x = ptt.layers.data("x", shape=[4])
        return ptt.layers.reduce_mean(ptt.layers.fc(x, size=2))

    cfg = ptt.CheckpointConfig(checkpoint_dir=str(root), step_interval=2,
                               elastic=True, **kw)
    with ptt.unique_name.guard():
        return ptt.Trainer(train_func,
                           lambda: ptt.optimizer.SGD(learning_rate=0.01),
                           place=ptt.CPUPlace(), checkpoint_config=cfg), cfg


def test_elastic_trainer_resumes_past_trained_work(tmp_path):
    def reader():
        rng = np.random.RandomState(3)
        for _ in range(6):
            yield [(rng.rand(4).astype("f4"),)]

    trainer, _ = _trainer(tmp_path, async_save=True)
    trainer.train(num_epochs=1, event_handler=lambda e: None, reader=reader,
                  feed_order=["x"])
    assert elastic.pending_async_count() == 0
    assert elastic.read_meta(str(tmp_path))["extra"]["epoch_id"] == 1
    trainer2, cfg2 = _trainer(tmp_path)
    assert cfg2.epoch_id == 1
    steps = []
    trainer2.train(num_epochs=1, event_handler=steps.append, reader=reader,
                   feed_order=["x"])
    assert not any(isinstance(e, ptt.trainer.BeginStepEvent) for e in steps)
    with pytest.raises(EnforceError, match="elastic"):
        ptt.CheckpointConfig(checkpoint_dir=str(tmp_path), async_save=True)


def _exit_with(code):
    return [sys.executable, "-c", f"import sys; sys.exit({code})"]


def test_supervisor_backoff_jitter_exhaustion_and_healthy_reset(tmp_path):
    from paddle_tpu_torch.trainer import Supervisor, SupervisorExhaustedError
    marker = str(tmp_path / "attempts")
    prog = (f"import os,sys\np={marker!r}\n"
            f"n=int(open(p).read()) if os.path.exists(p) else 0\n"
            f"open(p,'w').write(str(n+1))\nsys.exit(0 if n >= 2 else 9)\n")
    delays = []
    sup = Supervisor([sys.executable, "-c", prog], max_restarts=5,
                     backoff_s=0.1, backoff_factor=2.0,
                     sleep_fn=delays.append)
    assert sup.run() == 0 and sup.restarts == 2
    assert sup.exit_codes == [9, 9, 0] and delays == [0.1, 0.2]
    sup = Supervisor(_exit_with(7), max_restarts=1, backoff_s=0.05,
                     sleep_fn=lambda s: None)
    assert sup.run() == 7 and sup.exit_codes == [7, 7] and sup.exhausted
    sup = Supervisor(_exit_with(5), max_restarts=1, backoff_s=0.01,
                     raise_on_exhaust=True, sleep_fn=lambda s: None)
    with pytest.raises(SupervisorExhaustedError, match="crash-looping") as ei:
        sup.run()
    assert ei.value.exit_code == 5 and ei.value.exit_codes == [5, 5]

    class _Rng:
        def __init__(self):
            self.calls = []

        def uniform(self, a, b):
            self.calls.append((a, b))
            return 0.5 * (a + b) + 0.1

    rng, delays = _Rng(), []
    sup = Supervisor(_exit_with(3), max_restarts=2, backoff_s=0.1,
                     backoff_factor=2.0, backoff_jitter=0.25, rng=rng,
                     sleep_fn=delays.append)
    assert sup.run() == 3
    assert rng.calls == [(-0.25, 0.25)] * 2
    np.testing.assert_allclose(delays, [0.1 * 1.1, 0.2 * 1.1])
    child = "import sys,time\ntime.sleep(0.25)\nsys.exit(9)\n"
    delays = []
    sup = Supervisor([sys.executable, "-c", child], max_restarts=2,
                     backoff_s=0.05, backoff_factor=4.0, healthy_run_s=0.2,
                     sleep_fn=delays.append)
    assert sup.run() == 9 and delays == [0.05, 0.05]
    delays = []
    sup = Supervisor(_exit_with(9), max_restarts=2, backoff_s=0.05,
                     backoff_factor=4.0, healthy_run_s=10.0,
                     sleep_fn=delays.append)
    assert sup.run() == 9 and delays == [0.05, 0.2]


def test_supervisor_gang_sets_the_distributed_env(tmp_path):
    """world_size 3: each rank sees PTPU_WORLD_* and the PADDLE_* role
    protocol (one coordinator endpoint per incarnation) that
    distributed.parse_env reads; one rank dying restarts the gang."""
    from paddle_tpu_torch.trainer import Supervisor
    from paddle_tpu_torch.distributed.env import parse_env
    marker = str(tmp_path / "died")
    child = (
        "import json, os, sys, time\n"
        "r = os.environ['PTPU_WORLD_RANK']\n"
        f"open({str(tmp_path)!r} + '/env' + r, 'w').write("
        "json.dumps(dict(os.environ)))\n"
        f"p = {marker!r}\n"
        "if r == '1' and not os.path.exists(p):\n"
        "    open(p, 'w').write('1')\n"
        "    sys.exit(6)\n"
        "if not os.path.exists(p):\n"
        "    time.sleep(30)\n"
        "sys.exit(0)\n")
    sup = Supervisor([sys.executable, "-c", child], world_size=3,
                     max_restarts=3, backoff_s=0.05,
                     sleep_fn=lambda s: None)
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.exit_codes == [6, 0]
    coordinators = set()
    for r in range(3):
        env = json.load(open(tmp_path / f"env{r}"))
        e = parse_env(env)
        assert e.trainer_id == r and e.num_trainers == 3
        assert env["PTPU_WORLD_SIZE"] == "3" and env["PADDLE_LOCAL_RANK"] \
            == str(r)
        assert e.coordinator.startswith("127.0.0.1:")
        coordinators.add(e.coordinator)
    assert len(coordinators) == 1


def test_preemption_guard_and_elastic_trainer(tmp_path):
    from paddle_tpu_torch.distributed import ElasticTrainer, PreemptionGuard
    with ptt.unique_name.guard():
        loss = _fc_net(ptt, opt="momentum")
    exe = ptt.Executor(ptt.CPUPlace())
    exe.run(ptt.default_startup_program())
    feeds = _fc_feeds(5)
    guard = PreemptionGuard(signals=())
    assert not guard.should_stop
    et = ElasticTrainer(exe, str(tmp_path), save_interval_steps=2,
                        guard=guard)
    assert et.resume_step() == -1

    def step(i):
        if i == 2:
            guard.request()
        return float(exe.run(feed=feeds[i], fetch_list=[loss])[0])

    out = et.run(step, num_steps=5)
    assert out["preempted"] and out["last_step"] == 2
    assert ElasticTrainer(exe, str(tmp_path)).resume_step() == 2
    et2 = ElasticTrainer(exe, str(tmp_path), save_interval_steps=2)
    out = et2.run(lambda i: float(exe.run(feed=feeds[i],
                                          fetch_list=[loss])[0]), 5)
    assert out["last_step"] == 4 and len(out["losses"]) == 2


def test_master_leases_retries_and_snapshot(tmp_path):
    from paddle_tpu_torch.distributed import (FailureDetector, Master,
                                              MasterClient)
    snap = str(tmp_path / "master.pkl")
    m = Master(snapshot_path=snap, timeout_s=0.2, max_retry=2,
               chunks_per_task=2)
    assert m.set_dataset([f"c{i}" for i in range(5)]) == 3
    server, _ = m.serve_forever()
    try:
        c = MasterClient("%s:%d" % server.server_address, worker_id="w0")
        t0 = c.get_task()
        assert t0["chunks"] == ["c0", "c1"] and c.task_finished(t0["task_id"])
        t1 = c.get_task()
        assert c.task_failed(t1["task_id"])      # requeued: 1 failure
        t2 = c.get_task()
        assert t2["chunks"] == ["c4"]
        time.sleep(0.3)                          # t2's lease expires
        again = c.get_task()                     # the expiry is a failure
        assert again["task_id"] == t1["task_id"]
        assert c.task_failed(t1["task_id"])      # 2nd failure: discarded
        last = c.get_task()
        assert last["task_id"] == t2["task_id"]
        assert c.task_finished(last["task_id"])
        assert c.get_task() is None              # the one pass is done
        assert c.stats() == {"todo": 0, "pending": 0, "done": 2,
                             "discarded": 1, "epoch": 0}
        c.heartbeat()
        assert c.live_workers() == ["w0"]
    finally:
        server.shutdown()
    # a restarted master recovers its queues (leases back to todo)
    m2 = Master(snapshot_path=snap)
    assert m2.stats()["done"] == 2
    dead = []
    fd = FailureDetector(m2, ["w0", "w1"], horizon_s=0.05, poll_s=0.01,
                         grace_s=0.0)
    fd.start(dead.append)
    time.sleep(0.2)
    fd.stop()
    assert dead and dead[0] == {"w0", "w1"}


# ---------------------------------------------------------------------------
# SIGKILL subprocesses (this file run as a script)
# ---------------------------------------------------------------------------


def _child_env(fault=None):
    env = dict(os.environ)
    env.pop("PTPU_FAULT_INJECT", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if fault:
        env["PTPU_FAULT_INJECT"] = fault
    return env


def child_train(root, out, fault_once=None):
    """Train the fc net for 6 steps through Trainer with async elastic
    snapshots every 2 steps (resuming from the latest), then write the
    final parameters to `out`. `fault_once` arms PTPU_FAULT_INJECT in
    the first incarnation only."""
    sentinel = os.path.join(root, "armed")
    if fault_once and not os.path.exists(sentinel):
        os.makedirs(root, exist_ok=True)
        open(sentinel, "w").close()
        os.environ["PTPU_FAULT_INJECT"] = fault_once
    feeds = _fc_feeds(6)

    def reader():
        for f in feeds:
            yield list(zip(f["x"], f["label"]))

    cfg = ptt.CheckpointConfig(checkpoint_dir=os.path.join(root, "ckpt"),
                               step_interval=2, elastic=True,
                               async_save=True)
    with ptt.unique_name.guard():
        tr = ptt.Trainer(lambda: _fc_net(ptt, opt=None), lambda:
                         ptt.optimizer.AdamOptimizer(learning_rate=1e-2),
                         place=ptt.CPUPlace(), checkpoint_config=cfg)
    tr.train(num_epochs=1, event_handler=lambda e: None, reader=reader,
             feed_order=["x", "label"])
    np.savez(out, **{n: tr.scope.get(n).numpy() for n in
                     tr.scope.local_var_names()})


def child_atomic(root):
    """Commit generation 0, then save generation 1 (which
    PTPU_FAULT_INJECT may kill at any byte offset)."""
    fault = os.environ.pop("PTPU_FAULT_INJECT", None)
    arrays = _host_arrays()
    _save(root, arrays, step=0)
    if fault:
        os.environ["PTPU_FAULT_INJECT"] = fault
    _save(root, {k: v + 1.0 for k, v in arrays.items()}, step=1)


def test_supervised_crash_at_step_resumes_bitwise(tmp_path):
    from paddle_tpu_torch.trainer import Supervisor
    ref = str(tmp_path / "ref.npz")
    child_train(str(tmp_path / "r"), ref)     # uninterrupted, in-process
    out = str(tmp_path / "out.npz")
    sup = Supervisor([sys.executable, HERE, "train", str(tmp_path / "c"), out,
                      "crash_at_step:5"], max_restarts=2, backoff_s=0.0,
                     env=_child_env(), sleep_fn=lambda s: None)
    assert sup.run() == 0
    assert sup.restarts == 1 and sup.exit_codes == [-9, 0]
    want, got = np.load(ref), np.load(out)
    assert sorted(want.files) == sorted(got.files)
    for n in want.files:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)
    assert elastic.latest_snapshot(str(tmp_path / "c" / "ckpt")) is not None


def test_crash_mid_save_at_a_random_offset_leaves_no_half_write(tmp_path):
    child_atomic(str(tmp_path / "ref"))       # unfaulted, in-process
    snaps = elastic.list_snapshots(str(tmp_path / "ref"))
    marker = json.load(open(os.path.join(snaps[-1][1],
                                         elastic.COMMIT_MARKER)))
    total = sum(e["size"] for e in marker["files"].values())
    off = int(np.random.RandomState(20260804).randint(1, total))
    root = tmp_path / "crash"
    rc = subprocess.run([sys.executable, HERE, "atomic", str(root)],
                        env=_child_env(f"crash_mid_save:{off}"),
                        timeout=120).returncode
    assert rc == -9
    arrays = _host_arrays()
    for _, path in elastic.list_snapshots(str(root), committed_only=False):
        if not elastic.is_committed(path):
            with pytest.raises(EnforceError):
                elastic.validate_snapshot(path)
    assert {elastic.read_meta(p)["step"]
            for _, p in elastic.list_snapshots(str(root))} == {0}
    _, back = _restore(root, arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)


if __name__ == "__main__":
    if sys.argv[1] == "train":
        child_train(sys.argv[2], sys.argv[3],
                    sys.argv[4] if len(sys.argv) > 4 else None)
    else:
        child_atomic(sys.argv[2])
