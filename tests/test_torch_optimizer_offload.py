"""The optimizer tier of framework/offload.py (`HostOptimizerState`, the
round-trip schedule and its lint) against the JAX package's.

`optimizer_state_names`, `optimizer_roundtrip_events` and
`check_schedule` are host logic: the same program gives the same names,
events and diagnostic codes in both packages. The executor's round trip
runs on a ParallelExecutor of one rank with no world (Reduce mode, Adam):
losses with offload on are bitwise those with it off and equal the JAX
one-device losses within 1e-6; between steps the scope holds no
accumulator; a snapshot taken with offload on restores to the same next
loss as one taken without. On the CPU the transfer stream copies at once;
the pinned slab, the side stream and its events run in chip_smoke.py's
phase 45.
"""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.framework import offload as jofl

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import offload as ofl
from paddle_tpu_torch.framework.scope import Scope

from tests.port_env import port_jax_compile_cache  # noqa: F401

CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    ofl.reset_offload()
    with ptt.unique_name.guard():
        yield
    ofl.reset_offload()


def _mlp(pkg):
    L = pkg.layers
    x = L.data("x", shape=[32])
    label = L.data("label", shape=[1], dtype="int64")
    h = L.fc(x, size=64, act="relu")
    loss = L.mean(L.softmax_with_cross_entropy(L.fc(h, size=10), label))
    pkg.optimizer.AdamOptimizer(0.01).minimize(loss)
    return loss


def _feeds(steps):
    rng = np.random.RandomState(11)
    return [{"x": rng.rand(16, 32).astype("float32"),
             "label": rng.randint(0, 10, (16, 1)).astype("int64")}
            for _ in range(steps)]


@pytest.fixture(scope="module")
def jax_run():
    """The JAX program, its startup state and its one-device losses."""
    pt.reset_default_programs()
    pt.reset_global_scope()
    with pt.core.unique_name.guard():
        loss = _mlp(pt)
    pt.Executor().run(pt.default_startup_program())
    scope = pt.global_scope()
    init = {n: np.asarray(scope.get(n)) for n in scope.local_var_names()}
    names = jofl.optimizer_state_names(pt.default_main_program(), scope)
    events = jofl.optimizer_roundtrip_events(pt.default_main_program())
    exe = pt.Executor()
    losses = [np.asarray(exe.run(feed=f, fetch_list=[loss])[0])
              for f in _feeds(4)]
    return {"init": init, "names": names, "events": events,
            "losses": losses, "program": pt.default_main_program()}


def _port_exe(init, offload, scope=None):
    from paddle_tpu_torch.parallel import (BuildStrategy, DeviceMesh,
                                           ParallelExecutor, ReduceStrategy)
    ptt.reset_default_programs()
    scope = scope or Scope()
    with ptt.unique_name.guard():
        loss = _mlp(ptt)
    ptt.Executor(CPU).run(ptt.default_startup_program(), scope=scope)
    ptt.io.load_numpy_params(init, scope=scope, place=CPU)
    pe = ParallelExecutor(
        use_cuda=False, loss_name=loss.name, scope=scope,
        main_program=ptt.default_main_program(),
        mesh=DeviceMesh(ranks=[0], axes={"dp": 1}),
        build_strategy=BuildStrategy(
            reduce_strategy=ReduceStrategy.Reduce,
            offload_optimizer_state=offload))
    return pe, loss, scope


def _losses(pe, loss, feeds):
    return [np.asarray(pe.run(fetch_list=[loss], feed=f)[0]) for f in feeds]


def test_state_names_and_events_equal_jax(jax_run):
    loss = _mlp(ptt)
    scope = Scope()
    ptt.Executor(CPU).run(ptt.default_startup_program(), scope=scope)
    prog = ptt.default_main_program()
    assert ofl.optimizer_state_names(prog, scope) == jax_run["names"]
    assert any("moment1" in n for n in jax_run["names"])
    tev = ofl.optimizer_roundtrip_events(prog)
    assert [dataclasses.astuple(e) for e in tev] == \
        [dataclasses.astuple(e) for e in jax_run["events"]]
    del loss


@pytest.mark.parametrize("case", ["kv_clean", "kv_late", "kv_issue",
                                  "optimizer", "optimizer_late",
                                  "rollback"])
def test_schedule_lint_codes_equal_jax(jax_run, case):
    _mlp(ptt)
    out = []
    for mod, prog in ((jofl, jax_run["program"]),
                      (ofl, ptt.default_main_program())):
        if case.startswith("kv"):
            ev = mod.kv_prefetch_events({"r1": 5, "r2": 9}, 2)
            if case == "kv_late":
                ev = [dataclasses.replace(ev[0],
                                          arrive_tick=ev[0].read_tick + 1)]
            elif case == "kv_issue":
                ev = [dataclasses.replace(ev[0],
                                          issue_tick=ev[0].read_tick + 3,
                                          arrive_tick=ev[0].read_tick + 3)]
            diags = mod.check_schedule(ev)
        elif case == "rollback":
            ev = mod.kv_prefetch_events({"r1": 5}, 2)
            diags = mod.check_schedule(ev, rollback_windows={"r1": [4]})
        else:
            ev = mod.optimizer_roundtrip_events(prog)
            if case == "optimizer_late":
                first = min(e.read_tick for e in ev if e.direction == "h2d")
                ev = mod.optimizer_roundtrip_events(prog,
                                                    restore_at=first + 1)
            diags = mod.check_schedule(ev)
        out.append([(d.code, d.severity, d.loc) for d in diags])
    assert out[0] == out[1]
    want = {"kv_clean": set(), "optimizer": set(),
            "rollback": {"offload-stale-after-rollback"}}.get(
        case, {"offload-use-before-arrival"})
    assert {c for c, _, _ in out[1]} == want


def test_unit_roundtrip_is_bitwise():
    pool = ofl.PinnedHostPool()
    scope = Scope()
    rng = np.random.RandomState(0)
    vals = {f"adam_m_{i}": torch.from_numpy(
        rng.rand(4, 5 + i).astype("float32")) for i in range(3)}
    vals["beta_pow"] = torch.tensor([0.9], dtype=torch.float64)
    for k, v in vals.items():
        scope.set_var(k, v.clone())
    ho = ofl.HostOptimizerState(scope, sorted(vals),
                                stream=ofl.TransferStream(CPU), pool=pool)
    ho.offload()
    assert ho.offloaded and not any(scope.has_var(k) for k in vals)
    assert pool.used_bytes("optimizer") >= ho.bytes_per_direction == sum(
        v.numel() * v.element_size() for v in vals.values())
    for k, v in vals.items():
        assert ho.host_view(k).numpy().tobytes() == v.numpy().tobytes()
    ho.restore()
    assert ho.roundtrips == 1
    for k, v in vals.items():
        assert scope.get(k).dtype == v.dtype
        assert scope.get(k).numpy().tobytes() == v.numpy().tobytes()
    ho.release()
    assert pool.used_bytes("optimizer") == 0
    with pytest.raises(InvalidArgumentError):
        ofl.HostOptimizerState(Scope(), [])


def test_offload_is_bitwise_and_leaves_no_accumulator(jax_run):
    feeds = _feeds(3)
    pe, loss, _ = _port_exe(jax_run["init"], False)
    base = _losses(pe, loss, feeds)
    pe, loss, scope = _port_exe(jax_run["init"], True)
    names = ofl.optimizer_state_names(pe.prepare_program(), scope)
    assert names
    for f in feeds:
        got = np.asarray(pe.run(fetch_list=[loss], feed=f)[0])
        # between steps the accumulators live in the host slab only
        assert not any(scope.has_var(n) for n in names)
        assert ofl.shared_host_pool().used_bytes("optimizer") > 0
        assert got.tobytes() == base.pop(0).tobytes()
        np.testing.assert_allclose(got, jax_run["losses"][len(feeds) - 1
                                                          - len(base)],
                                   rtol=1e-6, atol=1e-6)
    ho = pe._host_opt
    assert ho.offloaded and ho.roundtrips == 2
    assert ho.bytes_per_direction == sum(
        ho.host_view(n).numel() * ho.host_view(n).element_size()
        for n in names)
    with pytest.raises(InvalidArgumentError, match="bound step"):
        pe.prepare(feed=feeds[0], fetch_list=[loss])


def test_kill_switch_keeps_the_state_on_the_device(jax_run, monkeypatch):
    monkeypatch.setenv("PTPU_OFFLOAD", "0")
    pe, loss, scope = _port_exe(jax_run["init"], True)
    _losses(pe, loss, _feeds(1))
    assert pe._host_opt is None


def test_snapshot_with_offload_restores_the_same_next_loss(jax_run,
                                                           tmp_path):
    from paddle_tpu_torch.parallel import elastic
    feeds = _feeds(3)
    nxt = {}
    for offload in (False, True):
        pe, loss, scope = _port_exe(jax_run["init"], offload)
        _losses(pe, loss, feeds[:2])
        root = str(tmp_path / f"snap{int(offload)}")
        elastic.save_train_state(root, program=pe.main_program,
                                 scope=scope, executor=pe, step=2)
        # a fresh run restores the snapshot (offload off) and takes step 3
        pe2, loss2, scope2 = _port_exe(jax_run["init"], False)
        elastic.restore_train_state(root, program=pe2.main_program,
                                    scope=scope2, executor=pe2)
        nxt[offload] = _losses(pe2, loss2, feeds[2:])[0]
        # the offloading run itself goes on from the same state
        assert _losses(pe, loss, feeds[2:])[0].tobytes() == \
            nxt[offload].tobytes()
    assert nxt[True].tobytes() == nxt[False].tobytes()
    np.testing.assert_allclose(nxt[True], jax_run["losses"][2], rtol=1e-6,
                               atol=1e-6)
