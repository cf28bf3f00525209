"""The host tier of the port (framework/offload.py and the two-tier paged
KV engine) against the JAX package's.

The pool ledger, the transfer stream's census and errors, and the pager's
two-tier accounting are host logic: the same operations must give the
same ledgers, block ids and counters in both packages. The two-tier
engine (small model: vocab 64, d_model 32, 2 layers, blocks of 4, a pool
of 9 blocks under 6 slots, so it must spill) must give the JAX two-tier
engine's tokens, host evictions and reloads, with an exact byte census,
in float32 (use_bf16_matmul off in both; weights carried over by
`load_numpy_params`). Both packages' pagers run under their shadow-state
sanitizers (tests/conftest.py sets PTPU_KV_SANITIZE=1). On the CPU the
transfer stream runs each copy at once; the CUDA side stream, the pinned
slab and the events run in chip_smoke.py's phase 30.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework import offload as jofl
from paddle_tpu.serving import HostTierConfig as JTier
from paddle_tpu.serving import KVPager as JPager
from paddle_tpu.serving import PagedKVEngine as JPaged

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import (InvalidArgumentError,
                                           UnavailableError)
from paddle_tpu_torch.framework import offload as ofl
from paddle_tpu_torch.serving import (HostTierConfig, KVPager,
                                      PagedKVEngine, SpecConfig)

from tests.port_env import port_jax_compile_cache  # noqa: F401

DIMS = dict(vocab=64, max_len=16, d_model=32, d_inner=64, num_heads=4,
            num_layers=2)
CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = (jflags.get_flag("use_bf16_matmul"),
             tflags.get_flag("use_bf16_matmul"))
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    ofl.reset_offload()
    jofl.reset_offload()
    with ptt.unique_name.guard():
        yield
    jflags.set_flag("use_bf16_matmul", saved[0])
    tflags.set_flag("use_bf16_matmul", saved[1])


@pytest.fixture(scope="module")
def params():
    """The JAX package's initial weights for DIMS, as numpy (float32)."""
    saved = jflags.get_flag("use_bf16_matmul")
    jflags.set_flag("use_bf16_matmul", False)
    try:
        jscope = pt.Scope()
        eng = JPaged(n_slots=2, block_size=4, scope=jscope, **DIMS)
        return {p.name: np.asarray(jscope.get(p.name))
                for p in eng._program.all_parameters()}
    finally:
        jflags.set_flag("use_bf16_matmul", saved)


# -- the pinned host pool: the one ledger ----------------------------------


def _pool_script(ofl_mod, alloc):
    """One ledger sequence through a package's PinnedHostPool; returns
    the rows after each step."""
    pool = ofl_mod.PinnedHostPool(capacity_bytes=256)
    rows = []
    a = alloc(pool, (8,), "kv")                       # 32 bytes
    rows.append(pool.rows())
    lease = pool.lease(100, "staging")
    rows.append(pool.rows())
    with pytest.raises(Exception):                    # over capacity
        alloc(pool, (64,), "optimizer")
    rows.append(pool.rows())                          # untouched
    pool.free(a)
    pool.free(a)                                      # double free: no-op
    lease.release()
    lease.release()                                   # idempotent
    rows.append(pool.rows())
    with pytest.raises(Exception):
        pool._credit("kv", -1)                        # under-release
    with pytest.raises(Exception):
        alloc(pool, (4,), "bogus")                    # unknown category
    rows.append(pool.rows())
    return rows


def test_pool_ledger_same_rows_as_jax():
    port = _pool_script(ofl, lambda p, shape, c: p.alloc(shape, np.float32,
                                                         c))
    ref = _pool_script(jofl, lambda p, shape, c: p.alloc(shape, np.float32,
                                                         c))
    assert port == ref
    assert port[1]["host_total_bytes"] == 132
    assert port[-1]["host_peak_bytes"] == 132          # the peak sticks


def test_pool_alloc_is_a_torch_tensor_and_moves_the_watermark():
    from paddle_tpu_torch.observability import memory
    memory.reset_watermarks()
    pool = ofl.PinnedHostPool()
    buf = pool.alloc((4, 3), np.float32, "kv")
    assert isinstance(buf.tensor, torch.Tensor) and buf.nbytes == 48
    assert buf.tensor.shape == (4, 3) and buf.tensor.dtype == torch.float32
    assert memory.watermark_board()["host_kv_bytes"]["current"] == 48
    pool.free(buf)
    board = memory.watermark_board()["host_kv_bytes"]
    assert board == {"current": 0.0, "peak": 48.0}


def test_slab_slots_charge_the_ledger_and_coalesce_into_runs():
    pool = ofl.PinnedHostPool()
    slab = pool.slab(8, 16, "kv", pin=False)
    a = slab.alloc(3)
    b = slab.alloc(2)
    assert (a.slots, b.slots) == ([0, 1, 2], [3, 4])
    assert pool.used_bytes("kv") == 5 * 16 and slab.n_free == 3
    pool.free(a)
    c = slab.alloc(4)                    # slots 0, 1, 2 and 5
    assert c.slots == [0, 1, 2, 5]
    assert slab.runs(c.slots) == [(0, 0, 3), (3, 5, 1)]
    with pytest.raises(InvalidArgumentError, match="free slots"):
        slab.alloc(3)
    assert pool.used_bytes("kv") == 6 * 16        # the refusal moved nothing
    pool.free(b)
    pool.free(c)
    assert pool.used_bytes() == 0 and slab.n_free == 8
    assert slab.tensor.dtype == torch.uint8 and not slab.pinned


# -- the transfer stream ----------------------------------------------------


def test_stream_byte_census_exact_like_jax():
    def script(stream):
        for nb in (10, 20, 30):
            stream.submit("d2h", lambda: None, nb, tag="t").wait(10)
        stream.submit("h2d", lambda: None, 7, tag="t").wait(10)
        return stream.counters()

    port = script(ofl.TransferStream(CPU))
    ref = script(jofl.TransferStream())
    assert {k: port[k] for k in port} == {k: ref[k] for k in port}
    assert port == {"d2h_bytes": 60, "h2d_bytes": 7, "d2h_jobs": 3,
                    "h2d_jobs": 1}
    assert ofl.offload_stats()["d2h_bytes_total"] == 60


def test_stream_error_surfaces_at_wait_and_wait_on():
    stream = ofl.TransferStream(CPU)

    def boom():
        raise RuntimeError("copy failed")

    t = stream.submit("d2h", boom, 4, tag="bad")
    assert t.done()                      # CPU: the job ran at once
    with pytest.raises(RuntimeError, match="copy failed"):
        t.wait(10)
    t2 = stream.submit("h2d", boom, 4, tag="bad")
    with pytest.raises(RuntimeError, match="copy failed"):
        t2.wait_on(None)
    assert not t2.ordered                # a failed wait orders nothing
    # the stream survives a failed job
    ok = stream.submit("d2h", lambda: 5, 4, tag="ok")
    assert not ok.ordered and ok.wait_on(None) == 5 and ok.ordered
    assert ok.elapsed_s() is None        # no device timing on the CPU
    with pytest.raises(InvalidArgumentError, match="direction"):
        stream.submit("d2d", lambda: None, 1)


class _FakeEvent:
    """A stand-in for a CUDA timing event: `query()` and `elapsed_time`."""

    def __init__(self, t_ms, done=True):
        self.t_ms, self.done = t_ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def test_stream_rates_fold_completed_jobs_and_hold_no_ticket():
    """The stream keeps only the timing events of jobs still in flight:
    a completed job's bytes and copy time fold into the per-direction
    totals and its events are dropped, so a long-running engine's stream
    holds no ticket and none of the tensors its jobs made."""
    stream = ofl.TransferStream(CPU)
    late = _FakeEvent(9.0, done=False)
    stream._timed.extend([("d2h", 100, _FakeEvent(0.0), _FakeEvent(2.0)),
                          ("h2d", 50, _FakeEvent(2.0), _FakeEvent(3.0)),
                          ("d2h", 300, _FakeEvent(3.0), late)])
    r = stream.rates()
    assert r["d2h"]["bytes"] == 100 and r["h2d"]["bytes"] == 50
    assert r["d2h"]["seconds"] == pytest.approx(2e-3)
    assert r["d2h"]["gb_per_s"] == pytest.approx(100 / 2e-3 / 1e9)
    assert len(stream._timed) == 1          # the job still in flight
    late.done = True
    r = stream.rates()
    assert r["d2h"]["bytes"] == 400 and r["d2h"]["seconds"] == \
        pytest.approx(8e-3)
    assert not stream._timed
    # a CPU job is never timed and never kept
    stream.submit("h2d", lambda: torch.zeros(4), 16).wait(10)
    assert not stream._timed and stream.rates()["h2d"]["bytes"] == 50


def test_stream_and_engine_default_to_the_card():
    """Without a card the default place raises instead of dropping to the
    CPU; with one it is CUDAPlace(0)."""
    if torch.cuda.is_available():
        assert ofl.TransferStream().device == torch.device("cuda", 0)
        return
    with pytest.raises(UnavailableError):
        ofl.TransferStream()
    with pytest.raises(UnavailableError):
        ofl.shared_stream()
    with pytest.raises(UnavailableError):
        PagedKVEngine(n_slots=2, block_size=4,
                      host_tier=HostTierConfig(host_blocks=4), **DIMS)


def test_prefetch_schedule_and_counters_like_jax():
    reads = {"r1": 9, "r0": 4}
    assert [vars(e) for e in ofl.kv_prefetch_events(reads, 2)] == \
        [vars(e) for e in jofl.kv_prefetch_events(reads, 2)]
    assert ofl.prefetch_issue_tick(9, 2) == jofl.prefetch_issue_tick(9, 2)
    for mod in (ofl, jofl):
        mod.reset_offload()
        mod.note_eviction(3)
        mod.note_prefetch(True)
        mod.note_prefetch(False)
    assert ofl.offload_stats() == jofl.offload_stats()
    ofl.reset_offload()
    assert ofl.offload_stats()["evictions_total"] == 0


@pytest.mark.parametrize("bad", [dict(host_blocks=0),
                                 dict(prefetch_distance=-1),
                                 dict(rotate_quantum=-1)])
def test_host_tier_config_enforced(bad):
    with pytest.raises(InvalidArgumentError):
        HostTierConfig(**bad)


# -- the pager's two-tier accounting ---------------------------------------


def _two_tier_script(Pager, Tier, seed=7, cycles=100):
    """Random admit / spill / reload / speculative-rollback cycles with the
    two-tier identity checked after each, then a drain to empty. Returns
    everything observable."""
    rng = np.random.RandomState(seed)
    pager = Pager(n_blocks=9, block_size=4, prefix_sharing=False,
                  host_tier=Tier(host_blocks=16, prefetch_distance=2,
                                 rotate_quantum=4))
    resident, suspended, seen = [], [], []
    for _ in range(cycles):
        op = rng.randint(4)
        if op == 0:
            prompt = rng.randint(1, 50, size=rng.randint(2, 9))
            t = pager.try_admit(prompt.tolist(), len(prompt) + 4)
            seen.append(None if t is None else list(t.blocks))
            if t is not None:
                resident.append([t, len(prompt)])
        elif op == 1 and resident:
            t, wl = resident.pop(rng.randint(len(resident)))
            rec = pager.evict_table_to_host(t, wl)
            seen.append(None if rec is None else (rec.spilled, rec.n_blocks))
            if rec is None:
                resident.append([t, wl])
            else:
                suspended.append([t, rec, wl])
        elif op == 2 and suspended:
            t, rec, wl = suspended.pop(rng.randint(len(suspended)))
            moves = pager.reload_table_from_host(t, rec)
            seen.append(moves)
            if moves is None:
                suspended.append([t, rec, wl])
            else:
                assert [j for j, _ in moves] == rec.spilled
                resident.append([t, wl])
        elif op == 3 and resident:
            i = rng.randint(len(resident))
            t, wl = resident[i]
            if wl >= 2:
                keep = int(rng.randint(1, wl))
                seen.append(pager.rollback(t, keep, wl))
                resident[i][1] = keep
        pager.check_two_tier()
    for t, _ in resident:
        pager.release(t)
    for t, rec, _ in suspended:
        assert pager.reload_table_from_host(t, rec) is not None
        pager.release(t)
    pager.check_two_tier()
    return seen, pager.stats()


def test_two_tier_pager_same_ids_and_counters_as_jax():
    port, pstats = _two_tier_script(KVPager, HostTierConfig)
    ref, jstats = _two_tier_script(JPager, JTier)
    assert port == ref and pstats == jstats
    ht = pstats["host_tier"]
    assert ht["host_evictions"] > 5 and ht["host_reloads"] > 5
    assert ht["host_evictions"] == ht["host_reloads"]
    assert ht["host_blocks_used"] == 0 and pstats["blocks_used"] == 0


def test_spill_refused_when_host_tier_full_and_needs_a_host_tier():
    pager = KVPager(n_blocks=9, block_size=4, prefix_sharing=False,
                    host_tier=HostTierConfig(host_blocks=1))
    t = pager.try_admit([1, 2, 3, 4, 5, 6, 7, 8], 10)
    assert pager.evict_table_to_host(t, 8) is None     # needs 2 > 1
    pager.check_two_tier()
    pager.release(t)
    plain = KVPager(n_blocks=9, block_size=4, prefix_sharing=False)
    t = plain.try_admit([1, 2, 3], 5)
    with pytest.raises(InvalidArgumentError, match="without a host tier"):
        plain.evict_table_to_host(t, 3)
    plain.release(t)
    with pytest.raises(InvalidArgumentError, match="HostTierConfig"):
        KVPager(5, 4, host_tier=object())


# -- the two-tier engine against the JAX package's --------------------------


def _prompts(seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, DIMS["vocab"], size=rng.randint(3, 9)).tolist()
            for _ in range(n)]


def _drive(eng, prompts, max_new=6):
    reqs = [eng.submit(list(p), max_new=max_new) for p in prompts]
    eng.run_until_idle(max_ticks=6000)
    assert all(r.done for r in reqs)
    return [list(r.tokens) for r in reqs]


def _engines(params, n_blocks, tier_kw, **kw):
    jscope = pt.Scope()
    for n, a in params.items():
        jscope.set_var(n, jnp.asarray(a))
    jeng = JPaged(n_slots=6, block_size=4, n_blocks=n_blocks, scope=jscope,
                  host_tier=JTier(**tier_kw), **kw, **DIMS)
    teng = PagedKVEngine(
        n_slots=6, block_size=4, n_blocks=n_blocks, place=CPU,
        scope=ptt.load_numpy_params(params, ptt.Scope(), CPU),
        host_tier=HostTierConfig(**tier_kw), **kw, **DIMS)
    return jeng, teng


TIER = dict(host_blocks=32, prefetch_distance=2, rotate_quantum=4)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_two_tier_engine_matches_jax(params, kv_quant):
    """Token for token, with the same evictions and reloads, an exact
    byte census and the two-tier identity; and the port's device-only
    engine (a pool that never spills) gives the same tokens."""
    prompts = _prompts(3, 8)
    jeng, teng = _engines(params, 9, TIER, kv_quant=kv_quant)
    want, got = _drive(jeng, prompts), _drive(teng, prompts)
    assert got == want
    js, ts = jeng.pager.stats()["host_tier"], teng.pager.stats()["host_tier"]
    assert ts["host_evictions"] > 0
    assert (ts["host_evictions"], ts["host_reloads"]) == \
        (js["host_evictions"], js["host_reloads"])
    per = teng._ht_per_block_bytes
    assert teng.ht_d2h_bytes == ts["host_evictions"] * per
    assert teng.ht_h2d_bytes == ts["host_reloads"] * per
    # a block slot holds every pool's rows: k and v (and their scales)
    nh, bs, dh = DIMS["num_heads"], 4, DIMS["d_model"] // DIMS["num_heads"]
    row = nh * bs * (dh + 4) if kv_quant else nh * bs * dh * 4
    assert per == 2 * DIMS["num_layers"] * row
    teng.pager.check_two_tier()
    assert teng.pager.host_blocks_used == 0 and not teng._ht_queue
    # every pinned slot went back once its copies completed
    assert teng._ht_slab.n_free == TIER["host_blocks"]
    assert ofl.shared_host_pool().used_bytes("kv") == 0
    assert teng.stats()["offload"]["d2h_bytes"] == teng.ht_d2h_bytes
    dev = PagedKVEngine(
        n_slots=6, block_size=4, place=CPU, kv_quant=kv_quant,
        scope=ptt.load_numpy_params(params, ptt.Scope(), CPU), **DIMS)
    assert _drive(dev, prompts) == got


def test_two_tier_engine_frees_what_it_staged(params):
    """After a run that spilled and reloaded, no transfer ticket the
    engine still holds keeps a staged tensor, and deleting the engine
    frees it and its pools: nothing process-wide (the shared stream, the
    host pool, the registries) keeps them."""
    import gc
    import weakref
    teng = PagedKVEngine(
        n_slots=6, block_size=4, n_blocks=9, place=CPU,
        scope=ptt.load_numpy_params(params, ptt.Scope(), CPU),
        host_tier=HostTierConfig(**TIER), **DIMS)
    _drive(teng, _prompts(3, 8))
    assert teng.pager.host_reloads > 0
    assert all(t is None or t.result is None
               for t, _ in teng._ht_pending_free)
    refs = [weakref.ref(teng)] + [weakref.ref(teng.scope.get(n))
                                  for n in teng.cache_names]
    del teng
    gc.collect()
    assert all(r() is None for r in refs)
    assert ofl.shared_host_pool().used_bytes("kv") == 0


def test_two_tier_engine_without_rotation_matches_jax(params):
    """rotate_quantum=0: suspended requests resume only as residents
    finish (no spills); same tokens and admissions as the JAX engine."""
    tier = dict(host_blocks=8, prefetch_distance=1, rotate_quantum=0)
    prompts = _prompts(5, 6)
    jeng, teng = _engines(params, 9, tier)
    assert _drive(teng, prompts) == _drive(jeng, prompts)
    assert teng.pager.host_evictions == jeng.pager.host_evictions == 0
    assert teng.n_ticks == jeng.n_ticks


def test_two_tier_admits_past_the_device_pool(params):
    """The device pool holds two of these requests; the host tier admits
    all six at once (suspended), and the gauges count them."""
    teng = PagedKVEngine(
        n_slots=6, block_size=4, n_blocks=9, place=CPU,
        scope=ptt.load_numpy_params(params, ptt.Scope(), CPU),
        host_tier=HostTierConfig(**TIER), **DIMS)
    for p in _prompts(3, 6):
        teng.submit(p, max_new=6)
    teng.step()
    assert teng.n_active == 6 and teng.n_pending == 0
    text = teng.metrics_registry.expose()
    assert "ptpu_engine_suspended_requests" in text
    assert "ptpu_engine_host_blocks_used" in text
    teng.run_until_idle(max_ticks=6000)
    assert teng.n_active == 0


def test_speculative_with_host_tier_is_guarded():
    with pytest.raises(InvalidArgumentError,
                       match="does not compose with speculative"):
        PagedKVEngine(n_slots=6, block_size=4, n_blocks=9, place=CPU,
                      host_tier=HostTierConfig(**TIER),
                      speculative=SpecConfig(gamma=3), **DIMS)
    with pytest.raises(InvalidArgumentError, match="HostTierConfig"):
        PagedKVEngine(n_slots=2, block_size=4, place=CPU,
                      host_tier=object(), **DIMS)
