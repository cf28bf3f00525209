"""The paged KV engine of the port against the JAX package's.

Small model (vocab 64, d_model 32, d_inner 64, 4 heads, 2 layers, blocks
of 4 positions, 3 slots, a span of 32). Weights come from the JAX
package's startup program and carry across by name with
`load_numpy_params`; both packages run float32 (use_bf16_matmul off), so
greedy tokens must be equal, not near. The pager itself is pure host
logic: the same operation sequence must give the same block ids, refcounts
and counters in both packages. Both packages' pagers run with their
shadow-state sanitizers (tests/conftest.py sets PTPU_KV_SANITIZE=1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.core import flags as jflags
from paddle_tpu.framework import registry as jreg
from paddle_tpu.serving import BlockPool as JPool
from paddle_tpu.serving import KVPager as JPager
from paddle_tpu.serving import PagedKVEngine as JPaged
from paddle_tpu.serving import RadixPrefixIndex as JIndex
from paddle_tpu.serving import paged_beam_search as jbeam

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.serving import (BlockPool, KVPager, PagedKVEngine,
                                      RadixPrefixIndex, paged_beam_search)

from tests.port_env import port_jax_compile_cache  # noqa: F401

DIMS = dict(vocab=64, max_len=32, d_model=32, d_inner=64, num_heads=4,
            num_layers=2)
PREFIX = [2, 7, 1, 9, 4, 8, 5, 6]           # two full 4-token blocks
PROMPTS = [[7, 8, 9], [7, 8, 9], [1, 2, 3, 4, 5, 6], PREFIX + [3],
           PREFIX + [11, 12], [30, 31, 32, 33, 34, 35, 36, 37, 38, 39]]
CPU = ptt.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_port_state():
    saved = {n: (jflags.get_flag(n), tflags.get_flag(n))
             for n in ("use_bf16_matmul",)}
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield
    for n, (jv, tv) in saved.items():
        jflags.set_flag(n, jv)
        tflags.set_flag(n, tv)


@pytest.fixture(scope="module")
def float32_mode():
    """Both packages in float32 while the module's fixtures build; the
    flags are restored when the module ends (a module fixture is set up
    before the per-test fixture saves them)."""
    saved = (jflags.get_flag("use_bf16_matmul"),
             tflags.get_flag("use_bf16_matmul"))
    jflags.set_flag("use_bf16_matmul", False)
    tflags.set_flag("use_bf16_matmul", False)
    yield
    jflags.set_flag("use_bf16_matmul", saved[0])
    tflags.set_flag("use_bf16_matmul", saved[1])


@pytest.fixture(scope="module")
def params(float32_mode):
    """The JAX package's initial weights for DIMS, as numpy."""
    jscope = pt.Scope()
    eng = JPaged(n_slots=3, block_size=4, scope=jscope, **DIMS)
    return {p.name: np.asarray(jscope.get(p.name))
            for p in eng._program.all_parameters()}


def _jax_engine(params, **kw):
    scope = pt.Scope()
    for n, a in params.items():
        scope.set_var(n, jnp.asarray(a))
    return JPaged(n_slots=3, block_size=4, scope=scope, **kw, **DIMS)


def _port_engine(params, **kw):
    scope = ptt.load_numpy_params(params, ptt.Scope(), CPU)
    return PagedKVEngine(n_slots=3, block_size=4, scope=scope, place=CPU,
                         **kw, **DIMS)


def _gen(eng, prompts, max_new=6):
    reqs = [eng.submit(list(p), max_new=max_new) for p in prompts]
    eng.run_until_idle()
    assert all(r.done for r in reqs)
    return [list(r.tokens) for r in reqs]


# -- the pager: pure host logic, same ids in both packages ----------------


def _pager_script(Pager):
    """One operation sequence over a pager: admit, share a cached prefix,
    fork (CoW), speculative rollback, release, evict. Returns everything
    observable: tables, refcounts, copies, counters."""
    pager = Pager(12, 4)
    copies = []
    seen = []
    t1 = pager.try_admit(PREFIX + [3], 12)           # 3 blocks
    seen.append(list(t1.blocks))
    for j in range(2):                               # both prefix blocks
        pager.note_block_filled(t1, j, PREFIX + [3])
    t2 = pager.try_admit(PREFIX + [11, 12], 14)      # shares 2 blocks
    seen.append((list(t2.blocks), t2.n_shared, t2.shared_len))
    t3 = pager.fork(t1, 10, lambda s, d: copies.append((s, d)))
    seen.append(list(t3.blocks))
    n_rb = pager.rollback(t2, 9, 14)                 # block 3 fully dead
    seen.append((n_rb, list(t2.blocks)))
    for t in (t1, t3):
        pager.release(t)
    seen.append([pager.pool.refcount(b) for b in range(12)])
    t4 = pager.try_admit([40] * 30, 30)              # needs eviction
    seen.append(None if t4 is None else list(t4.blocks))
    pager.pool.check()
    seen.append(pager.stats())
    return seen, copies


def test_pager_same_block_ids_and_counters_as_jax():
    port, pcopies = _pager_script(KVPager)
    ref, jcopies = _pager_script(JPager)
    assert port == ref
    assert pcopies == jcopies and len(pcopies) == 1


def test_pool_and_index_same_ids_as_jax():
    def script(Pool, Index):
        pool, idx = Pool(10, 4), Index(4)
        b0, b1 = pool.alloc(), pool.alloc()
        ok = [idx.register([1, 2, 3, 4, 5, 6, 7, 8], 0, b0, pool),
              idx.register([1, 2, 3, 4, 5, 6, 7, 8], 1, b1, pool),
              idx.register([9, 9, 9, 9, 5, 5, 5, 5], 1, pool.alloc(), pool)]
        m = [n.block for n in idx.match([1, 2, 3, 4, 5, 6, 7, 8, 0])]
        pool.release(b0)
        pool.release(b1)
        ev = [idx.evict_one(pool), pool.n_used, idx.evict_all(pool),
              pool.n_used]
        pool.check()
        return ok, m, ev, [pool.refcount(b) for b in range(10)]

    assert script(BlockPool, RadixPrefixIndex) == script(JPool, JIndex)


def test_pool_null_block_and_double_free_raise():
    p = BlockPool(3, 2)
    with pytest.raises(InvalidArgumentError):
        p.release(0)
    with pytest.raises(InvalidArgumentError):
        p.share(0)
    b = p.alloc()
    p.release(b)
    with pytest.raises(InvalidArgumentError):
        p.release(b)
    p.check()


def test_rollback_100_cycles_keeps_the_pool_whole():
    """100 admit / fill / rollback / release cycles: used + free ==
    n_blocks - 1 after each, and everything frees at the end."""
    rng = np.random.RandomState(3)
    pager = KVPager(11, 4)
    live = []
    for cycle in range(100):
        prompt = rng.randint(1, 9, rng.randint(2, 9)).tolist()
        t = pager.try_admit(prompt, len(prompt) + 6)
        if t is not None:
            for j in range(len(prompt) // 4):
                pager.note_block_filled(t, j, prompt)
            # a verify window's rejected tail lies past the prompt
            keep = rng.randint(len(prompt), len(prompt) + 3)
            pager.rollback(t, keep, min(keep + 5, 4 * len(t.blocks)))
            live.append(t)
        if live and (len(live) > 1 or t is None):
            pager.release(live.pop(0))
        pool = pager.pool
        pool.check()
        assert pool.n_used + pool.n_free == pool.n_blocks - 1
    for t in live:
        pager.release(t)
    pager.index.evict_all(pager.pool)
    assert pager.pool.n_used == 0 and pager.rolled_back_blocks > 0


# -- the two ops against the JAX registry ---------------------------------


def _both(op_type, ins, attrs):
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, attrs)
    tout = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {k: [torch.from_numpy(a.copy()) for a in v]
                          for k, v in ins.items()}, attrs)
    assert set(jout) == set(tout)
    return {k: np.asarray(jout[k][0]) for k in jout}, \
        {k: tout[k][0].numpy() for k in tout}


@pytest.mark.parametrize("case", ["rows", "window", "null_block_dups"])
def test_paged_cache_write_matches_jax(case):
    rng = np.random.RandomState(1)
    pool = rng.randn(6, 2, 4, 3).astype("float32")
    if case == "rows":
        blocks, offs = np.array([2, 5], "int64"), np.array([1, 3], "int64")
    elif case == "window":     # a verify window: [S, G] targets
        blocks = np.array([[2, 2, 3], [5, 5, 5]], "int64")
        offs = np.array([[2, 3, 0], [0, 1, 2]], "int64")
    else:                      # idle slots all steered at the null block
        blocks, offs = np.array([0, 4, 0], "int64"), np.array([0, 2, 0])
    n = blocks.size
    new = rng.randn(n, 2, 3).astype("float32")
    if case == "null_block_dups":
        new[2] = new[0]        # idle slots write the same (zero-fed) row
    jv, tv = _both("paged_cache_write",
                   {"Cache": [pool], "New": [new], "BlockIds": [blocks],
                    "Offsets": [offs.astype("int64")]}, {})
    np.testing.assert_array_equal(tv["Out"], jv["Out"])


@pytest.mark.parametrize("case", ["random", "zero_rows", "ties"])
def test_paged_cache_write_quant_matches_jax(case):
    rng = np.random.RandomState(2)
    pool = rng.randint(-127, 128, (6, 2, 4, 3)).astype("int8")
    scales = rng.rand(6, 2, 4, 1).astype("float32")
    new = rng.randn(3, 2, 3).astype("float32") * 4
    if case == "zero_rows":
        new[1] = 0.0           # scale 1.0, payload 0: dequantizes exactly
    elif case == "ties":       # x / scale lands on .5: both round to even
        new[0, 0] = np.array([127.0, 0.5, 1.5], "float32")
        new[2, 1] = np.array([-2.5, 127.0, 3.5], "float32")
    blocks, offs = np.array([1, 0, 4], "int64"), np.array([3, 0, 2], "int64")
    jv, tv = _both("paged_cache_write_quant",
                   {"Cache": [pool], "Scales": [scales], "New": [new],
                    "BlockIds": [blocks], "Offsets": [offs]}, {})
    np.testing.assert_array_equal(tv["Out"], jv["Out"])
    np.testing.assert_array_equal(tv["ScalesOut"], jv["ScalesOut"])
    if case == "zero_rows":
        assert (tv["ScalesOut"][0, :, 0] == 1.0).all()


def test_paged_cache_write_is_in_place_on_the_pool_var():
    """The tick writes the persistable pool in place (its output variable
    is its input), and a copy otherwise."""
    from paddle_tpu_torch.framework.program import Program
    block = Program().global_block()
    pool = torch.zeros(4, 2, 2, 3)
    new = torch.ones(1, 2, 3)
    ids = torch.tensor([2])
    for out_name, aliased in (("pool", True), ("other", False)):
        op = block.append_op(
            "paged_cache_write",
            inputs={"Cache": ["pool"], "New": ["n"], "BlockIds": ["b"],
                    "Offsets": ["o"]}, outputs={"Out": [out_name]})
        out = treg.lookup_op("paged_cache_write").lower(
            treg.LowerCtx(op=op), {"Cache": [pool], "New": [new],
                                   "BlockIds": [ids], "Offsets": [ids - 1]},
            {})["Out"][0]
        assert (out is pool) == aliased
        assert float(out[2, :, 1].sum()) == 6.0


# -- the paged tick and engine against the JAX package's -------------------


def test_paged_ticks_program_json_equal():
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu_torch.models import transformer as ttr
    for kw in ({"topk_k": 3}, {"kv_quant": True}):
        progs = []
        for pk, tr in ((pt, jtr), (ptt, ttr)):
            m, s = pk.Program(), pk.Program()
            with pk.program_guard(m, s), pk.unique_name.guard():
                tr.transformer_lm_paged_decode_tick(
                    n_slots=3, n_blocks=9, block_size=4, blocks_per_req=4,
                    cache_prefix="pg", **kw,
                    **{k: v for k, v in DIMS.items() if k != "max_len"})
            progs.append((m.to_json(), s.to_json()))
        assert progs[0] == progs[1], kw


def test_paged_engine_tokens_and_pager_match_jax(params):
    """Six requests, a shared prefix among them: the port's paged engine
    generates the JAX engine's tokens with the same block accounting."""
    jeng, teng = _jax_engine(params), _port_engine(params)
    want, got = _gen(jeng, PROMPTS), _gen(teng, PROMPTS)
    assert got == want
    assert len({t for r in got for t in r}) > 4       # not a degenerate run
    # a second wave over the warm prefix cache hits it in both
    wave = [PREFIX + [11], PREFIX + [12, 13]]
    assert _gen(teng, wave) == _gen(jeng, wave)
    js, ts = jeng.pager.stats(), teng.pager.stats()
    assert ts == js and ts["prefix_hits"] >= 2
    assert teng.n_ticks == jeng.n_ticks
    teng.pager.pool.check()
    # idle: the only live blocks are the index's cached prefixes
    assert teng.pager.pool.n_used == ts["blocks_cached"]


def test_paged_engine_equals_the_slot_engine_and_unshared(params):
    paged = _port_engine(params)
    unshared = _port_engine(params, prefix_sharing=False)
    slot = ptt.ContinuousBatchingEngine(
        n_slots=3, scope=ptt.load_numpy_params(params, ptt.Scope(), CPU),
        place=CPU, **DIMS)
    want = _gen(slot, PROMPTS)
    assert _gen(paged, PROMPTS) == want
    assert _gen(unshared, PROMPTS) == want
    assert unshared.pager.prefix_hits == 0


@pytest.mark.parametrize("sharing", [True, False])
def test_paged_beam_search_matches_jax(params, sharing):
    """Beam 3 over the prompt, after a request that left its prefix
    blocks cached (the shared root skips their prefill): each package's
    beams, scores and CoW copies. (Shared against unshared is not
    asserted: the JAX package's own test of that fails.)"""
    kw = dict(topk_k=3, prefix_sharing=sharing)
    out = []
    for eng in (_jax_engine(params, **kw), _port_engine(params, **kw)):
        _gen(eng, [PREFIX + [3]])
        beams = (jbeam if isinstance(eng, JPaged) else paged_beam_search)(
            eng, PREFIX, max_new=5, beam_size=3)
        eng.pager.pool.check()
        out.append((beams, eng.pager.stats()))
    (jb, js), (tb, ts) = out
    assert [b[0] for b in tb] == [b[0] for b in jb]
    np.testing.assert_allclose([b[1] for b in tb], [b[1] for b in jb],
                               rtol=1e-5)
    assert ts == js and ts["cow_copies"] > 0
    assert tb[0][1] >= tb[-1][1]                        # best first


def test_cow_fork_copies_the_divergence_block_in_place(params):
    eng = _port_engine(params, prefix_sharing=False)
    pager = eng.pager
    t1 = pager.try_admit(list(range(1, 9)), 12)
    name = eng.cache_names[0]
    pool = eng.scope.get(name)
    pool[t1.blocks[1]] = 7.0
    t2 = pager.fork(t1, 6, eng._copy_block)
    assert t2.blocks[0] == t1.blocks[0] and t2.blocks[1] != t1.blocks[1]
    assert eng.scope.get(name) is pool                  # in place
    assert torch.equal(pool[t2.blocks[1]], pool[t1.blocks[1]])
    pool[t2.blocks[1]] = -3.0
    assert float(pool[t1.blocks[1]].min()) == 7.0
    pager.release(t1)
    pager.release(t2)
    pager.pool.check()


def test_head_of_line_waits_for_blocks_and_span_is_named(params):
    eng = PagedKVEngine(n_slots=2, max_len=8, block_size=4, n_blocks=3,
                        prefix_sharing=False, place=CPU,
                        scope=ptt.load_numpy_params(params, ptt.Scope(),
                                                    CPU), **{
                            k: v for k, v in DIMS.items() if k != "max_len"})
    r1 = eng.submit([1, 2, 3, 4], max_new=4)
    r2 = eng.submit([5, 6, 7, 8], max_new=4)
    eng.step()
    assert eng.n_active == 1 and eng.n_pending == 1
    eng.run_until_idle()
    assert len(r1.tokens) == 4 and len(r2.tokens) == 4
    assert eng.pager.pool.n_used == 0
    with pytest.raises(InvalidArgumentError, match="block-table span"):
        eng.submit(list(range(1, 8)), max_new=4)


def test_paged_engine_defaults_to_the_card():
    """Without a card the default place raises instead of dropping to the
    CPU; with one it is CUDAPlace(0)."""
    if torch.cuda.is_available():
        assert ptt.default_place() == ptt.CUDAPlace(0)
        return
    from paddle_tpu_torch.core.enforce import UnavailableError
    with pytest.raises(UnavailableError):
        PagedKVEngine(n_slots=2, block_size=4, **DIMS)
