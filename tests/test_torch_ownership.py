"""The port's ownership model (framework/ownership.py) and shadow-state
sanitizer (serving/sanitizer.py) against the JAX package's.

Every case runs the same operations through both packages and must end
in the same diagnostic code (or none): the abstract model's named
preconditions, the model checker's coverage and its seeded mutations,
the sanitizer's seeded runtime bugs and tamper checks, and a
differential fuzz with the same shadow statistics. The one deliberate
difference is the h2d-commit gate: the port's sanitizer asks that the
commit be ORDERED after the transfer ticket (`wait_on(compute_stream)`
issued), not that the ticket be complete on the host — on a card a
correctly ordered commit may still be in flight.
"""

import types

import numpy as np
import pytest

from paddle_tpu.core import flags as jflags
from paddle_tpu.framework import ownership as jown
from paddle_tpu.framework.offload import HostTierConfig as JTier
from paddle_tpu.serving import sanitizer as jsan
from paddle_tpu.serving.kv_pager import KVPager as JPager

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.core.enforce import InvalidArgumentError
from paddle_tpu_torch.framework import offload as tofl
from paddle_tpu_torch.framework import ownership as town
from paddle_tpu_torch.serving import sanitizer as tsan
from paddle_tpu_torch.serving.kv_pager import KVPager as TPager

from tests.port_env import port_jax_compile_cache  # noqa: F401

JAX = types.SimpleNamespace(own=jown, san=jsan, Pager=JPager, Tier=JTier)
PORT = types.SimpleNamespace(own=town, san=tsan, Pager=TPager,
                             Tier=tofl.HostTierConfig)


@pytest.fixture(autouse=True)
def sanitize_on():
    """Both packages' kill switches ON (tests/conftest.py pins them
    through PTPU_KV_SANITIZE=1; this file holds standalone too)."""
    prev = (jflags.get_flag("kv_sanitize"), tflags.get_flag("kv_sanitize"))
    jflags.set_flag("kv_sanitize", True)
    tflags.set_flag("kv_sanitize", True)
    yield
    jflags.set_flag("kv_sanitize", prev[0])
    tflags.set_flag("kv_sanitize", prev[1])


def _pager(pkg, n_blocks=9, block_size=4, host_blocks=None, **kw):
    tier = (pkg.Tier(host_blocks=host_blocks)
            if host_blocks is not None else None)
    p = pkg.Pager(n_blocks=n_blocks, block_size=block_size, host_tier=tier,
                  **kw)
    assert p.sanitizer is not None
    return p


def _code(fn, pkg):
    """The diagnostic code `fn(pkg)` raises (None if it returns)."""
    try:
        fn(pkg)
    except pkg.own.OwnershipViolation as e:
        return e.code
    return None


def _both(fn):
    return _code(fn, PORT), _code(fn, JAX)


# -- the abstract model -----------------------------------------------------


def _roundtrip(pkg):
    st = pkg.own.AbstractState(n_blocks=5, block_size=2)
    assert st.admit(0, prompt_len=3, need_len=5)
    for _ in range(5):
        st.write(0)
    st.check_invariants()
    st.release_table(0)
    st.check_invariants()
    assert len(st.index_chain) == 1 and sum(st.ref) == 1


def _double_release(pkg):
    st = pkg.own.AbstractState(n_blocks=5, block_size=2)
    st.alloc_at(1)
    st.release(1)
    st.release(1)


def _share_freed(pkg):
    pkg.own.AbstractState(n_blocks=5, block_size=2).share(2)


def _write_shared(pkg):
    st = pkg.own.AbstractState(n_blocks=7, block_size=2)
    assert st.admit(0, prompt_len=3, need_len=4)
    for _ in range(4):
        st.write(0)
    assert st.fork(0, 1)
    st.note_write(st.tables[1].blocks, 0)


def _double_spill(pkg):
    st = pkg.own.AbstractState(n_blocks=5, block_size=2, host_blocks=4)
    assert st.admit(0, prompt_len=3, need_len=5)
    for _ in range(4):
        st.write(0)
    assert st.spill(0)
    st.check_invariants()
    assert st.host_used == 2
    st.spill(0)


def _spill_reload(pkg):
    st = pkg.own.AbstractState(n_blocks=5, block_size=2, host_blocks=4)
    assert st.admit(0, prompt_len=3, need_len=5)
    for _ in range(4):
        st.write(0)
    assert st.spill(0) and st.reload(0)
    st.release_table(0)
    st.check_invariants()
    assert st.host_used == 0


def _commit_unordered(pkg):
    st = pkg.own.AbstractState(n_blocks=5, block_size=2, host_blocks=4)
    assert st.admit(0, prompt_len=3, need_len=5)
    for _ in range(4):
        st.write(0)
    assert st.spill(0)
    st.reload(0, wait=False)


MODEL_CASES = {
    "roundtrip": (_roundtrip, None),
    "double_release": (_double_release, "kv-double-free"),
    "share_freed": (_share_freed, "kv-use-after-free"),
    "write_shared": (_write_shared, "kv-write-shared-block"),
    "double_spill": (_double_spill, "kv-double-spill"),
    "spill_reload": (_spill_reload, None),
    "commit_unordered": (_commit_unordered, "kv-prefetch-after-use"),
}


@pytest.mark.parametrize("case", sorted(MODEL_CASES))
def test_model_gives_the_jax_codes(case):
    fn, want = MODEL_CASES[case]
    assert _both(fn) == (want, want)


def test_diagnostics_and_mutations_are_the_jax_catalog():
    assert town.DIAGNOSTICS == jown.DIAGNOSTICS
    assert town.MUTATIONS == jown.MUTATIONS


def test_checker_clean_with_the_jax_coverage():
    port, ref = town.ModelChecker().run(), jown.ModelChecker().run()
    assert port.ok and ref.ok
    assert (port.states_explored, port.transitions) == \
        (ref.states_explored, ref.transitions) == (233, 676)


@pytest.mark.parametrize("mutation", sorted(jown.MUTATIONS))
def test_checker_catches_each_mutation_by_the_jax_code(mutation):
    port = town.ModelChecker(mutation=mutation).run()
    ref = jown.ModelChecker(mutation=mutation).run()
    assert not port.ok and port.codes() == ref.codes()
    assert town.MUTATIONS[mutation] in port.codes()


# -- the sanitizer: seeded runtime bugs and tamper ---------------------------


def _leaked_release(pkg):
    pager = _pager(pkg, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4, 5], 8)
    t.blocks[-1] = 0                     # one mapping dropped
    pager.release(t)


def _tick_write_shared(pkg):
    pager = _pager(pkg, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4, 5], 8)
    child = pager.fork(t, 8, copy_block=lambda s, d: None)
    pager.sanitizer.note_write(child, 0)


def _pool_double_release(pkg):
    pager = _pager(pkg, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4, 5], 8)
    pager.pool.release(t.blocks[-1])
    pager.pool.release(t.blocks[-1])


def _refcount_tamper(pkg):
    pager = _pager(pkg, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4], 6)
    pager.pool._ref[t.blocks[0]] += 1
    pager.sanitizer.verify_full("tamper")


def _free_list_tamper(pkg):
    pager = _pager(pkg, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4], 6)
    pager.pool._free.append(t.blocks[0])
    pager.sanitizer.verify_full("tamper")


def _table_maps_freed(pkg):
    pager = _pager(pkg, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4], 6)
    pager.pool.release(t.blocks[0])
    pager.sanitizer.verify_full("census")


def _host_ledger_tamper(pkg):
    pager = _pager(pkg, host_blocks=8, prefix_sharing=False)
    pager.host_blocks_used += 1
    pager.sanitizer.verify_full("tamper")


def _double_spill_real(pkg):
    pager = _pager(pkg, host_blocks=8, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4, 5], 8)
    assert pager.evict_table_to_host(t, 5) is not None
    ledger = pager.host_blocks_used
    try:
        pager.evict_table_to_host(t, 5)
    finally:
        assert pager.host_blocks_used == ledger    # no double charge
        pager.check_two_tier()


def _unadmitted_write(pkg):
    pager = _pager(pkg, prefix_sharing=False)
    t = pager.try_admit([1, 2, 3, 4], 6)
    pager.release(t)
    pager.sanitizer.note_write(t, 0)


SANITIZER_CASES = {
    "leaked_release": (_leaked_release, "kv-block-leak"),
    "tick_write_shared": (_tick_write_shared, "kv-write-shared-block"),
    "pool_double_release": (_pool_double_release, "kv-double-free"),
    "refcount_tamper": (_refcount_tamper, "kv-accounting-identity"),
    "free_list_tamper": (_free_list_tamper, "kv-free-refcount"),
    "table_maps_freed": (_table_maps_freed, "kv-use-after-free"),
    "host_ledger_tamper": (_host_ledger_tamper, "kv-host-accounting"),
    "double_spill": (_double_spill_real, "kv-double-spill"),
    "unadmitted_write": (_unadmitted_write, "kv-use-after-free"),
}


@pytest.mark.parametrize("case", sorted(SANITIZER_CASES))
def test_sanitizer_gives_the_jax_codes(case):
    fn, want = SANITIZER_CASES[case]
    assert _both(fn) == (want, want)
    with pytest.raises(tsan.SanitizerDivergence):
        fn(PORT)


# -- the h2d-commit gate: ordered, not complete -----------------------------


def test_commit_without_wait_on_is_prefetch_after_use():
    """A ticket no consumer ordered itself after: the commit raises
    `kv-prefetch-after-use`, whether or not the copy has finished."""
    pager = _pager(PORT, host_blocks=8, prefix_sharing=False)
    stream = tofl.TransferStream(ptt.CPUPlace())
    ticket = stream.submit("h2d", lambda: "rows", 4)
    assert ticket.done() and not ticket.ordered
    with pytest.raises(tsan.SanitizerDivergence) as e:
        pager.sanitizer.note_h2d_commit(ticket)
    assert e.value.code == "kv-prefetch-after-use"
    assert ticket.wait_on(None) == "rows" and ticket.ordered
    pager.sanitizer.note_h2d_commit(ticket)           # ordered: passes


def test_commit_ordered_while_in_flight_passes():
    """On a card the compute stream waits on the copy's event: the copy
    may still be in flight when the commit is enqueued. The JAX package's
    gate would raise here; the port's does not."""
    pager = _pager(PORT, host_blocks=8, prefix_sharing=False)
    ticket = tofl.TransferTicket("h2d", 4, "prefetch")

    class InFlight:                      # an event the card has not reached
        def query(self):
            return False

    ticket.event = InFlight()
    assert not ticket.done()
    with pytest.raises(InvalidArgumentError, match="consuming stream"):
        ticket.wait_on(None)
    ticket.ordered = True                # what wait_on(stream) records
    pager.sanitizer.note_h2d_commit(ticket)
    jpager = _pager(JAX, host_blocks=8, prefix_sharing=False)
    with pytest.raises(jsan.SanitizerDivergence, match="in flight"):
        jpager.sanitizer.note_h2d_commit(ticket)


# -- differential fuzz: the same traffic, the same shadow --------------------


def _fuzz(pkg, n_ops, seed, host_blocks=16):
    """Random admit / write / spill / reload / rollback / release traffic
    with the full census after every op (as tests/test_ownership.py)."""
    pager = _pager(pkg, n_blocks=9, block_size=4, host_blocks=host_blocks,
                   prefix_sharing=False)
    rng = np.random.RandomState(seed)
    san, bs = pager.sanitizer, pager.block_size
    resident, suspended, trace = [], [], []
    for _ in range(n_ops):
        op = rng.randint(6)
        if op == 0:
            prompt = rng.randint(1, 50, size=rng.randint(2, 9)).tolist()
            t = pager.try_admit(prompt, len(prompt) + 4)
            if t is not None:
                resident.append([t, len(prompt)])
                trace.append(list(t.blocks))
        elif op == 1 and resident:
            i = rng.randint(len(resident))
            t, wl = resident[i]
            if wl < len(t.blocks) * bs:
                san.note_write(t, wl)
                resident[i][1] = wl + 1
        elif op == 2 and resident:
            t, wl = resident.pop(rng.randint(len(resident)))
            rec = pager.evict_table_to_host(t, wl)
            if rec is None:
                resident.append([t, wl])
            else:
                suspended.append([t, rec, wl])
                trace.append(rec.spilled)
        elif op == 3 and suspended:
            t, rec, wl = suspended.pop(rng.randint(len(suspended)))
            moves = pager.reload_table_from_host(t, rec)
            trace.append(moves)
            if moves is None:
                suspended.append([t, rec, wl])
            else:
                resident.append([t, wl])
        elif op == 4 and resident:
            i = rng.randint(len(resident))
            t, wl = resident[i]
            if wl >= 2:
                keep = int(rng.randint(1, wl))
                trace.append(pager.rollback(t, keep, wl))
                resident[i][1] = keep
        elif op == 5 and len(resident) > 2:
            t, _ = resident.pop(rng.randint(len(resident)))
            pager.release(t)
            pager.refund_host_charge(0)
        san.verify_full("fuzz")
        pager.check_two_tier()
    for t, _ in resident:
        pager.release(t)
    for t, rec, _ in suspended:
        assert pager.reload_table_from_host(t, rec) is not None
        pager.release(t)
    san.verify_full("fuzz-drain")
    assert pager.pool.n_used == 0 and pager.host_blocks_used == 0
    return trace, san.stats(), pager.stats()


@pytest.mark.parametrize("seed", [24, 2024])
def test_differential_fuzz_same_as_jax(seed):
    port, ref = _fuzz(PORT, 1500, seed), _fuzz(JAX, 1500, seed)
    assert port == ref
    assert port[1]["ops_mirrored"] >= 1500 and port[1]["tables_live"] == 0


# -- the kill switch --------------------------------------------------------


def test_kvpager_attaches_the_sanitizer_iff_the_flag_is_on():
    on = TPager(n_blocks=9, block_size=4)
    assert isinstance(on.sanitizer, tsan.KVSanitizer)
    assert "alloc" in on.pool.__dict__ and "try_admit" in on.__dict__
    tflags.set_flag("kv_sanitize", False)
    off = TPager(n_blocks=9, block_size=4)
    assert off.sanitizer is None
    # nothing is wrapped: the class attributes resolve
    assert "alloc" not in off.pool.__dict__
    assert "try_admit" not in off.__dict__
