"""Simulated multi-process world: N in-process ranks over one filesystem.

≙ paddle_tpu/parallel/process_world.py, copied as logic. The
chief-commits checkpoint barrier (parallel/elastic.py) is a protocol over
processes, and what it needs from the runtime is small:

- **ranks**: N participants with stable integer identities, one of which
  is the chief; `ProcessWorld` runs the same per-rank protocol function
  on one thread per rank (real concurrency: stragglers, reordered acks
  and deadline races are real, not mocked);
- **rank-private staging directories** (`.tmp-<serial>-rank<r>`);
- **a message channel**: per-rank inboxes with blocking receive and a
  deadline — the ack / commit / abort control plane;
- **per-rank fault injection**: `PTPU_FAULT_INJECT` carries world-aware
  directives that kill, drop or delay exactly one rank at exactly one
  protocol phase:

      crash_rank:<r>@<phase>[@<offset>]   SIGKILL of the hosting process
                                          the moment rank r reaches
                                          <phase>; with <offset> (stage
                                          phase only) the rank's staged
                                          payload is first truncated at
                                          that byte offset
      drop_rank:<r>@<phase>               simulated death: rank r stops
                                          at <phase> (no ack is ever
                                          sent) while the rest of the
                                          world runs on
      straggle_rank:<r>@<phase>@<secs>    rank r sleeps <secs> at <phase>

The protocol phases, in order (`PHASES`):

      stage    rank writes + fsyncs its shard container/manifest
      ack      staged files are durable; digest manifest not yet sent
      barrier  chief collected the LAST ack; nothing renamed yet
      commit   staging renamed into place; COMMIT marker not yet written
      post     COMMIT marker durable

The port's ranks are processes (one per card), so beside the simulated
world this module has `StoreWorld`: the same surface for THIS process's
rank of a joined torch.distributed world, its messages riding the
world's c10d store (elastic.py uses it for a multi-writer save when the
executor's mesh spans several processes).
"""

from __future__ import annotations

import os
import queue
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import flags
from ..core.enforce import InvalidArgumentError, enforce

#: protocol phases a fault directive may name, in protocol order
PHASES = ("stage", "ack", "barrier", "commit", "post")

#: world-aware PTPU_FAULT_INJECT directives (parsed here, not by
#: elastic.fault_injection_config — their values are structured, not floats)
WORLD_DIRECTIVES = ("crash_rank", "drop_rank", "straggle_rank")


class RankDead(BaseException):
    """Simulated death of one rank (drop_rank): unwinds the rank's
    thread without running any more of its protocol. BaseException so a
    protocol-level `except Exception` cannot accidentally resurrect a
    dead rank."""

    def __init__(self, rank: int, phase: str):
        super().__init__(f"rank {rank} dropped at phase {phase!r}")
        self.rank = rank
        self.phase = phase


def _parse_world_directive(name: str, val: str) -> Tuple[int, str, Optional[float]]:
    """`<rank>@<phase>[@<number>]` — shared shape of all three world
    directives."""
    parts = val.split("@")
    enforce(2 <= len(parts) <= 3,
            f"PTPU_FAULT_INJECT {name} wants <rank>@<phase>[@<value>], "
            f"got {val!r}", exc=InvalidArgumentError)
    enforce(parts[1] in PHASES,
            f"PTPU_FAULT_INJECT {name}: unknown phase {parts[1]!r} "
            f"(one of {PHASES})", exc=InvalidArgumentError)
    try:
        rank = int(parts[0])
        extra = float(parts[2]) if len(parts) == 3 else None
    except ValueError as e:
        raise InvalidArgumentError(
            f"PTPU_FAULT_INJECT {name}: {val!r} — rank must be an "
            f"integer and the trailing value a number "
            f"(<rank>@<phase>[@<value>])") from e
    return rank, parts[1], extra


def world_fault_plan(raw: Optional[str] = None) -> Dict[str, Dict[int, tuple]]:
    """Parse the world-aware directives out of PTPU_FAULT_INJECT.

    Returns {"crash": {rank: (phase, offset|None)},
             "drop":  {rank: (phase, None)},
             "straggle": {rank: (phase, seconds)}}.
    Non-world directives (crash_at_step, crash_mid_save, slow_writer) are
    ignored here — elastic.fault_injection_config owns those."""
    if raw is None:
        raw = os.environ.get("PTPU_FAULT_INJECT", "")
    plan: Dict[str, Dict[int, tuple]] = {"crash": {}, "drop": {},
                                         "straggle": {}}
    for part in raw.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        name, val = part.split(":", 1)
        if name not in WORLD_DIRECTIVES:
            continue
        rank, phase, extra = _parse_world_directive(name, val)
        if name == "crash_rank":
            plan["crash"][rank] = (phase, extra)
        elif name == "drop_rank":
            plan["drop"][rank] = (phase, None)
        else:
            enforce(extra is not None,
                    "PTPU_FAULT_INJECT straggle_rank wants "
                    "<rank>@<phase>@<seconds>", exc=InvalidArgumentError)
            plan["straggle"][rank] = (phase, extra)
    return plan


def _sigkill_self():  # pragma: no cover - the process dies here
    os.kill(os.getpid(), signal.SIGKILL)


def _truncate_payload_at(dirname: str, offset: int):
    """The shared crash-offset accounting
    (sharded_checkpoint.truncate_payload_at, also behind elastic's
    crash_mid_save); an offset beyond the payload leaves the files
    whole — the kill still happens at the phase boundary."""
    from ..sharded_checkpoint import truncate_payload_at
    truncate_payload_at(dirname, offset)


class ProcessWorld:
    """N simulated ranks with per-rank inboxes and fault hooks.

    One instance models one gang of training processes. The barrier
    protocol (elastic.py) is written against exactly this surface:

        world.send(src, dst, kind, **payload)
        msg = world.recv(rank, timeout=...)      # None on timeout
        world.fault(rank, phase, staging=...)    # fault-injection point
        results = world.run(fn)                  # fn(rank) on every rank

    `run` executes `fn` on one thread per LIVE rank and returns the
    per-rank results (`None` for a dropped/failed rank, with the
    exception kept in `world.failures`). Ranks dropped by a fault stay
    dead for the lifetime of the world — a later `run` (the next
    snapshot attempt) proceeds without them, exactly like a real gang
    missing one process."""

    #: monotone world ids within a process (two worlds in one test must
    #: not merge their trace lanes)
    _ID_SEQ = __import__("itertools").count(1)

    def __init__(self, world_size: int, chief: int = 0):
        enforce(world_size >= 1, "world_size must be >= 1",
                exc=InvalidArgumentError)
        enforce(0 <= chief < world_size,
                f"chief rank {chief} outside world of {world_size}",
                exc=InvalidArgumentError)
        self.world_size = world_size
        self.chief = chief
        #: stable identity stamped (with rank/world_size) onto every
        #: span a rank thread records — the {world_id, rank, world_size}
        #: triple paddle_tpu_torch/tools/trace_merge.py lanes the merged
        #: timeline by
        self.world_id = f"pw{os.getpid()}-{next(self._ID_SEQ)}"
        #: serializes barrier rounds over this world (elastic.py): two
        #: concurrent rounds would steal each other's acks off the
        #: chief's inbox
        self.barrier_lock = threading.Lock()
        self._inboxes: List[queue.Queue] = [queue.Queue()
                                            for _ in range(world_size)]
        #: ranks that died (drop_rank or an exception escaping fn)
        self.dead: set = set()
        #: rank -> exception from the last run()
        self.failures: Dict[int, BaseException] = {}
        self._fault_plan = None

    # -- membership -------------------------------------------------------
    def is_chief(self, rank: int) -> bool:
        return rank == self.chief

    def live_ranks(self) -> List[int]:
        return [r for r in range(self.world_size) if r not in self.dead]

    # -- message channel --------------------------------------------------
    def send(self, src: int, dst: int, kind: str, **payload):
        """Enqueue a message into dst's inbox. Sends from/to dead ranks
        are dropped silently — a real dead process neither sends nor
        receives, and the protocol must survive that, not error on it."""
        if src in self.dead or dst in self.dead:
            return
        self._inboxes[dst].put({"kind": kind, "src": src, **payload})

    def recv(self, rank: int, timeout: Optional[float] = None
             ) -> Optional[Dict[str, Any]]:
        """Blocking receive with deadline; returns None on timeout (the
        barrier's straggler branch) — never raises."""
        try:
            return self._inboxes[rank].get(timeout=timeout)
        except queue.Empty:
            return None

    def drain(self, rank: int):
        """Discard every queued message for `rank` (a fresh protocol
        round must not consume a stale ack from an aborted one)."""
        try:
            while True:
                self._inboxes[rank].get_nowait()
        except queue.Empty:
            pass

    # -- fault injection --------------------------------------------------
    def fault(self, rank: int, phase: str,
              staging: Optional[str] = None,
              serial: Optional[int] = None):
        """The per-rank fault-injection point; protocol code calls this
        at every phase boundary. Reads PTPU_FAULT_INJECT fresh per call
        (tests flip it between runs). Every call is ALSO a flight-
        recorder beacon point: the phase note (rank, phase, serial) is
        durable before any directive fires, so a SIGKILL here leaves a
        beacon naming exactly the dead rank and phase
        (observability/flight_recorder.py)."""
        from ..observability import flight_recorder as _fr
        _fr.note_phase("barrier", phase, rank=rank, serial=serial)
        plan = world_fault_plan()
        hit = plan["straggle"].get(rank)
        if hit and hit[0] == phase:
            flags.vlog(1, "fault injection: rank %d straggling %.2fs at "
                       "%s", rank, hit[1], phase)
            time.sleep(hit[1])
        hit = plan["drop"].get(rank)
        if hit and hit[0] == phase:
            flags.vlog(0, "fault injection: rank %d dropped at %s",
                       rank, phase)
            _fr.note_phase("barrier", phase, rank=rank, serial=serial,
                           dropped=True)
            raise RankDead(rank, phase)
        hit = plan["crash"].get(rank)
        if hit and hit[0] == phase:
            offset = hit[1]
            if phase == "stage" and offset is not None and staging:
                _truncate_payload_at(staging, int(offset))
            flags.vlog(0, "fault injection: SIGKILL at rank %d phase %s",
                       rank, phase)
            _fr.note_phase("barrier", phase, rank=rank, serial=serial,
                           crashing=True)
            _sigkill_self()  # pragma: no cover

    # -- execution --------------------------------------------------------
    def run(self, fn: Callable[[int], Any],
            timeout: Optional[float] = None) -> List[Any]:
        """Run `fn(rank)` on one thread per live rank; join; return the
        per-rank result list (None for dead/failed ranks). A RankDead
        raised inside fn marks the rank dead and is NOT re-raised (the
        world continues); any other exception is recorded in
        `self.failures` and re-raised from run() after every thread
        joined — a protocol bug must fail the caller, not vanish into a
        thread."""
        from ..observability import flight_recorder as _fr
        from ..observability import tracing as _tracing
        results: List[Any] = [None] * self.world_size
        self.failures = {}

        def _guard(r: int):
            # every span this rank's thread records carries the
            # {world_id, rank, world_size} triple — the per-rank span
            # stream the merged timeline lanes by
            with _tracing.rank_scope(self.world_id, r, self.world_size):
                try:
                    results[r] = fn(r)
                except RankDead as e:
                    self.dead.add(r)
                    _fr.dump_dossier(
                        f"rank {r} dropped at phase {e.phase!r}",
                        rank=r, exc=e)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    self.failures[r] = e
                    _fr.dump_dossier(f"rank {r} protocol failure",
                                     rank=r, exc=e)

        threads = [threading.Thread(target=_guard, args=(r,),
                                    name=f"world-rank-{r}", daemon=True)
                   for r in self.live_ranks()]
        for t in threads:
            t.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            enforce(not t.is_alive(),
                    f"ProcessWorld.run: {t.name} did not finish within "
                    f"{timeout}s — protocol deadlock?",
                    exc=InvalidArgumentError)
        if self.failures:
            r = min(self.failures)
            raise self.failures[r]
        return results

    def __repr__(self):
        return (f"ProcessWorld(world_size={self.world_size}, "
                f"chief={self.chief}, dead={sorted(self.dead)})")


class StoreWorld(ProcessWorld):
    """THIS process's rank of a joined torch.distributed world, with
    `ProcessWorld`'s surface: the world is the ranks of a mesh (`ranks`,
    global rank numbers; world rank i is `ranks[i]`, the chief is world
    rank 0), and messages ride the world's c10d store under keys that
    `tag` makes unique to one protocol round. Every rank of the round
    builds its StoreWorld with the same `ranks` and `tag`.

    `run(fn)` runs fn on this process's rank only (the others run theirs
    in their own processes) and returns a per-rank list holding this
    rank's result. A rank dropped by `drop_rank` is dead for this
    process; the other processes learn it only as a missing message, as
    with a real death."""

    POLL_S = 0.005

    def __init__(self, store, ranks, rank: int, tag: str):
        ranks = [int(r) for r in ranks]
        enforce(int(rank) in ranks,
                f"rank {rank} is not in the world's ranks {ranks}",
                exc=InvalidArgumentError)
        super().__init__(len(ranks), chief=0)
        self.store = store
        self.ranks = ranks
        self.rank = ranks.index(int(rank))
        self.world_id = f"sw-{tag}"
        self._prefix = f"ptpu_world/{tag}"
        self._consumed = 0

    def _count_key(self, dst: int) -> str:
        return f"{self._prefix}/to{dst}/n"

    def send(self, src: int, dst: int, kind: str, **payload):
        if src in self.dead or dst in self.dead:
            return
        import json
        seq = self.store.add(self._count_key(dst), 1)
        self.store.set(f"{self._prefix}/to{dst}/{seq}",
                       json.dumps({"kind": kind, "src": src, **payload}))

    def recv(self, rank: int, timeout: Optional[float] = None
             ) -> Optional[Dict[str, Any]]:
        import json
        enforce(rank == self.rank,
                f"rank {self.rank} cannot receive rank {rank}'s messages",
                exc=InvalidArgumentError)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.store.add(self._count_key(rank), 0) > self._consumed:
                self._consumed += 1
                raw = self.store.get(f"{self._prefix}/to{rank}/"
                                     f"{self._consumed}")
                return json.loads(raw)
            if deadline is not None and time.monotonic() >= deadline:
                return None
            time.sleep(self.POLL_S)

    def drain(self, rank: int):
        if rank == self.rank:
            self._consumed = self.store.add(self._count_key(rank), 0)

    def agree(self, name: str, make: Callable[[], Any]) -> Any:
        """A value every rank of the round shares: the chief computes
        `make()`, the others read it (blocking up to the store's
        timeout)."""
        import json
        key = f"{self._prefix}/agree/{name}"
        if self.is_chief(self.rank):
            value = make()
            self.store.set(key, json.dumps(value))
            return value
        return json.loads(self.store.get(key))

    def live_ranks(self) -> List[int]:
        return [self.rank] if self.rank not in self.dead else []

    def run(self, fn: Callable[[int], Any],
            timeout: Optional[float] = None) -> List[Any]:
        from ..observability import flight_recorder as _fr
        from ..observability import tracing as _tracing
        results: List[Any] = [None] * self.world_size
        self.failures = {}
        r = self.rank
        if r in self.dead:
            return results
        with _tracing.rank_scope(self.world_id, r, self.world_size):
            try:
                results[r] = fn(r)
            except RankDead as e:
                self.dead.add(r)
                _fr.dump_dossier(f"rank {r} dropped at phase {e.phase!r}",
                                 rank=r, exc=e)
            except BaseException as e:
                self.failures[r] = e
                _fr.dump_dossier(f"rank {r} protocol failure", rank=r,
                                 exc=e)
                raise
        return results

    def __repr__(self):
        return (f"StoreWorld(ranks={self.ranks}, rank={self.rank}, "
                f"dead={sorted(self.dead)})")
