"""Host-offload substrate: the pinned host pool and the transfer stream
that make host RAM a second memory tier for the paged KV cache.

≙ paddle_tpu/framework/offload.py, the parts the two-tier pager uses
(`PagedKVEngine(host_tier=HostTierConfig(...))`, serving/kv_pager.py).
The JAX package models the tier with numpy buffers and a worker thread;
here it is the card's own mechanism:

- **Pinned memory.** `PinnedHostPool` is the ONE ledger of host-tier
  bytes: every allocation or lease credits a category, and the
  `host_*_bytes` watermark channels (observability/memory.py) publish
  it. The KV tier takes its memory from a `HostSlab`: one page-locked
  allocation (`torch.empty(..., pin_memory=True)`) of `host_blocks`
  block slots, made once at engine construction and handed out slot by
  slot — a `cudaHostAlloc` per spill would stall the card. Pinning that
  fails on a CUDA place raises; it never falls back to pageable memory.
- **The transfer stream.** `TransferStream` is a CUDA side stream on the
  engine's device. A job enqueues its copies on it (after an optional
  event of the compute stream) and returns a `TransferTicket` holding a
  CUDA event: `done()` is `event.query()`, `wait()` blocks the HOST
  (for a scheduler decision that needs the bytes), and `wait_on(stream)`
  makes another stream wait for the copy without blocking the host.
  Each job also times its copies with a pair of timing events, the
  source of the d2h/h2d rates (`TransferStream.rates`). The stream
  keeps only those events until they complete, then folds them into
  per-direction byte and second totals: it holds no ticket and no
  tensor a job made.
- **CPU place.** There is no stream: a job's copies run at once and its
  ticket is done at once. That is what the CPU tests see.

The byte census is exact: the stream counts each job's declared bytes,
and the engine declares the bytes it actually moves.

Not ported (ROADMAP.md §1 item 4): `HostOptimizerState` and
`optimizer_roundtrip_events` (ZeRO-1 host-resident optimizer state),
`check_schedule` (the offload schedule lint, which needs the JAX
package's framework/analysis.py), the costs `offload` section and the
memory plan's stash tier.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce

__all__ = [
    "HostTierConfig", "PinnedHostPool", "HostBuffer", "HostLease",
    "HostSlab", "TransferStream", "TransferTicket", "shared_host_pool",
    "shared_stream", "TransferEvent", "prefetch_issue_tick",
    "kv_prefetch_events", "offload_metrics", "offload_stats",
    "reset_offload",
]


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass
class HostTierConfig:
    """Policy knobs for the two-tier paged KV cache.

    host_blocks        capacity of the host tier in KV blocks (the same
                       `block_size`-token pages the device BlockPool
                       holds); the engine pins `host_blocks` block slots
                       of host memory at construction. The pager enforces
                       the two-pool identity used_dev + used_host +
                       free_dev + free_host == total over both tiers.
    prefetch_distance  start the h2d prefetch of a suspended request's
                       spilled blocks when the earliest projected resume
                       is this many ticks away (`prefetch_issue_tick`).
    rotate_quantum     anti-starvation: when a suspended request has
                       waited this many ticks with no capacity, evict the
                       resident request with the most remaining work to
                       host and hand its blocks over. 0 disables rotation
                       (suspended requests resume only when a resident
                       finishes).

    Prefix-sharing radix-index blocks never spill: that is fixed
    behaviour (`KVPager.evict_table_to_host`), not a knob.
    """
    host_blocks: int = 64
    prefetch_distance: int = 2
    rotate_quantum: int = 8

    def __post_init__(self):
        enforce(self.host_blocks >= 1,
                f"HostTierConfig.host_blocks must be >= 1, got "
                f"{self.host_blocks}", exc=InvalidArgumentError)
        enforce(self.prefetch_distance >= 0,
                f"HostTierConfig.prefetch_distance must be >= 0, got "
                f"{self.prefetch_distance}", exc=InvalidArgumentError)
        enforce(self.rotate_quantum >= 0,
                f"HostTierConfig.rotate_quantum must be >= 0, got "
                f"{self.rotate_quantum}", exc=InvalidArgumentError)


# ---------------------------------------------------------------------------
# pinned host pool — the ONE host-byte ledger
# ---------------------------------------------------------------------------

#: ledger category -> watermark channel (observability/memory.CHANNELS)
_CATEGORY_CHANNEL = {
    "kv": "host_kv_bytes",
    "staging": "host_staging_bytes",
    "optimizer": "host_optimizer_bytes",
    "stash": None,
}


class HostBuffer:
    """One pool-owned host allocation: a torch tensor of its own
    (`PinnedHostPool.alloc`) or a set of block slots of a `HostSlab`
    (`HostSlab.alloc`: `tensor` is None, `slots` the slot indices)."""

    __slots__ = ("tensor", "slots", "slab", "category", "nbytes", "_freed")

    def __init__(self, tensor: Optional[torch.Tensor], category: str,
                 nbytes: int, slots: Sequence[int] = (), slab=None):
        self.tensor = tensor
        self.slots = list(slots)
        self.slab = slab
        self.category = category
        self.nbytes = int(nbytes)
        self._freed = False


class HostLease:
    """Accounting-only adoption of host bytes the caller already holds:
    the bytes enter the pool ledger without a copy, and leave on
    `release()` (idempotent)."""

    __slots__ = ("_pool", "nbytes", "category", "_released")

    def __init__(self, pool: "PinnedHostPool", nbytes: int, category: str):
        self._pool = pool
        self.nbytes = int(nbytes)
        self.category = category
        self._released = False

    def release(self):
        if not self._released:
            self._released = True
            self._pool._credit(self.category, -self.nbytes)


class PinnedHostPool:
    """The host-tier byte ledger + allocator. Every consumer of host RAM
    as a memory tier allocates (or leases) through here, so the
    `host_*_bytes` watermark channels and /healthz report from one
    accounting source. `capacity_bytes == 0` means unbounded (the KV
    tier bounds itself in blocks via HostTierConfig)."""

    def __init__(self, capacity_bytes: int = 0):
        enforce(capacity_bytes >= 0,
                f"PinnedHostPool capacity_bytes must be >= 0, got "
                f"{capacity_bytes}", exc=InvalidArgumentError)
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._used: Dict[str, int] = {c: 0 for c in _CATEGORY_CHANNEL}
        self._peak_total = 0

    # -- accounting core ----------------------------------------------------

    def _credit(self, category: str, delta: int):
        enforce(category in _CATEGORY_CHANNEL,
                f"unknown host-pool category {category!r}; known: "
                f"{sorted(_CATEGORY_CHANNEL)}", exc=InvalidArgumentError)
        with self._lock:
            nv = self._used[category] + int(delta)
            enforce(nv >= 0,
                    f"host pool category {category!r} under-released: "
                    f"{self._used[category]} + {delta} < 0",
                    exc=InvalidArgumentError)
            total = sum(self._used.values()) + int(delta)
            if delta > 0 and self.capacity_bytes:
                enforce(total <= self.capacity_bytes,
                        f"host pool over capacity: {total} > "
                        f"{self.capacity_bytes} allocating {delta} "
                        f"bytes of {category!r}",
                        exc=InvalidArgumentError)
            self._used[category] = nv
            if total > self._peak_total:
                self._peak_total = total
            current = nv
        channel = _CATEGORY_CHANNEL[category]
        if channel is not None:
            from ..observability import memory as _memory
            _memory.update_watermark(channel, current)

    # -- allocation ---------------------------------------------------------

    def alloc(self, shape, dtype, category: str) -> HostBuffer:
        """A pool-owned host tensor of its own (pageable: the KV tier's
        pinned memory comes from `slab`); the ledger moves before the
        caller sees it."""
        enforce(category in _CATEGORY_CHANNEL,
                f"unknown host-pool category {category!r}; known: "
                f"{sorted(_CATEGORY_CHANNEL)}", exc=InvalidArgumentError)
        tdtype = (torch.from_numpy(np.empty(0, dtype)).dtype
                  if not isinstance(dtype, torch.dtype) else dtype)
        t = torch.empty(tuple(shape), dtype=tdtype)
        nbytes = t.numel() * t.element_size()
        self._credit(category, nbytes)
        return HostBuffer(t, category, nbytes)

    def slab(self, n_slots: int, slot_nbytes: int, category: str,
             pin: bool) -> "HostSlab":
        """One host allocation of `n_slots` slots of `slot_nbytes` bytes,
        page-locked when `pin` (a failed pin raises). Slots handed out
        from it are charged to `category` in this ledger."""
        return HostSlab(self, n_slots, slot_nbytes, category, pin)

    def free(self, buf: HostBuffer):
        if buf._freed:
            return
        buf._freed = True
        if buf.slab is not None:
            buf.slab._release(buf.slots)
        self._credit(buf.category, -buf.nbytes)

    def lease(self, nbytes: int, category: str) -> HostLease:
        """Adopt caller-held host bytes into the ledger (no copy)."""
        lease = HostLease(self, nbytes, category)
        self._credit(category, lease.nbytes)
        return lease

    # -- census surface -----------------------------------------------------

    def used_bytes(self, category: Optional[str] = None) -> int:
        with self._lock:
            if category is None:
                return sum(self._used.values())
            return self._used.get(category, 0)

    def rows(self) -> Dict[str, Any]:
        """The host-tier census rows: per-category bytes + total + peak +
        capacity."""
        with self._lock:
            out: Dict[str, Any] = {
                f"host_{c}_bytes": int(v) for c, v in self._used.items()}
            out["host_total_bytes"] = int(sum(self._used.values()))
            out["host_peak_bytes"] = int(self._peak_total)
            out["capacity_bytes"] = int(self.capacity_bytes)
        return out


class HostSlab:
    """`n_slots` fixed-size slots of one host allocation (`tensor`, uint8
    [n_slots, slot_nbytes]; page-locked when pinned), handed out as
    `HostBuffer`s of slot indices. Free slots are kept sorted so a spill
    mostly gets consecutive slots, which its copies coalesce into runs.
    The slab holds its bytes for its lifetime; the ledger counts the
    slots handed out."""

    def __init__(self, pool: PinnedHostPool, n_slots: int,
                 slot_nbytes: int, category: str, pin: bool):
        enforce(n_slots >= 1 and slot_nbytes >= 1,
                f"a host slab needs slots and bytes, got {n_slots} x "
                f"{slot_nbytes}", exc=InvalidArgumentError)
        self.pool = pool
        self.n_slots = int(n_slots)
        self.slot_nbytes = int(slot_nbytes)
        self.category = category
        self.pinned = bool(pin)
        self.tensor = torch.empty((self.n_slots, self.slot_nbytes),
                                  dtype=torch.uint8, pin_memory=self.pinned)
        self._free = list(range(self.n_slots))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> HostBuffer:
        """`n` slots (ascending); raises when the slab has fewer free."""
        enforce(0 < n <= len(self._free),
                f"host slab has {len(self._free)} free slots, {n} asked",
                exc=InvalidArgumentError)
        slots, self._free = self._free[:n], self._free[n:]
        nbytes = n * self.slot_nbytes
        self.pool._credit(self.category, nbytes)
        return HostBuffer(None, self.category, nbytes, slots=slots,
                          slab=self)

    def _release(self, slots: List[int]):
        self._free = sorted(self._free + list(slots))

    def runs(self, slots: Sequence[int]):
        """[(row, slot, length)]: `slots[row:row+length]` are the
        consecutive slots `slot..slot+length-1` — one copy each."""
        out, k = [], 0
        while k < len(slots):
            j = k
            while j + 1 < len(slots) and slots[j + 1] == slots[j] + 1:
                j += 1
            out.append((k, slots[k], j - k + 1))
            k = j + 1
        return out


_shared_pool: Optional[PinnedHostPool] = None
_shared_pool_lock = threading.Lock()


def shared_host_pool() -> PinnedHostPool:
    """The process-wide host-tier ledger; tests reset it via
    `reset_offload()`."""
    global _shared_pool
    with _shared_pool_lock:
        if _shared_pool is None:
            _shared_pool = PinnedHostPool()
        return _shared_pool


# ---------------------------------------------------------------------------
# transfer stream — d2h/h2d copies on a CUDA side stream
# ---------------------------------------------------------------------------


class TransferTicket:
    """Completion handle for one transfer job. On a CUDA place it holds
    the event recorded after the job's copies on the side stream; on the
    CPU the job ran at once. An exception the job raised while enqueuing
    re-raises at `wait()` / `wait_on()` on the caller's thread."""

    __slots__ = ("direction", "nbytes", "tag", "result", "error",
                 "event", "_start", "ordered")

    def __init__(self, direction: str, nbytes: int, tag: str):
        self.direction = direction
        self.nbytes = int(nbytes)
        self.tag = tag
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.event = None           # torch.cuda.Event on a CUDA place
        self._start = None          # timing event before the copies
        #: a consumer ordered itself after this transfer (wait_on or
        #: wait) — what the sanitizer's h2d-commit gate checks
        self.ordered = False

    def done(self) -> bool:
        """True once the copies completed (a CUDA event query; no
        block)."""
        return self.event is None or self.event.query()

    def wait(self, timeout: Optional[float] = None):
        """Block the HOST until the copies completed, then return the
        job's result (or raise its error). For scheduler decisions that
        need the bytes on the host side; a consumer on the card uses
        `wait_on`."""
        if self.event is not None:
            deadline = None if timeout is None else \
                time.perf_counter() + timeout
            while not self.event.query():
                enforce(deadline is None or time.perf_counter() < deadline,
                        f"offload transfer {self.direction}/{self.tag} "
                        f"did not complete within {timeout}s",
                        exc=TimeoutError)
                time.sleep(5e-5)
        if self.error is not None:
            raise self.error
        self.ordered = True
        return self.result

    def wait_on(self, stream=None):
        """Make `stream` (a CUDA stream; None on the CPU) wait for the
        copies — `stream.wait_event`, no host block — and return the
        job's result (or raise its error)."""
        if self.error is not None:
            raise self.error
        if self.event is not None:
            enforce(stream is not None,
                    "wait_on a CUDA transfer needs the consuming stream",
                    exc=InvalidArgumentError)
            stream.wait_event(self.event)
        self.ordered = True
        return self.result

    def elapsed_s(self) -> Optional[float]:
        """Seconds the copies took on the side stream (timing events),
        once done; None on the CPU or before completion."""
        if self._start is None or not self.done():
            return None
        return self._start.elapsed_time(self.event) / 1e3


class TransferStream:
    """The transfer stream of one device. On a CUDA place, a side stream:
    `submit` runs the job's copy enqueues under it (after the side stream
    waits on `after`, an event of the compute stream, when given) and
    returns the ticket holding the completion event. On the CPU, jobs run
    at once. Each submit is an `offload` span (host enqueue time) and
    lands on the exact byte census (`counters()`).

    `place` defaults to CUDAPlace(0) and raises without a card."""

    def __init__(self, place=None):
        from ..core.places import resolve_device
        self.device = resolve_device(place)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._counters = {"d2h_bytes": 0, "h2d_bytes": 0,
                          "d2h_jobs": 0, "h2d_jobs": 0}
        #: (direction, bytes, start event, end event) of the jobs whose
        #: copies may still run (CUDA), oldest first; `_fold_timed`
        #: moves completed ones into `_timed_totals`
        self._timed: "deque[tuple]" = deque()
        self._timed_totals = {d: {"bytes": 0, "seconds": 0.0}
                              for d in ("d2h", "h2d")}

    def submit(self, direction: str, fn: Callable[[], Any], nbytes: int,
               tag: str = "", after=None) -> TransferTicket:
        enforce(direction in ("d2h", "h2d"),
                f"transfer direction must be 'd2h' or 'h2d', got "
                f"{direction!r}", exc=InvalidArgumentError)
        from ..observability import tracing as _tracing
        t = TransferTicket(direction, nbytes, tag)
        with _tracing.span("offload", f"offload/{direction}",
                           bytes=int(nbytes), tag=tag):
            if self.stream is None:
                try:
                    t.result = fn()
                except Exception as e:      # surfaces at ticket.wait()
                    t.error = e
            else:
                with torch.cuda.stream(self.stream):
                    if after is not None:
                        self.stream.wait_event(after)
                    t._start = torch.cuda.Event(enable_timing=True)
                    t._start.record(self.stream)
                    try:
                        t.result = fn()
                    except Exception as e:  # surfaces at ticket.wait()
                        t.error = e
                    t.event = torch.cuda.Event(enable_timing=True)
                    t.event.record(self.stream)
        with self._lock:
            self._counters[f"{direction}_bytes"] += t.nbytes
            self._counters[f"{direction}_jobs"] += 1
            if t.event is not None and t.error is None:
                self._timed.append((direction, t.nbytes, t._start,
                                    t.event))
            self._fold_timed()
        _note_bytes(direction, t.nbytes)
        return t

    def empty(self, shape, dtype) -> torch.Tensor:
        """A device tensor for a job's copies to fill. On a CUDA place it
        is allocated under the side stream, so the caching allocator
        hands it memory no pending compute-stream work still uses (a
        consumer on another stream must `record_stream` it). Allocate
        before `submit`: the ticket's timing events then cover the
        copies only."""
        if self.stream is None:
            return torch.empty(shape, dtype=dtype, device=self.device)
        with torch.cuda.stream(self.stream):
            return torch.empty(shape, dtype=dtype, device=self.device)

    def drain(self):
        """Block until every submitted copy completed."""
        if self.stream is not None:
            self.stream.synchronize()

    def counters(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._counters)

    def _fold_timed(self):
        """Move the completed jobs' bytes and copy time into the totals
        (under `_lock`). The jobs' events complete in submission order
        (one stream), so the first pending one that has not ends the
        sweep."""
        while self._timed and self._timed[0][3].query():
            direction, nbytes, start, end = self._timed.popleft()
            tot = self._timed_totals[direction]
            tot["bytes"] += nbytes
            tot["seconds"] += start.elapsed_time(end) / 1e3

    def rates(self) -> Dict[str, Dict[str, float]]:
        """{direction: {bytes, seconds, gb_per_s}} over the completed
        jobs (CUDA only; the side stream's own timing events)."""
        with self._lock:
            self._fold_timed()
            out = {d: dict(r) for d, r in self._timed_totals.items()}
        for r in out.values():
            r["gb_per_s"] = (r["bytes"] / r["seconds"] / 1e9
                             if r["seconds"] > 0 else None)
        return out


_shared_streams: Dict[Any, TransferStream] = {}
_shared_stream_lock = threading.Lock()


def shared_stream(place=None) -> TransferStream:
    """The process-wide transfer stream of `place`'s device (one per
    device: KV spills and reloads serialize on it the way one copy
    engine would). `place` defaults to CUDAPlace(0)."""
    from ..core.places import resolve_device
    device = resolve_device(place)
    with _shared_stream_lock:
        s = _shared_streams.get(device)
        if s is None:
            s = _shared_streams[device] = TransferStream(place)
        return s


# ---------------------------------------------------------------------------
# global offload stats -> ptpu_offload_* gauges
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_stats = {"evictions_total": 0, "prefetch_hits_total": 0,
          "prefetch_misses_total": 0, "d2h_bytes_total": 0,
          "h2d_bytes_total": 0}
_gauges = None


def note_eviction(n_blocks: int = 1):
    with _stats_lock:
        _stats["evictions_total"] += int(n_blocks)


def note_prefetch(hit: bool):
    with _stats_lock:
        _stats["prefetch_hits_total" if hit
               else "prefetch_misses_total"] += 1


def _note_bytes(direction: str, nbytes: int):
    with _stats_lock:
        _stats[f"{direction}_bytes_total"] += int(nbytes)


def offload_stats() -> Dict[str, int]:
    with _stats_lock:
        return dict(_stats)


def offload_metrics():
    """The `ptpu_offload_*` series, registered (idempotently) into
    `metrics.default_registry()` next to `ptpu_memory_*`."""
    global _gauges
    if _gauges is None:
        from ..observability import metrics as m
        r = m.default_registry()
        helps = {
            "evictions_total": "KV blocks evicted device -> host "
                               "(two-tier pager).",
            "prefetch_hits_total": "Suspended-request resumes whose h2d "
                                   "prefetch had already landed.",
            "prefetch_misses_total": "Resumes that had to wait on the "
                                     "h2d transfer (prefetch too late "
                                     "or never issued).",
            "d2h_bytes_total": "Bytes moved device -> host by the "
                               "offload transfer stream.",
            "h2d_bytes_total": "Bytes moved host -> device by the "
                               "offload transfer stream.",
        }
        _gauges = {
            k: m.get_or_create(r, "gauge", f"ptpu_offload_{k}", h,
                               fn=(lambda k=k: _stats[k]))
            for k, h in helps.items()}
    return _gauges


def reset_offload():
    """Test isolation: zero the stats and replace the shared pool."""
    global _shared_pool
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0
    with _shared_pool_lock:
        _shared_pool = PinnedHostPool()


# ---------------------------------------------------------------------------
# transfer schedules — the policy surface
# ---------------------------------------------------------------------------


@dataclass
class TransferEvent:
    """One planned tier move in tick time: issued at `issue_tick`, data
    resident by `arrive_tick`, first consumed at `read_tick`. The
    invariant: arrival before-or-at the read."""
    var: str
    direction: str            # "d2h" | "h2d"
    issue_tick: int
    arrive_tick: int
    read_tick: int


def prefetch_issue_tick(read_tick: int, prefetch_distance: int) -> int:
    """When to start the h2d prefetch of blocks scheduled to be read at
    `read_tick` — the one policy helper the two-tier engine executes."""
    return int(read_tick) - int(prefetch_distance)


def kv_prefetch_events(read_ticks: Dict[str, int],
                       prefetch_distance: int) -> List[TransferEvent]:
    """The two-tier KV prefetch schedule for suspended requests whose
    projected resume ticks are `read_ticks` ({request -> tick})."""
    out = []
    for var, read in sorted(read_ticks.items()):
        issue = prefetch_issue_tick(read, prefetch_distance)
        out.append(TransferEvent(var=var, direction="h2d",
                                 issue_tick=issue, arrive_tick=read,
                                 read_tick=read))
    return out
