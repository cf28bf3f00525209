"""Structured step tracing: typed, nested spans in a lock-cheap ring.

≙ paddle_tpu/observability/tracing.py (a copy: the module is pure Python).
The one span recorder of the port:

- `span(kind, name, **attrs)` — a context manager recording a typed,
  NESTED interval (parent/depth come from a per-thread stack) with
  provenance attributes;
- recording appends into a preallocated ring buffer; the only shared
  mutation on the hot path is one `itertools.count()` draw (atomic under
  the GIL) plus a slot store, so concurrent threads never contend on a
  lock;
- kill switch `PTPU_TRACE=0` (core flag `trace`) makes `__enter__`/
  `__exit__` near-free;
- `export_chrome_trace()` / `aggregate()` turn the ring into the Chrome
  (catapult) timeline and the per-span summary tables.

Span kinds are CLOSED (SPAN_KINDS): a typo'd kind raises instead of
minting a new category that no aggregation ever finds. Spans time the
HOST: a span around work that launches CUDA kernels measures the enqueue,
not the device's execution, unless the work ends in a synchronization.

`scoped_tags(**tags)` stamps its tags onto every span the thread records
while it is open (`current_tags()` reads them); `force_enable(True)`
records spans with the flag down until the matching force_enable(False).

`annotation_factory` is the profiler hook: while it is set, each live
span also enters the object it returns (a profiler range; the port's
profiler.py sets it). `rank_scope` is the tag triple of a multi-process
world: ParallelExecutor's ranks record their spans under it.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..core import flags
from ..core.enforce import InvalidArgumentError, enforce

SPAN_KINDS = frozenset({
    "compile",     # executor trace+XLA-compile of a program
    "trace",       # program -> jaxpr tracing sub-phases (region runners)
    "step",        # one executor.run / run_steps dispatch
    "tick",        # one serving-engine decode tick
    "collective",  # host-side collective setup (placement, reconcile)
    "feed_fetch",  # feed placement / fetch realization & write-back
    "admission",   # serving-engine request admission
    "pp_tick",     # pipeline schedule construction / tick tables
    "dp_comm",     # explicit gradient-comm rewrite planning
    "pass",        # any registered Pass application (provenance = name)
    "checkpoint",  # elastic snapshot/restore phases (parallel/elastic.py)
    "request",     # one serving request's lifecycle phases (queue_wait/
                   # prefill/decode/transport, serving/engine.py)
    "memory",      # memory watermark sample (record_counter; rendered as
                   # a Chrome COUNTER track, observability/memory.py)
    "dispatch",    # host-side argument assembly + write-back around the
                   # compiled tick fn (serving engine zero-dispatch path)
    "speculate",   # one speculative round's draft-model propose phase
                   # (γ+1 bound draft ticks, serving/speculative.py)
    "verify",      # the round's single target verify forward over the
                   # γ+1-wide window (serving/speculative.py)
    "offload",     # one host-tier transfer job on the offload stream
                   # (d2h spill / h2d prefetch, framework/offload.py)
    "user",        # RecordEvent-style user annotation
})


class Span:
    """One completed interval. Slots only — the ring holds up to
    `trace_ring` of these."""

    __slots__ = ("kind", "name", "start", "end", "thread_id", "parent",
                 "depth", "attrs", "seq")

    def __init__(self, kind, name, start, end, thread_id, parent, depth,
                 attrs, seq):
        self.kind = kind
        self.name = name
        self.start = start
        self.end = end
        self.thread_id = thread_id
        self.parent = parent       # enclosing span's name ('' at top level)
        self.depth = depth
        self.attrs = attrs
        self.seq = seq

    @property
    def duration_ms(self) -> float:
        return (self.end - self.start) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "duration_ms": round(self.duration_ms, 6),
                "parent": self.parent, "depth": self.depth,
                "thread_id": self.thread_id, "attrs": self.attrs}


# ring storage: preallocated slot list + monotone counter. next(_seq) is
# atomic under the GIL; each writer owns its slot exclusively, so no lock
# is taken on the record path.
_ring: List[Optional[Span]] = []
_ring_cap = 0
_seq = itertools.count()
_resize_lock = threading.Lock()

# per-thread nesting stack: (name, depth), and the thread's tag dict
# (scoped_tags), merged into every span the thread records
_tls = threading.local()


class scoped_tags:
    """Tag every span recorded by THIS thread while the scope is open:

        with tracing.scoped_tags(world="w1", rank=2, world_size=4):
            ...   # every span (and record_span) carries these attrs

    Scopes nest (inner tags shadow outer ones of the same key, the rest
    merge); a span's own attrs win over thread tags."""

    __slots__ = ("tags", "_prev")

    def __init__(self, **tags):
        self.tags = tags

    def __enter__(self):
        self._prev = getattr(_tls, "tags", None)
        merged = dict(self._prev) if self._prev else {}
        merged.update(self.tags)
        _tls.tags = merged
        return self

    def __exit__(self, *exc):
        _tls.tags = self._prev
        return False


def rank_scope(world: str, rank: int, world_size: int) -> scoped_tags:
    """The distributed-tracing tag triple: every span this thread records
    is attributed to (world, rank) — ParallelExecutor's ranks tag their
    spans with it."""
    return scoped_tags(world=str(world), rank=int(rank),
                       world_size=int(world_size))


def current_tags() -> Dict[str, Any]:
    """This thread's active scoped_tags (empty dict outside any scope)."""
    tags = getattr(_tls, "tags", None)
    return dict(tags) if tags else {}


# profiler interop: the count of open force_enable(True) calls (spans then
# record with the trace flag down), and an optional device-annotation
# factory, set while a profiler's device trace runs
_force_count = 0
annotation_factory: Optional[Callable[[str], Any]] = None


def _ensure_ring():
    global _ring, _ring_cap
    raw = flags.get_flag("trace_ring")
    try:
        cap = int(raw)
    except (TypeError, ValueError):
        raise InvalidArgumentError(
            f"PTPU_TRACE_RING (flag trace_ring) must be a positive "
            f"integer span-ring capacity, got {raw!r}") from None
    if cap < 1:   # no eager f-string on the record hot path
        raise InvalidArgumentError(
            f"PTPU_TRACE_RING (flag trace_ring) must be >= 1 (the span "
            f"ring needs at least one slot), got {cap}")
    if cap != _ring_cap:
        with _resize_lock:
            if cap != _ring_cap:
                _ring = [None] * cap
                _ring_cap = cap
    return _ring


# the flag SPEC object is stable across set_flag calls (set_flag mutates
# .value in place) — holding it dodges a registry lookup per span on the
# hot path
_TRACE_FLAG = flags._REGISTRY["trace"]


def enabled() -> bool:
    return bool(_TRACE_FLAG.value) or _force_count > 0


def force_enable(on: bool):
    """For a profiler: while it is open (force_enable(True) ...
    force_enable(False), nesting), spans record whatever the PTPU_TRACE
    flag says."""
    global _force_count
    _force_count = max(0, _force_count + (1 if on else -1))


def mark() -> int:
    """Current ring position — pass to spans_since() to read only spans
    recorded after this point (the profiler window / bench breakdowns)."""
    _ensure_ring()
    # peek without consuming: count() has no peek, so mint-and-remember
    # would skip a slot. Track via a sacrificial draw is wrong; instead
    # the mark is the NEXT sequence number, derived from a draw we then
    # hand to no span — acceptable: one empty slot per mark.
    return next(_seq)


def _record(span: Span):
    # index with the CAPTURED ring's own length: a concurrent trace_ring
    # resize swaps _ring/_ring_cap as a pair, and mixing the old list
    # with the new cap would IndexError out of span.__exit__ on an
    # instrumented hot path
    ring = _ensure_ring()
    ring[span.seq % len(ring)] = span


class span:
    """RAII span scope. Usage:

        with span("pass", "tp_shard_pass", tp=2):
            ...

    Attributes must be JSON-serializable scalars/strings (op_loc output,
    config ints) — they land in the Chrome trace `args` and the ledger.
    When disabled, enter/exit touch one module global and return.
    """

    __slots__ = ("kind", "name", "attrs", "_start", "_parent", "_depth",
                 "_annotation", "_live")

    def __init__(self, kind: str, name: Optional[str] = None, **attrs):
        if kind not in SPAN_KINDS:   # no eager f-string on the hot path
            raise InvalidArgumentError(
                f"unknown span kind {kind!r}; known: "
                f"{sorted(SPAN_KINDS)}")
        self.kind = kind
        self.name = name or kind
        self.attrs = attrs
        self._start = None
        self._annotation = None
        self._live = False

    def __enter__(self):
        if not (_TRACE_FLAG.value or _force_count):
            return self
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self._parent = stack[-1][0] if stack else ""
        self._depth = len(stack)
        stack.append((self.name, self._depth))
        self._live = True
        if annotation_factory is not None:
            try:
                self._annotation = annotation_factory(self.name)
                self._annotation.__enter__()
            except Exception:
                self._annotation = None
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self._live:
            return False
        end = time.perf_counter()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
            self._annotation = None
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1][0] == self.name:
            stack.pop()
        tags = getattr(_tls, "tags", None)
        attrs = {**tags, **self.attrs} if tags else self.attrs
        _record(Span(self.kind, self.name, self._start, end,
                     threading.get_ident(), self._parent, self._depth,
                     attrs, next(_seq)))
        self._live = False
        return False


def record_span(kind: str, name: str, start: float, end: float,
                **attrs) -> Optional[Span]:
    """Record a RETROACTIVE span from externally measured perf_counter
    timestamps — phases whose boundaries were observed as plain floats
    (a request's queue-wait between submit and slot assignment, a
    barrier phase reconstructed from beacon notes) become first-class
    spans on the same timeline the live `span` scopes draw on; returns
    None when tracing is disabled."""
    if kind not in SPAN_KINDS:
        raise InvalidArgumentError(
            f"unknown span kind {kind!r}; known: {sorted(SPAN_KINDS)}")
    if not (_TRACE_FLAG.value or _force_count):
        return None
    tags = getattr(_tls, "tags", None)
    if tags:
        attrs = {**tags, **attrs}
    s = Span(kind, name, float(start), float(end),
             threading.get_ident(), "", 0, attrs, next(_seq))
    _record(s)
    return s


def record_counter(name: str, value: float, **attrs) -> Optional[Span]:
    """Record one SAMPLE on the `memory` channel: a zero-duration span
    whose `value` attr is the sampled level (a watermark's current bytes,
    an MFU reading). Samples ride the same ring as interval spans — one
    counter draw, no lock — and `chrome_trace_events` renders them as
    Chrome COUNTER events (`ph: "C"`), i.e. a plotted track per sample
    name, so memory levels read as a line under the span lanes; returns
    None when tracing is disabled."""
    if not (_TRACE_FLAG.value or _force_count):
        return None
    now = time.perf_counter()
    tags = getattr(_tls, "tags", None)
    attrs = ({**tags, "value": float(value), **attrs} if tags
             else {"value": float(value), **attrs})
    s = Span("memory", name, now, now, threading.get_ident(), "", 0,
             attrs, next(_seq))
    _record(s)
    return s


def clear():
    """Drop every recorded span (test isolation)."""
    global _ring, _seq
    with _resize_lock:
        _ring = [None] * max(_ring_cap, 1)
        _seq = itertools.count()


def spans(since: Optional[int] = None) -> List[Span]:
    """All live spans in record order; `since` (a mark()) filters to spans
    recorded after that point."""
    out = [s for s in _ring if s is not None]
    out.sort(key=lambda s: s.seq)
    if since is not None:
        out = [s for s in out if s.seq >= since]
    return out


def spans_since(mark_value: int) -> List[Span]:
    return spans(since=mark_value)


def aggregate(span_list: Optional[List[Span]] = None,
              by: str = "name") -> Dict[str, Dict]:
    """Per-span summary table: {key: {calls, total_ms, max_ms, min_ms,
    avg_ms, kind}} — the profiler report and the benchmark span_ms rows
    both read this. `by` is 'name' or 'kind'."""
    enforce(by in ("name", "kind"), f"aggregate by {by!r}?",
            exc=InvalidArgumentError)
    rows: Dict[str, Dict] = {}
    for s in (spans() if span_list is None else span_list):
        key = s.name if by == "name" else s.kind
        r = rows.get(key)
        d = s.duration_ms
        if r is None:
            rows[key] = {"kind": s.kind, "calls": 1, "total_ms": d,
                         "max_ms": d, "min_ms": d}
        else:
            r["calls"] += 1
            r["total_ms"] += d
            r["max_ms"] = max(r["max_ms"], d)
            r["min_ms"] = min(r["min_ms"], d)
    for r in rows.values():
        r["avg_ms"] = r["total_ms"] / r["calls"]
    return rows


def chrome_trace_events(span_list: Optional[List[Span]] = None,
                        pid: int = 0) -> List[Dict]:
    """Spans as Chrome (catapult) complete events; nesting renders from
    the overlapping ts/dur intervals per thread lane."""
    evs = []
    for s in (spans() if span_list is None else span_list):
        if s.kind == "memory":
            # counter sample -> Chrome COUNTER event: args values are
            # plotted as a track named after the sample
            evs.append({
                "name": s.name, "cat": s.kind, "ph": "C",
                "ts": s.start * 1e6, "pid": pid, "tid": s.thread_id,
                "args": dict(s.attrs),
            })
            continue
        evs.append({
            "name": s.name, "cat": s.kind, "ph": "X",
            "ts": s.start * 1e6, "dur": (s.end - s.start) * 1e6,
            "pid": pid, "tid": s.thread_id,
            "args": {**s.attrs, "parent": s.parent, "depth": s.depth},
        })
    return evs


def export_chrome_trace(path: str,
                        span_list: Optional[List[Span]] = None) -> str:
    """Write the ring (or a filtered list) as ONE Chrome trace JSON."""
    trace = {"traceEvents": chrome_trace_events(span_list),
             "displayTimeUnit": "ms"}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def span_overhead_s(n: int = 2000) -> float:
    """Measured per-span enter/exit cost IN THE CURRENT enabled state —
    the number an overhead budget multiplies by spans per step. Best of
    3 windows so a scheduler blip does not skew it."""
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            with span("user", "overhead_probe"):
                pass
        dt = (time.perf_counter() - t0) / n
        best = dt if best is None else min(best, dt)
    return best
