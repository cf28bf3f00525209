"""Continuous-batching serving engine over the fused decode path.

≙ paddle_tpu/serving/engine.py: requests of different lengths share ONE
decode-tick program through a slot-indexed KV cache, so a new request joins
the in-flight batch the tick a slot frees instead of waiting for a static
batch to drain.

- `transformer_lm_decode_tick` (models/transformer.py) — one decode tick
  over persistable [S,1,nh,T,dh] slot caches with PER-SLOT positions;
  fuse_decode_attention_pass rewrites its attention chains into the fused
  decode-attention kernel (fusion/decode_attention.py).
- `SlotAllocator` — free-list over the S cache rows; alloc on admission,
  free on completion. A reused slot needs NO cache reset: the per-slot
  mask exposes only positions <= the slot's own pos, and prefill rewrites
  rows 0..P-1 before they are ever exposed.
- `ContinuousBatchingEngine` — request queue + scheduler + tick loop.
  Prefill is teacher-forced through the same tick program (the fed token
  is the next prompt token until the prompt is consumed, then the slot's
  previously sampled token). Dispatch rides `Executor.prepare` +
  `PreparedStep.bind`, so the per-tick host work is the feed fill, one
  small host→device copy per feed and the op plan.
- `quant="int8"|"int4"` — weight-only quantized serving:
  `quantize_params_pass` rewrites the tick program's float32 weights into
  block-scaled payloads before the step is prepared (`qmatmul` /
  `qlookup`); `quant_freed_bytes` reports what that frees.
- `speculative=SpecConfig(...)` — speculative decoding
  (serving/speculative.py): a draft proposes γ tokens, one verify forward
  over a γ+1 window scores them, the accepted prefix commits.
- `EngineServer`/`EngineClient` — generation RPC over the transport's
  frames (serving/transport.py, the JAX package's wire format byte for
  byte): the engine thread ticks while reader/writer threads move bytes,
  and completions landing on the same tick go out as one vectored send.
  The server also serves GET /metrics (the engine's `ptpu_engine_*`
  registry joined with the process-wide `ptpu_memory_*`, `ptpu_ckpt_*`
  and `ptpu_train_*` series) and GET /healthz.

Telemetry rides the tick without adding a host sync: the
`admission`/`tick`/`dispatch`/`request` spans (observability/tracing.py)
and the metrics read host clocks and host counters only; the tick's one
device wait is the realization barrier it always had (the next tick's
feed depends on the sampled ids).

The hooks `_build_tick_program`, `_init_tick_feeds`, `_fill_tick_feeds`,
`_admit_request`, `_release_request`, `_note_position_written`,
`_note_tick_writes`, `_pre_tick`, `_stamp_kv_watermarks`, `_init_metrics`
and the speculative ones (`_build_verify_tick`, `_fill_verify_row`,
`_spec_capable`, `_spec_rollback`) are what `PagedKVEngine`
(serving/kv_pager.py) overrides; the scheduler itself is shared.

Scheduling policies:

- "continuous": admit whenever a slot is free — the engine's point.
- "static": admit only when ALL slots are free (form a batch, run it to
  full completion, drain, repeat) — the padded static-batch baseline.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.enforce import InvalidArgumentError, enforce
from ..observability import memory as _obs_memory
from ..observability import metrics as _obs_metrics
from ..observability import tracing as _tracing

# atomic in CPython: concurrent engine construction must not mint the
# same cache namespace (aliased slot caches in a shared scope)
_ENGINE_SEQ = itertools.count(1)


class SlotAllocator:
    """Free-list allocator over the decode batch's S cache rows."""

    def __init__(self, n_slots: int):
        enforce(n_slots >= 1, "need at least one slot",
                exc=InvalidArgumentError)
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))
        self._used = set()

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        s = self._free.pop()
        self._used.add(s)
        return s

    def free(self, slot: int):
        enforce(slot in self._used, f"slot {slot} not allocated",
                exc=InvalidArgumentError)
        self._used.remove(slot)
        self._free.append(slot)

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._used)


class GenRequest:
    """One generation request moving through the engine. Besides the
    wall-clock fields (`submitted_at`, `admitted_at`, `first_token_at`,
    `done_at`, `sent_at`: `time.time()`, kept for API compatibility), each
    lifecycle boundary is stamped on the perf_counter clock — the timeline
    the span ring uses — so the latency decomposes exactly:

        queue_wait = admitted - submitted       (waiting for a slot)
        prefill    = first_token - admitted     (prompt ticks)
        decode     = done - first_token         (sampled-token ticks)
        transport  = sent - done                (completion frame on the
                                                 wire; 0 without a server)

    The four phases partition [submitted, sent]. `request_id` threads
    from EngineClient through admission, every tick's span attrs and the
    completion frame."""

    __slots__ = ("rid", "request_id", "prompt", "max_new", "eos_id",
                 "tokens", "slot", "fed", "next_tok", "submitted_at",
                 "admitted_at", "first_token_at", "done_at", "sent_at",
                 "submitted_pc", "admitted_pc", "first_token_pc", "done_pc",
                 "sent_pc",
                 "defer_transport", "on_done", "table", "shared_len",
                 "spec_draft_s", "spec_verify_s", "_event")

    def __init__(self, rid, prompt, max_new, eos_id=None, on_done=None,
                 request_id: Optional[str] = None,
                 defer_transport: bool = False):
        self.rid = rid
        self.request_id = str(request_id) if request_id is not None \
            else f"req-{rid}"
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.fed = 0                       # positions consumed so far
        self.next_tok = self.prompt[0]     # token the next tick feeds
        self.submitted_at = time.time()
        self.submitted_pc = time.perf_counter()
        self.admitted_at: Optional[float] = None
        self.admitted_pc: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.first_token_pc: Optional[float] = None
        self.done_at: Optional[float] = None
        self.done_pc: Optional[float] = None
        self.sent_at: Optional[float] = None
        self.sent_pc: Optional[float] = None
        #: True when a server owns the transport phase (it calls
        #: engine.report_sent once the completion frame is on the wire,
        #: or at once if the frame cannot be delivered); False: no wire,
        #: transport and e2e close at completion
        self.defer_transport = bool(defer_transport)
        self.on_done = on_done
        #: paged-KV engine state: the request's BlockTable, and how many
        #: leading prompt positions were served from the prefix cache
        #: (prefill starts at `shared_len`). None / 0 on the slot engine.
        self.table = None
        self.shared_len = 0
        #: speculative decoding: wall seconds this request spent in draft
        #: ticks and in verify forwards (sub-phases of prefill + decode)
        self.spec_draft_s = 0.0
        self.spec_verify_s = 0.0
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self.done_pc is not None

    @property
    def latency_s(self) -> Optional[float]:
        return (self.done_pc - self.submitted_pc) if self.done else None

    def phases(self, subphases: bool = False
               ) -> Optional[Dict[str, float]]:
        """{queue_wait, prefill, decode, transport} seconds (transport 0
        until a server reports the completion frame sent); None before
        completion. With `subphases=True`, a request served speculatively
        also reports `spec_draft` and `spec_verify` — sub-phases of the
        prefill+decode window, not added to the partition."""
        if self.done_pc is None:
            return None
        first = self.first_token_pc if self.first_token_pc is not None \
            else self.done_pc
        ph = {"queue_wait": self.admitted_pc - self.submitted_pc,
              "prefill": first - self.admitted_pc,
              "decode": self.done_pc - first,
              "transport": ((self.sent_pc - self.done_pc)
                            if self.sent_pc is not None else 0.0)}
        if subphases:
            ph["spec_draft"] = self.spec_draft_s
            ph["spec_verify"] = self.spec_verify_s
        return ph

    def e2e_s(self) -> Optional[float]:
        """Measured end-to-end latency: submit → completion frame sent
        (→ completion when no server is involved). The number the phase
        decomposition sums to."""
        if self.done_pc is None:
            return None
        end = self.sent_pc if self.sent_pc is not None else self.done_pc
        return end - self.submitted_pc

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done in {timeout}s")
        return self.tokens

    def _complete(self):
        self.done_at = time.time()
        self.done_pc = time.perf_counter()
        if self.on_done is not None:
            self.on_done(self)
        self._event.set()


class ContinuousBatchingEngine:
    """Slot-scheduled decode loop: one tick program, S independent
    sequences in flight, admission the tick a slot frees.

    Weights are shared BY NAME with the scope (load them first, e.g. with
    `io.load_numpy_params`, then hand the same scope here); absent
    parameters are initialized by this engine's own startup program, so a
    fresh engine also runs standalone (random weights — tests, benches).
    With `quant=` the engine's quantize pass erases the float32 weights it
    quantizes from that scope, as the JAX package's does.

    `place` defaults to CUDAPlace(0) and raises when no CUDA card is
    visible; pass CPUPlace() to serve on the CPU.
    """

    def __init__(self, n_slots: int = 8, vocab: int = 32000,
                 max_len: int = 64, d_model: int = 512, d_inner: int = 2048,
                 num_heads: int = 8, num_layers: int = 6,
                 dropout: float = 0.0, packed: bool = False,
                 eos_id: Optional[int] = None, scope=None,
                 policy: str = "continuous",
                 cache_prefix: Optional[str] = None,
                 quant: Optional[str] = None,
                 speculative=None, place=None):
        from ..core import unique_name
        from ..framework.executor import Executor
        from ..framework.program import Program, program_guard
        from ..framework.scope import Scope, global_scope

        enforce(policy in ("continuous", "static"),
                f"unknown scheduling policy {policy!r}",
                exc=InvalidArgumentError)
        enforce(quant in (None, "int8", "int4"),
                f"quant must be None, 'int8' or 'int4', got {quant!r}",
                exc=InvalidArgumentError)
        if cache_prefix is None:
            # per-engine cache namespace: two engines sharing one scope
            # must not alias each other's slot caches
            cache_prefix = f"srv{next(_ENGINE_SEQ)}"
        self.policy = policy
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        #: the model dims + cache namespace, kept for the auxiliary
        #: program builders (the speculative draft and verify ticks match
        #: the main tick's architecture and share its cache names)
        self._cache_prefix = cache_prefix
        self._builder_dims = dict(
            vocab=vocab, d_model=d_model, d_inner=d_inner,
            num_heads=num_heads, num_layers=num_layers, dropout=dropout,
            packed=packed)
        self._slots = SlotAllocator(n_slots)
        self._active: Dict[int, GenRequest] = {}      # slot -> request
        self._pending: "deque[GenRequest]" = deque()
        self._lock = threading.Lock()
        self._rid = 0

        self._program, self._startup = Program(), Program()
        with program_guard(self._program, self._startup), \
                unique_name.guard():
            self._build_tick_program(
                n_slots, vocab, max_len, d_model, d_inner, num_heads,
                num_layers, dropout, packed, cache_prefix)
        self.scope = scope or global_scope()
        self._exe = Executor(place)
        self._init_missing_vars(Scope)
        # speculative decoding (serving/speculative.py): the draft COPIES
        # the target's f32 weights under the reserved `draft_` prefix, so
        # it is built BEFORE the target's quantize pass erases them; its
        # steps bind in `spec.finalize()` after the main step below
        self.spec = None
        if speculative is not None and speculative is not False:
            from .speculative import SpeculativeDecoder
            self.spec = SpeculativeDecoder(self, speculative)
            self.spec.build_draft()
        # weight-only quantized serving: rewrite the tick program's
        # persistable f32 weights into block-scaled (payload, scales)
        # pairs BEFORE the step is prepared. Kill switch
        # PTPU_QUANT_PARAMS=0 serves f32 regardless of `quant`.
        self.quant = None
        self.params_bytes_f32 = self._param_bytes()
        self.params_bytes_quantized = self.params_bytes_f32
        self.quant_freed_bytes = 0
        if quant is not None:
            from ..core import flags as _flags
            if _flags.get_flag("quant_params"):
                from ..framework.passes import get_pass
                get_pass("quantize_params_pass",
                         bits=8 if quant == "int8" else 4)(
                    self._program, self.scope)
                self.quant = quant
                self.params_bytes_quantized = self._param_bytes()
                self.quant_freed_bytes = (self.params_bytes_f32
                                          - self.params_bytes_quantized)
        self._feeds = self._init_tick_feeds()
        self._tok = self._feeds["tick_tok"]
        self._pos = self._feeds["tick_pos"]
        self._step = self._exe.prepare(
            self._program, dict(self._feeds), self._tick_fetches(),
            self.scope)
        # the prepared step is BOUND to the engine's in-place-mutated feed
        # arrays: device buffers and argument tuples are built once here,
        # never per tick (PreparedStep.bind)
        self._step.bind(self._feeds)
        # which bound step last ran over the target caches: "main" (the
        # plain tick) or "verify" (the speculative verify forward). The
        # caches are updated in place, so a refresh only re-points a step
        # at tensors someone replaced in the scope (PreparedStep.
        # refresh_state); the pure steady states never refresh.
        self._target_state_owner = "main"
        # census counters
        self.n_ticks = 0
        self.busy_slot_ticks = 0
        self.total_slot_ticks = 0
        self.tokens_out = 0
        #: TARGET-model forwards run (plain ticks + verify forwards): the
        #: denominator of tokens per target forward
        self.target_forwards = 0
        self._started_at = time.time()
        #: wall time of the last executed decode tick (None before the
        #: first) — stats() reports its age as the liveness signal
        self.last_tick_at: Optional[float] = None
        #: wall seconds of the most recent ticks, newest last (bounded) —
        #: tick-latency quantiles for benches and smoke runs
        self.tick_seconds: "deque[float]" = deque(maxlen=65536)
        #: completed requests, newest last (bounded) — the per-request
        #: latency decomposition record
        self.completed_log: "deque[GenRequest]" = deque(maxlen=512)
        self._init_metrics()
        # the KV caches are persistable fixed-shape state: their byte
        # census is pinned at construction. Seed the process-wide kv
        # watermark now so a scrape taken before the first tick carries
        # it; ticks re-stamp it (two engines in one process: last writer
        # wins the `current`, the peak ratchets over both)
        self._kv_bytes_static = self._kv_cache_bytes()
        # per-token KV bytes across every layer cache: what ONE occupied
        # position costs — the unit of the used-vs-reserved split
        self._kv_bytes_per_token = (self._kv_bytes_static
                                    / max(n_slots * max_len, 1))
        self._stamp_kv_watermarks({})
        if self.spec is not None:
            # builds + quantizes the verify program (twin of the main
            # tick — same resident payloads) and binds both spec steps
            self.spec.finalize()

    # -- tick-program construction (overridden by PagedKVEngine) ----------
    def _build_tick_program(self, n_slots, vocab, max_len, d_model,
                            d_inner, num_heads, num_layers, dropout,
                            packed, cache_prefix):
        """Build the tick into the current default programs; sets
        `self._next_ids` (the [S,1] int64 fetch) and `self.cache_names`
        (the persistable KV state var names)."""
        self._next_ids, self.cache_names = \
            _decode_tick_builder(n_slots, vocab, max_len, d_model,
                                 d_inner, num_heads, num_layers,
                                 dropout, packed, cache_prefix)

    def _init_tick_feeds(self) -> Dict[str, np.ndarray]:
        """The per-tick feed arrays, reused across ticks (filled in place
        by `_fill_tick_feeds` — the decode loop allocates nothing)."""
        return {"tick_tok": np.zeros((self.n_slots, 1), np.int64),
                "tick_pos": np.zeros((self.n_slots, 1, 1), np.float32)}

    def _tick_fetches(self):
        return [self._next_ids]

    def _fill_tick_feeds(self, active: Dict[int, GenRequest]):
        tok, pos = self._tok, self._pos
        tok[:] = 0
        pos[:] = 0.0
        for slot, req in active.items():
            tok[slot, 0] = req.next_tok
            pos[slot, 0, 0] = float(req.fed)

    def _stamp_kv_watermarks(self, active: Dict[int, GenRequest]):
        """The used-vs-reserved split: reserved is the engine's whole KV
        footprint (slot engine: every slot's full max_len row, pinned at
        construction), used is the positions live requests occupy — the
        gap between the two gauges is the per-slot reservation waste
        paging reclaims. Host arithmetic only."""
        used = sum(min(r.fed, self.max_len) for r in active.values()) \
            * self._kv_bytes_per_token
        _obs_memory.update_watermark("kv_cache_bytes",
                                     self._kv_bytes_static)
        _obs_memory.update_watermark("kv_cache_used_bytes", used)

    def _init_metrics(self):
        """Per-engine MetricsRegistry (observability/metrics.py), the
        JAX engine's `ptpu_engine_*` / `ptpu_request_*` families: the
        serving telemetry EngineServer exposes over HTTP /metrics —
        tokens/s, queue depth, slot occupancy, tick-latency quantiles,
        KV-cache bytes, the per-request latency decomposition."""
        r = self.metrics_registry = _obs_metrics.MetricsRegistry()
        self._m_tokens = r.counter(
            "ptpu_engine_tokens_total", "Tokens sampled by the engine.")
        self._m_ticks = r.counter(
            "ptpu_engine_ticks_total", "Decode ticks executed.")
        self._m_completed = r.counter(
            "ptpu_engine_requests_completed_total", "Completed requests.")
        r.gauge("ptpu_engine_queue_depth",
                "Requests waiting for a slot.", fn=lambda: self.n_pending)
        r.gauge("ptpu_engine_active_slots",
                "Slots carrying an in-flight request.",
                fn=lambda: self.n_active)
        r.gauge("ptpu_engine_slot_occupancy",
                "Fraction of slot-ticks that carried a request.",
                fn=self.occupancy)
        r.gauge("ptpu_engine_kv_cache_bytes",
                "Bytes held by the slot-indexed KV caches.",
                fn=self._kv_cache_bytes)
        r.gauge("ptpu_engine_tokens_per_second",
                "Tokens sampled per wall second since engine start.",
                fn=lambda: (self.tokens_out
                            / max(time.time() - self._started_at, 1e-9)))
        self._m_tick_latency = r.histogram(
            "ptpu_engine_tick_latency_seconds",
            "Wall latency of one decode tick.",
            buckets=(1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                     2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5))
        self._m_dispatch = r.histogram(
            "ptpu_engine_dispatch_seconds",
            "Host-side dispatch share of one decode tick: feed fill + "
            "bound-call argument handling up to the async-dispatch "
            "return, excluding the realization barrier (device wait).",
            buckets=(1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3,
                     2.5e-3, 5e-3, 1e-2, 2.5e-2))
        for q, name in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            r.gauge(f"ptpu_engine_tick_latency_{name}_seconds",
                    f"{name} decode-tick latency (histogram estimate).",
                    fn=(lambda q=q:
                        self._m_tick_latency.quantile(q) or 0.0))
        # per-request latency decomposition: one labeled histogram
        # family, phase=queue_wait|prefill|decode|transport, plus the
        # end-to-end series the phases sum to
        req_buckets = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2,
                       2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                       10.0, 30.0)
        self._m_req_phase = {
            phase: r.histogram(
                "ptpu_request_latency_seconds",
                "Per-request latency decomposition by lifecycle phase.",
                labels={"phase": phase}, buckets=req_buckets)
            for phase in ("queue_wait", "prefill", "decode", "transport")}
        self._m_req_e2e = r.histogram(
            "ptpu_request_e2e_seconds",
            "End-to-end request latency (submit -> completion frame "
            "sent; -> completion when no server is attached).",
            buckets=req_buckets)

    def _kv_cache_bytes(self) -> int:
        total = 0
        for name in self.cache_names:
            if self.scope.has_var(name):
                v = self.scope.get(name)
                total += v.numel() * v.element_size()
        return total

    def _param_bytes(self) -> int:
        """Resident bytes of the tick program's weight state (census
        categories params + params_quantized) — the before/after pair of
        the weight-only quantization claim."""
        from ..framework.costs import state_category
        seen, total = set(), 0
        for b in self._program.blocks:
            for name, v in b.vars.items():
                if name in seen or not v.persistable \
                        or not self.scope.has_var(name):
                    continue
                seen.add(name)
                if state_category(v, name) in ("params",
                                               "params_quantized"):
                    t = self.scope.get(name)
                    total += t.numel() * t.element_size()
        return total

    def _init_missing_vars(self, Scope):
        """Run the startup program into a throwaway scope and copy ONLY
        the vars the serving scope lacks: weights already present (shared
        by name) must not be re-randomized; caches and any missing
        parameters get their init."""
        tmp = Scope()
        self._exe.run(self._startup, scope=tmp)
        for name in tmp.local_var_names():
            if not self.scope.has_var(name):
                self.scope.set_var(name, tmp.get(name))

    # -- request intake ---------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new: int,
               eos_id: Optional[int] = "engine",
               on_done: Optional[Callable] = None,
               request_id: Optional[str] = None,
               defer_transport: bool = False) -> GenRequest:
        """Queue a generation request; returns the GenRequest handle
        (wait() for completion, or pass on_done — called on the ENGINE
        thread, keep it cheap). `request_id` is the caller's correlation
        id; it rides every span and the completion frame."""
        enforce(len(prompt) >= 1, "prompt must not be empty",
                exc=InvalidArgumentError)
        self._enforce_request_fits(prompt, max_new)
        with self._lock:
            self._rid += 1
            req = GenRequest(self._rid, prompt, max_new,
                             self.eos_id if eos_id == "engine" else eos_id,
                             on_done, request_id=request_id,
                             defer_transport=defer_transport)
            self._pending.append(req)
        return req

    def _enforce_request_fits(self, prompt, max_new):
        """The per-request length limit: on the slot engine every request
        owns one fixed [max_len] KV row. The paged engine overrides this —
        there the cap is the block table's span."""
        enforce(len(prompt) + int(max_new) <= self.max_len,
                f"prompt({len(prompt)}) + max_new({max_new}) exceeds the "
                f"slot engine's per-slot KV row width max_len="
                f"{self.max_len} (each slot reserves one full-length "
                f"row; use PagedKVEngine for pool-capacity-bound "
                f"admission)", exc=InvalidArgumentError)

    # -- scheduler hooks (overridden by PagedKVEngine) --------------------
    def _admit_request(self, req: GenRequest) -> bool:
        """Admission-time resource acquisition beyond the slot itself,
        called under the engine lock with a slot free: True admits, False
        leaves the request pending at the head of the queue. The paged
        engine acquires the request's block table here."""
        return True

    def _release_request(self, req: GenRequest):
        """Completion-side release (under the engine lock, paired with
        `_admit_request`). The paged engine returns the request's blocks
        to the pool / prefix cache here."""

    def _note_position_written(self, req: GenRequest, pos: int):
        """One cache position of `req` was written by the tick that just
        ran. The paged engine marks prefix blocks filled (sharable) the
        moment their last row lands."""

    def _note_tick_writes(self, active: Dict[int, GenRequest]):
        """Pre-dispatch hook naming the cache positions the imminent tick
        will write. The paged engine's shadow-state sanitizer
        (`PTPU_KV_SANITIZE=1`) checks each against the ownership model
        here. Default: no-op (the slot engine's rows cannot alias)."""

    # -- speculative-decoding hooks (overridden by PagedKVEngine) ---------
    def _build_verify_tick(self, gamma):
        """Build the verify program (a γ+1-wide window forward over the
        TARGET's caches and weights, shared by name) into the current
        default programs; returns (ids, logp, cache_names)."""
        from ..models import transformer
        d = self._builder_dims
        return transformer.transformer_lm_spec_verify_tick(
            n_slots=self.n_slots, gamma=gamma, vocab=d["vocab"],
            max_len=self.max_len, d_model=d["d_model"],
            d_inner=d["d_inner"], num_heads=d["num_heads"],
            num_layers=d["num_layers"], dropout=d["dropout"],
            packed=d["packed"], cache_prefix=self._cache_prefix)

    def _init_verify_feeds(self, g: int) -> Dict[str, np.ndarray]:
        """The verify forward's reusable feed arrays (g = γ+1)."""
        return {"spec_tok": np.zeros((self.n_slots, g), np.int64),
                "spec_pos": np.zeros((self.n_slots, 1, 1), np.float32)}

    def _fill_verify_row(self, feeds, slot: int, req: GenRequest, g: int):
        """Fill slot `slot`'s verify-feed rows for a window starting at
        `req.fed` (spec_tok is filled batch-wide by the caller)."""
        feeds["spec_pos"][slot, 0, 0] = float(req.fed)

    def _spec_capable(self, req: GenRequest, g: int) -> bool:
        """Can `req` take a full γ+1 window without overrunning its KV
        span? A single ineligible slot degrades the whole step to one
        plain tick."""
        return req.fed + g <= self.max_len

    def _spec_rollback(self, req: GenRequest, keep_len: int,
                       written_len: int) -> int:
        """Positions [keep_len, written_len) of `req` were written by a
        verify forward but rejected. Slot engine: nothing to do — the
        stale rows sit above the slot's position mask and are rewritten
        before they are ever exposed. The paged engine rolls fully-dead
        blocks back through the pager. Returns the blocks rolled back."""
        return 0

    # -- scheduler --------------------------------------------------------
    def _admit(self):
        admitted = []
        with _tracing.span("admission", "engine/admit",
                           pending=len(self._pending)), self._lock:
            if self.policy == "static" and (self._active
                                            or not self._pending):
                return
            while self._pending and self._slots.n_free:
                if not self._admit_request(self._pending[0]):
                    break                        # head-of-line wait
                slot = self._slots.alloc()
                req = self._pending.popleft()
                req.slot = slot
                req.admitted_at = time.time()
                req.admitted_pc = time.perf_counter()
                self._active[slot] = req
                admitted.append(req)
        for req in admitted:
            # the queue-wait phase becomes a span the moment it ends
            # (slot assignment) — retroactive, exact boundaries
            _tracing.record_span(
                "request", "request/queue_wait", req.submitted_pc,
                req.admitted_pc, request_id=req.request_id,
                slot=req.slot)
            self._m_req_phase["queue_wait"].observe(
                req.admitted_pc - req.submitted_pc)

    @property
    def n_active(self) -> int:
        with self._lock:
            return len(self._active)

    @property
    def n_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def _advance_slot(self, req: GenRequest, out_id: int) -> bool:
        """Advance `req` one position with the model's output `out_id` for
        that position — the per-slot commit shared by the plain tick and
        every speculative verify position. Returns True when the request
        just finished (max_new / eos / out of room)."""
        k = req.fed                    # the position just consumed
        req.fed += 1
        self._note_position_written(req, k)
        if k < len(req.prompt) - 1:
            req.next_tok = req.prompt[k + 1]     # still prefilling
            return False
        t = int(out_id)                          # sampled next token
        if req.first_token_pc is None:
            req.first_token_at = time.time()
            req.first_token_pc = time.perf_counter()
        req.tokens.append(t)
        self.tokens_out += 1
        self._m_tokens.inc()
        req.next_tok = t
        hit_eos = (req.eos_id is not None and t == req.eos_id)
        out_of_room = req.fed >= self.max_len
        return len(req.tokens) >= req.max_new or hit_eos or out_of_room

    def step(self) -> List[GenRequest]:
        """One decode step: admit, run, collect. Returns the requests that
        COMPLETED on this step; [] when nothing is active or pending.
        Without speculation (or when an active request is too close to its
        length cap for a full window) this is one plain tick, recorded as
        a "tick" span; with `speculative=` it is one speculative round
        (γ+1 draft ticks + one verify forward — `speculate`/`verify`
        spans) advancing every slot up to γ+1 positions."""
        self._admit()
        with self._lock:
            active = dict(self._active)
        if not active:
            return []
        if self.spec is not None and all(
                self._spec_capable(r, self.spec.cfg.gamma + 1)
                for r in active.values()):
            t0 = time.perf_counter()
            finished = self.spec.round(active)
            self.tick_seconds.append(time.perf_counter() - t0)
            self._m_ticks.inc()
            self.n_ticks += 1
            self.last_tick_at = time.time()
            self._stamp_kv_watermarks(active)
            self.busy_slot_ticks += len(active)
            self.total_slot_ticks += self.n_slots
        else:
            finished = self._plain_tick(active)
        if finished:
            # complete (firing on_done -> writer.offer) BEFORE dropping
            # the request from _active: a drain poll reading
            # n_active == 0 must imply every completion frame is already
            # in its writer queue
            for req in finished:
                req._complete()
            with self._lock:
                for req in finished:
                    del self._active[req.slot]
                    self._slots.free(req.slot)
                    self._release_request(req)
            self._m_completed.inc(len(finished))
            for req in finished:
                self._finalize_request(req)
        return finished

    def _pre_tick(self, active: Dict[int, GenRequest]
                  ) -> Dict[int, GenRequest]:
        """Scheduler hook run at the top of every plain tick, before the
        feeds fill: the two-tier engine (serving/kv_pager.py,
        `host_tier=`) resumes/suspends requests here — swapping KV blocks
        against the host tier between ticks — and returns the RESIDENT
        subset that actually ticks. Default: everything admitted is
        resident."""
        return active

    def _plain_tick(self, active: Dict[int, GenRequest]
                    ) -> List[GenRequest]:
        t0 = time.perf_counter()
        active = self._pre_tick(active)
        # the rid list is trace provenance only — not built per tick
        # when tracing is off (the decode loop is the hot path)
        span_attrs = {"active": len(active)}
        if _tracing.enabled():
            span_attrs["request_ids"] = [r.request_id
                                         for r in active.values()]
        with _tracing.span("tick", "engine/tick", **span_attrs):
            self._fill_tick_feeds(active)
            self._note_tick_writes(active)
            if self._target_state_owner != "main":
                # a speculative verify forward ran since the last plain
                # tick: re-point the bound step at the scope's live cache
                # tensors
                self._step.refresh_state()
                self._target_state_owner = "main"
            fetches = self._step.run_bound()
            self.target_forwards += 1
            td = time.perf_counter()           # async launches returned
            # realization barrier: the next tick's feed depends on the ids
            ids = fetches[0].cpu().numpy()
        self._m_dispatch.observe(td - t0)
        if _tracing.enabled():
            # the host-dispatch share of the tick as a named phase
            _tracing.record_span("dispatch", "engine/dispatch", t0, td,
                                 active=len(active))
        dt = time.perf_counter() - t0
        self.tick_seconds.append(dt)
        self._m_tick_latency.observe(dt)
        self._m_ticks.inc()
        self.n_ticks += 1
        self.last_tick_at = time.time()
        # re-stamp the kv watermarks so the live `current` reflects the
        # engine that is ticking (host counters only, O(active))
        self._stamp_kv_watermarks(active)
        self.busy_slot_ticks += len(active)
        self.total_slot_ticks += self.n_slots
        finished = []
        for slot, req in active.items():
            if self._advance_slot(req, int(ids[slot, 0])):
                finished.append(req)
        return finished

    def _finalize_request(self, req: GenRequest):
        """Completion-side telemetry: the prefill/decode phase spans and
        histograms from the request's perf_counter stamps. The transport
        phase + end-to-end series land in `report_sent` when a server
        reports the completion frame on the wire; for a direct engine
        caller (no server, no wire) they close here with transport = 0,
        so the phase sums always match the e2e series."""
        first = req.first_token_pc if req.first_token_pc is not None \
            else req.done_pc
        _tracing.record_span("request", "request/prefill",
                             req.admitted_pc, first,
                             request_id=req.request_id, slot=req.slot,
                             prompt_len=len(req.prompt))
        _tracing.record_span("request", "request/decode", first,
                             req.done_pc, request_id=req.request_id,
                             slot=req.slot, new_tokens=len(req.tokens))
        ph = req.phases()
        self._m_req_phase["prefill"].observe(ph["prefill"])
        self._m_req_phase["decode"].observe(ph["decode"])
        self.completed_log.append(req)
        if not req.defer_transport:
            self._m_req_phase["transport"].observe(0.0)
            self._m_req_e2e.observe(req.e2e_s())

    def report_sent(self, req: GenRequest, sent_pc: float):
        """Server-side hook: the request's completion frame left the
        process at perf_counter time `sent_pc` (the writer's on_sent
        callback). Closes the transport phase and the e2e series, and
        records the transport span."""
        req.sent_pc = float(sent_pc)
        req.sent_at = time.time()
        _tracing.record_span("request", "request/transport", req.done_pc,
                             req.sent_pc, request_id=req.request_id)
        self._m_req_phase["transport"].observe(req.sent_pc - req.done_pc)
        self._m_req_e2e.observe(req.e2e_s())

    def run_until_idle(self, max_ticks: Optional[int] = None
                       ) -> List[GenRequest]:
        """Tick until every pending/active request completed (or
        max_ticks); returns all completions in completion order."""
        done: List[GenRequest] = []
        ticks = 0
        while True:
            with self._lock:
                idle = not self._active and not self._pending
            if idle:
                return done
            done.extend(self.step())
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                return done

    def occupancy(self) -> float:
        """Fraction of slot-ticks that carried an active request —
        continuous batching's object of optimization."""
        return (self.busy_slot_ticks / self.total_slot_ticks
                if self.total_slot_ticks else 0.0)

    def stats(self) -> Dict:
        """Instantaneous engine state: slot/queue shape, tick liveness,
        token throughput, the speculative counters."""
        now = time.time()
        return {
            "n_slots": self.n_slots,
            "active": self.n_active,
            "pending": self.n_pending,
            "ticks": self.n_ticks,
            "tokens_out": self.tokens_out,
            "occupancy": self.occupancy(),
            "kv_cache_bytes": self._kv_cache_bytes(),
            "last_tick_age_s": ((now - self.last_tick_at)
                                if self.last_tick_at is not None
                                else None),
            "uptime_s": now - self._started_at,
            "target_forwards": self.target_forwards,
            "tokens_per_target_forward": (
                self.tokens_out / max(self.target_forwards, 1)),
            "speculative": (self.spec.stats()
                            if self.spec is not None else None),
        }


def _decode_tick_builder(n_slots, vocab, max_len, d_model, d_inner,
                         num_heads, num_layers, dropout, packed,
                         cache_prefix):
    from ..models import transformer
    return transformer.transformer_lm_decode_tick(
        n_slots=n_slots, vocab=vocab, max_len=max_len, d_model=d_model,
        d_inner=d_inner, num_heads=num_heads, num_layers=num_layers,
        dropout=dropout, packed=packed, cache_prefix=cache_prefix)


# ---------------------------------------------------------------------------
# Prometheus /metrics exposition + /healthz
# ---------------------------------------------------------------------------


class _MetricsHTTPServer:
    """Minimal threading HTTP listener serving GET /metrics (Prometheus
    text exposition 0.0.4 from one registry — Multi or plain) and, when
    a `health_fn` is given, GET /healthz as structured JSON (the control
    loop's signal: engine serving/draining state, last-tick age, pending
    checkpoints, supervisor restart count)."""

    def __init__(self, addr, registry, health_fn=None):
        import http.server
        import json as _json

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server contract)
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = registry.expose().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                    code = 200
                elif path == "/healthz" and health_fn is not None:
                    health = health_fn()
                    body = _json.dumps(health, default=str).encode()
                    ctype = "application/json"
                    # draining surfaces as 503: a load balancer must stop
                    # routing to a replica that stopped admitting
                    code = 200 if health.get("status") == "serving" \
                        else 503
                else:
                    self.send_error(404, "serving /metrics and /healthz")
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):   # scrapes must not spam stderr
                pass

        self._srv = http.server.ThreadingHTTPServer(addr, Handler)
        self._srv.daemon_threads = True
        self.server_address = self._srv.server_address

    def serve_forever(self):
        self._srv.serve_forever(poll_interval=0.1)

    def shutdown(self):
        self._srv.shutdown()

    def server_close(self):
        self._srv.server_close()


def scrape_metrics(host: str, port: int, timeout: float = 5.0) -> str:
    """One GET /metrics against an EngineServer's metrics address —
    what the tests and the smoke run use; production scrapers point
    Prometheus at the same URL."""
    import urllib.request
    with urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=timeout) as resp:
        return resp.read().decode()


def scrape_healthz(host: str, port: int, timeout: float = 5.0) -> Dict:
    """One GET /healthz (same listener as /metrics): the parsed JSON
    health document. A draining server answers 503 but still carries the
    body — this helper returns it either way."""
    import json as _json
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(
                f"http://{host}:{port}/healthz", timeout=timeout) as resp:
            return _json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        if e.code == 503:   # draining: the body IS the health document
            return _json.loads(e.read().decode())
        raise


# ---------------------------------------------------------------------------
# generation RPC over the transport's frames
# ---------------------------------------------------------------------------


class EngineServer:
    """Serve a ContinuousBatchingEngine over TCP.

    Wire format is the transport's framing (serving/transport.py) with
    JSON-only frames:
      request   {"gen": {"prompt": [ids...], "max_new": n, "tag": any}}
      response  {"done": {"tag": any, "tokens": [ids...],
                          "latency_ms": float}}
    Responses are keyed by the client's `tag` (completion order is the
    ENGINE's order, not request order — short requests overtake long
    ones; that reordering is continuous batching working as designed).

    Threads: one engine thread ticks the decode loop; per connection, a
    reader admits requests and a writer flushes completions — completions
    landing on the same tick leave in one vectored send (transport
    `_sendall_vec`), so socket I/O and the decode tick overlap. The
    engine thread sets the engine's CUDA device before its first tick."""

    def __init__(self, engine: ContinuousBatchingEngine,
                 host: str = "127.0.0.1", port: int = 0,
                 metrics_port: Optional[int] = 0):
        import socket as _socket

        self.engine = engine
        self._sock = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        self._sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._wake = threading.Event()     # submissions kick the engine
        self._draining = threading.Event()  # admit nothing new, finish rest
        self._threads: List[threading.Thread] = []
        self._conns: List = []
        self._writers: List = []
        self._lock = threading.Lock()
        self._prev_sigterm = None
        # Prometheus exposition + health: a small HTTP listener serving
        # GET /metrics and GET /healthz. A SEPARATE socket from the
        # generation RPC (that one speaks the transport's frames;
        # an HTTP GET on it would misparse as a frame header). The
        # scraped registry is the UNION of the engine's own registry and
        # the process-wide default registry, so one scrape sees serving,
        # checkpoint (ptpu_ckpt_*), and training (ptpu_train_*) series.
        # metrics_port=None disables; 0 picks an ephemeral port
        # (self.metrics_address after construction).
        self._http = None
        self.metrics_address = None
        if metrics_port is not None:
            # materialize the process-wide series before the first
            # scrape: ptpu_ckpt_* and ptpu_train_* register lazily, and
            # a scrape must see the families (at zero) even before the
            # first save/step touches them
            from ..parallel.elastic import metrics_registry
            from ..trainer import training_metrics
            metrics_registry()
            training_metrics()
            _obs_memory.memory_metrics()   # ptpu_memory_* + ptpu_mfu
            self._http = _MetricsHTTPServer(
                (host, metrics_port),
                _obs_metrics.MultiRegistry(
                    [engine.metrics_registry,
                     _obs_metrics.default_registry()]),
                health_fn=self.health)
            self.metrics_address = self._http.server_address

    def health(self) -> Dict:
        """The /healthz document — the control-loop signal: admission
        state (serving vs draining after SIGTERM), engine tick liveness,
        pending async checkpoint commits, and the supervising process's
        restart count (PTPU_SUPERVISOR_RESTARTS, set by a supervisor for
        its children)."""
        from ..parallel.elastic import pending_async_count
        restarts = os.environ.get("PTPU_SUPERVISOR_RESTARTS")
        return {
            "status": ("draining" if self._draining.is_set()
                       else "serving"),
            "engine": self.engine.stats(),
            "checkpoints": {
                "pending_async": pending_async_count()},
            "supervisor": {
                "restarts": int(restarts) if restarts else 0},
            # the memory board: per-channel current + high-water bytes
            # and the last MFU reading
            "memory": _obs_memory.watermark_board(),
            "pid": os.getpid(),
            "ts": time.time(),
        }

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "EngineServer":
        t = threading.Thread(target=self._engine_loop, daemon=True)
        a = threading.Thread(target=self._accept_loop, daemon=True)
        self._threads += [t, a]
        t.start()
        a.start()
        if self._http is not None:
            h = threading.Thread(target=self._http.serve_forever,
                                 daemon=True)
            self._threads.append(h)
            h.start()
            self._http_started = True
        return self

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Graceful shutdown (the SIGTERM path): stop admitting — the
        listener closes and new `gen` frames on live connections are
        answered with a draining error — finish every in-flight AND
        already-queued request, flush the per-connection writer threads
        so every completion frame reaches its client, then shut down.
        Returns True when the engine fully drained within `timeout`
        (False: timed out; shutdown still ran, undelivered work was
        dropped)."""
        # flag flips under the admission lock: every reader thread either
        # observed draining (and rejects) or completed its submit before
        # this point (and the idle wait below sees that request) — no
        # window where a request is admitted into a stopping engine
        with self._lock:
            self._draining.set()
        # closing the listener unblocks accept(); in-flight conns stay
        # open so completions can still go out
        from .transport import _close_listener
        _close_listener(self._sock)
        deadline = None if timeout is None else time.time() + timeout
        drained = True
        while self.engine.n_active or self.engine.n_pending:
            self._wake.set()
            if deadline is not None and time.time() > deadline:
                drained = False
                break
            time.sleep(0.01)
        # flush writers BEFORE shutdown closes the sockets: close()
        # enqueues EOF and joins, so every queued completion frame is
        # vectored out first
        with self._lock:
            writers = list(self._writers)
        for w in writers:
            w.close()
        self.shutdown()
        return drained

    def install_sigterm_handler(self, exit_process: bool = True,
                                timeout: Optional[float] = None):
        """Wire SIGTERM to a graceful drain (main thread only — the
        signal module's contract). The handler returns immediately; a
        daemon thread performs the drain so the signal context never
        blocks, then — with exit_process — exits 0 (the k8s/preemption
        contract: SIGTERM means finish what you hold and leave
        cleanly)."""
        import signal as _signal

        def _handler(signum, frame):
            t = threading.Thread(target=self._drain_then_exit,
                                 args=(exit_process, timeout),
                                 daemon=True)
            t.start()

        self._prev_sigterm = _signal.signal(_signal.SIGTERM, _handler)
        return self

    def _drain_then_exit(self, exit_process: bool, timeout):
        try:
            # (the JAX package also waits here for its async checkpoint
            # writer; the port writes checkpoints synchronously)
            self.drain(timeout=timeout)
        except Exception as e:
            # a timed-out flush must not kill this thread BEFORE the
            # exit below: the SIGTERM disposition was replaced by our
            # handler, so skipping os._exit would leave a process that
            # ignores every further SIGTERM (undrainable zombie). The
            # exit-0 contract holds, but the failure must be visible —
            # operators need to tell a clean drain from a failed one
            from ..core import flags
            flags.vlog(0, "SIGTERM drain did not complete cleanly: "
                       "%s: %s (exiting anyway)", type(e).__name__, e)
        if exit_process:  # pragma: no cover - exits the interpreter
            os._exit(0)

    def shutdown(self):
        self._stop.set()
        self._wake.set()
        if self._http is not None:
            # socketserver's shutdown() blocks on an event only
            # serve_forever() ever sets — calling it when start() never
            # ran would hang forever; just close the listener then
            if getattr(self, "_http_started", False):
                self._http.shutdown()
            self._http.server_close()
        from .transport import _close_listener
        _close_listener(self._sock)
        import socket as _socket
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            # shutdown BEFORE close: reader threads parked in recv are
            # not woken by closing the fd on Linux; shutdown makes recv
            # return 0 immediately (same drill as PredictorServer)
            try:
                c.shutdown(_socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.shutdown()

    # -- engine thread ----------------------------------------------------
    def _engine_loop(self):
        # the current CUDA device is per thread: set the engine's before
        # the first tick, or its launches would go to device 0
        device = self.engine._exe.device
        if device.type == "cuda":
            import torch
            torch.cuda.set_device(device)
        while not self._stop.is_set():
            if self.engine.n_active or self.engine.n_pending:
                self.engine.step()
            else:
                self._wake.wait(timeout=0.05)
                self._wake.clear()

    # -- I/O threads ------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            import socket as _socket
            conn.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            with self._lock:
                self._conns.append(conn)
                self._threads.append(t)
            t.start()

    def _serve_conn(self, conn):
        from .transport import _BatchingWriter, _encode_msg, _recv_msg

        # shared with PredictorServer: bounded queue + vectored batch
        # drain. Completions use the NON-blocking offer(): the engine
        # thread ticks for every connection and must never stall on one
        # that stopped reading — a client ~64 unread frames behind is
        # evicted (connection closed), frames for a dead connection are
        # dropped.
        writer = _BatchingWriter(conn)
        with self._lock:
            self._writers.append(writer)

        def on_done(req, tag):
            ph = req.phases() or {}
            frame = _encode_msg({"done": {
                "tag": tag, "tokens": req.tokens,
                "request_id": req.request_id,
                "latency_ms": round(req.latency_s * 1e3, 3),
                "phases_ms": {k: round(v * 1e3, 3)
                              for k, v in ph.items()
                              if k != "transport"}}})
            # on_sent closes the transport phase: the writer thread
            # reports the perf_counter instant the vectored send
            # returned, and the engine observes transport + e2e. A
            # failed offer (dead writer / slow-consumer eviction) means
            # the frame will NEVER go out — close the series here so the
            # e2e count cannot lag the phase counts
            ok = writer.offer(frame, on_sent=(
                lambda ts, req=req: self.engine.report_sent(req, ts)))
            if not ok:
                self.engine.report_sent(req, time.perf_counter())

        try:
            while not self._stop.is_set():
                header, _ = _recv_msg(conn)
                if header is None or "gen" not in header:
                    break
                g = header["gen"]
                tag = g.get("tag")
                err = None
                admitted = False
                # check-and-submit under the admission lock (paired with
                # drain()'s locked flag flip): a submit can never slip in
                # after drain decided the engine is idle
                with self._lock:
                    if self._draining.is_set():
                        # graceful drain: in-flight work completes, but
                        # nothing new is admitted — the client gets an
                        # explicit rejection, never a silent drop
                        err = ("server draining (SIGTERM): not "
                               "admitting new requests")
                    else:
                        try:
                            self.engine.submit(
                                g["prompt"], g.get("max_new", 16),
                                on_done=(lambda req, tag=tag:
                                         on_done(req, tag)),
                                request_id=g.get("request_id"),
                                defer_transport=True)
                            admitted = True
                        except Exception as e:
                            err = f"{type(e).__name__}: {e}"
                if admitted:
                    self._wake.set()
                else:
                    # respond OUTSIDE the lock: it may block on writer
                    # backpressure
                    writer.respond(_encode_msg({"error": err,
                                                "tag": tag}))
        except (ConnectionError, OSError):
            pass
        finally:
            writer.close()
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
                if writer in self._writers:
                    self._writers.remove(writer)


class EngineClient:
    """Client for EngineServer; supports pipelined generation requests."""

    def __init__(self, host: str, port: int):
        import socket as _socket

        self._sock = _socket.create_connection((host, port))
        self._sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        self._lock = threading.Lock()
        self._tag = 0

    def send_gen(self, prompt: Sequence[int], max_new: int = 16,
                 tag=None, request_id: Optional[str] = None):
        """`request_id` is the client's correlation id: it threads
        through admission, every decode tick's span attrs, the
        per-request latency decomposition, and comes back on the done
        frame — the end-to-end trace key across client/server/engine."""
        from .transport import _send_msg
        with self._lock:
            self._tag += 1
            tag = self._tag if tag is None else tag
            msg = {"gen": {"prompt": [int(t) for t in prompt],
                           "max_new": int(max_new), "tag": tag}}
            if request_id is not None:
                msg["gen"]["request_id"] = str(request_id)
            _send_msg(self._sock, msg)
        return tag

    def recv_done(self):
        """Next completion: (tag, tokens, latency_ms). Completion order is
        the engine's, not send order."""
        from .transport import _recv_msg
        header, _ = _recv_msg(self._sock)
        if header is None:
            raise ConnectionError("server closed the connection")
        if "error" in header:
            raise RuntimeError(f"server error: {header['error']}")
        d = header["done"]
        return d["tag"], d["tokens"], d["latency_ms"]

    def generate(self, prompt: Sequence[int], max_new: int = 16
                 ) -> List[int]:
        tag = self.send_gen(prompt, max_new)
        got_tag, tokens, _ = self.recv_done()
        if got_tag != tag:
            raise RuntimeError(
                f"unexpected completion tag {got_tag} (want {tag}); use "
                f"send_gen/recv_done for pipelined requests")
        return tokens

    def close(self):
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
