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

The hooks `_build_tick_program`, `_init_tick_feeds`, `_fill_tick_feeds`,
`_admit_request`, `_release_request`, `_note_position_written` and the
speculative ones (`_build_verify_tick`, `_fill_verify_row`,
`_spec_capable`, `_spec_rollback`) are what `PagedKVEngine`
(serving/kv_pager.py) overrides; the scheduler itself is shared.

Scheduling policies:

- "continuous": admit whenever a slot is free — the engine's point.
- "static": admit only when ALL slots are free (form a batch, run it to
  full completion, drain, repeat) — the padded static-batch baseline.

Not ported yet (ROADMAP.md §1 item 2): the metrics registry, tracing
spans and memory watermarks, and the EngineServer/EngineClient transport.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core.enforce import InvalidArgumentError, enforce

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
    """One generation request moving through the engine. Lifecycle
    boundaries are stamped on the perf_counter clock, so the latency
    decomposes as queue_wait (submitted → admitted), prefill (admitted →
    first token) and decode (first token → done)."""

    __slots__ = ("rid", "request_id", "prompt", "max_new", "eos_id",
                 "tokens", "slot", "fed", "next_tok", "submitted_pc",
                 "admitted_pc", "first_token_pc", "done_pc", "on_done",
                 "table", "shared_len", "spec_draft_s", "spec_verify_s",
                 "_event")

    def __init__(self, rid, prompt, max_new, eos_id=None, on_done=None,
                 request_id: Optional[str] = None):
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
        self.submitted_pc = time.perf_counter()
        self.admitted_pc: Optional[float] = None
        self.first_token_pc: Optional[float] = None
        self.done_pc: Optional[float] = None
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
        """{queue_wait, prefill, decode} seconds; None before completion.
        The three phases partition [submitted, done] exactly (the JAX
        package's fourth, transport, waits for the server). With
        `subphases=True`, a request served speculatively also reports
        `spec_draft` and `spec_verify` — sub-phases of the prefill+decode
        window, not added to the partition."""
        if self.done_pc is None:
            return None
        first = self.first_token_pc if self.first_token_pc is not None \
            else self.done_pc
        ph = {"queue_wait": self.admitted_pc - self.submitted_pc,
              "prefill": first - self.admitted_pc,
              "decode": self.done_pc - first}
        if subphases:
            ph["spec_draft"] = self.spec_draft_s
            ph["spec_verify"] = self.spec_verify_s
        return ph

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not done in {timeout}s")
        return self.tokens

    def _complete(self):
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
               request_id: Optional[str] = None) -> GenRequest:
        """Queue a generation request; returns the GenRequest handle
        (wait() for completion, or pass on_done — called on the ENGINE
        thread, keep it cheap)."""
        enforce(len(prompt) >= 1, "prompt must not be empty",
                exc=InvalidArgumentError)
        self._enforce_request_fits(prompt, max_new)
        with self._lock:
            self._rid += 1
            req = GenRequest(self._rid, prompt, max_new,
                             self.eos_id if eos_id == "engine" else eos_id,
                             on_done, request_id=request_id)
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
        with self._lock:
            if self.policy == "static" and (self._active
                                            or not self._pending):
                return
            while self._pending and self._slots.n_free:
                if not self._admit_request(self._pending[0]):
                    break                        # head-of-line wait
                slot = self._slots.alloc()
                req = self._pending.popleft()
                req.slot = slot
                req.admitted_pc = time.perf_counter()
                self._active[slot] = req

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
            req.first_token_pc = time.perf_counter()
        req.tokens.append(t)
        self.tokens_out += 1
        req.next_tok = t
        hit_eos = (req.eos_id is not None and t == req.eos_id)
        out_of_room = req.fed >= self.max_len
        return len(req.tokens) >= req.max_new or hit_eos or out_of_room

    def step(self) -> List[GenRequest]:
        """One decode step: admit, run, collect. Returns the requests that
        COMPLETED on this step; [] when nothing is active or pending.
        Without speculation (or when an active request is too close to its
        length cap for a full window) this is one plain tick; with
        `speculative=` it is one speculative round (γ+1 draft ticks + one
        verify forward) advancing every slot up to γ+1 positions."""
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
            self.n_ticks += 1
            self.last_tick_at = time.time()
            self.busy_slot_ticks += len(active)
            self.total_slot_ticks += self.n_slots
        else:
            finished = self._plain_tick(active)
        if finished:
            for req in finished:
                req._complete()
            with self._lock:
                for req in finished:
                    del self._active[req.slot]
                    self._slots.free(req.slot)
                    self._release_request(req)
        return finished

    def _plain_tick(self, active: Dict[int, GenRequest]
                    ) -> List[GenRequest]:
        t0 = time.perf_counter()
        self._fill_tick_feeds(active)
        if self._target_state_owner != "main":
            # a speculative verify forward ran since the last plain tick:
            # re-point the bound step at the scope's live cache tensors
            self._step.refresh_state()
            self._target_state_owner = "main"
        fetches = self._step.run_bound()
        self.target_forwards += 1
        # realization barrier: the next tick's feed depends on the ids
        ids = fetches[0].cpu().numpy()
        self.tick_seconds.append(time.perf_counter() - t0)
        self.n_ticks += 1
        self.last_tick_at = time.time()
        self.busy_slot_ticks += len(active)
        self.total_slot_ticks += self.n_slots
        finished = []
        for slot, req in active.items():
            if self._advance_slot(req, int(ids[slot, 0])):
                finished.append(req)
        return finished

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
