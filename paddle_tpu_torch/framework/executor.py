"""Executor: run programs on a torch device.

≙ paddle_tpu/framework/executor.py. The JAX executor traces the global block
into one jax function and XLA-compiles it; this one interprets the block
eagerly, op by op, under `torch.no_grad()`: grad is enabled only inside a
`vjp_region` (lowering.py `run_vjp_region`, on torch.autograd). What
carries over:

- the plan cache keyed by (program version, feed signature, fetch list,
  scope contents, fusion flags) — the plan is the fused op list;
- the read-only / read-write / write-only state analysis over persistable
  variables, and `apply_fusion_passes` on a clone of the program;
- `Executor.prepare` → `PreparedStep` with `run`, `bind`, `refresh_state`
  and `run_bound` for the serving engine's tick;
- `Executor.run_steps`: k steps of one feed signature in one call, the
  fetches stacked over steps, state as after the last step;
- the all-ones `@batch_row_mask` feed when a program declares
  `layers.batch_row_mask()` and the caller does not feed it;
- feed staging: a data var declared with a staging dtype may be fed in
  it (uint8 images), and is cast and scaled on the device;
- every plan drops each transient at its last use (`_release_schedule`):
  the port's counterpart of XLA's buffer assignment, which frees a
  transient at its last use in every compiled program, planned or not;
  a memory-planned program's order and remat segments decide what that
  leaves live;
- `cost_analysis` / `memory_analysis` / `memory_census`, with the JAX
  package's keys, from the port's own count of the step and the caching
  allocator's statistics;
- the JAX executor's spans (`executor/trace_and_compile` around the plan
  build, `executor/feed`, `executor/run`, `executor/state_writeback`)
  and its `device_state_bytes` watermark, on `Executor.run`. The bound
  tick (`PreparedStep.run_bound`) records none, as in the JAX package:
  the serving engine's own spans cover it.

What differs: persistable state that an op reads and rewrites is updated
IN PLACE on the device — an op whose output variable is the one it reads
writes into that tensor (`LowerCtx.writes_input`). That covers the serving
engine's KV caches and a training step's parameters, optimizer moments,
beta powers and learning rate; the JAX executor instead donates the
buffers to XLA and rebinds the scope to the returned arrays. So a
parameter keeps its tensor identity across steps. Fetches come back as
device tensors from `PreparedStep`, as numpy arrays from `Executor.run` by
default (a fetched tensor of read-write state is that state: a later step
changes it; a numpy fetch is a copy). Gradients (`<param>@GRAD`) can be
fetched like any variable.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np
import torch

from ..core import flags
from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, NotFoundError, enforce
from ..core.places import Place, resolve_device
from ..observability import memory as _memory
from ..observability import tracing as _tracing
from .lowering import build_plan, run_plan
from .program import (BATCH_ROW_MASK_NAME, Program, Variable,
                      default_main_program)
from .registry import LowerCtx
from .scope import Scope, global_scope


def _fusion_flags_key():
    """Flags read when a plan is built: part of the plan-cache key, so a
    toggled flag never reuses the other variant's plan."""
    return (flags.get_flag("fuse_decode_attention"),
            flags.get_flag("fuse_recurrent_cells"),
            flags.get_flag("memory_plan"))


def _feed_signature(feed: Dict[str, Any]):
    return tuple(sorted((k, tuple(np.shape(v)), str(v.dtype)
                         if hasattr(v, "dtype") else str(np.asarray(v).dtype))
                        for k, v in feed.items()))


def _fetch_names(fetch_list):
    return [f.name if isinstance(f, Variable) else f
            for f in (fetch_list or [])]


def as_numpy(t) -> np.ndarray:
    """Device tensor → numpy, a copy of the tensor's values as they are
    now (as jax arrays are): a CPU tensor's own memory is not shared, so
    a fetched parameter keeps its value when a later step updates the
    parameter in place. numpy has no bfloat16, so bfloat16 tensors come
    back as float32 (exact: every bfloat16 value is a float32)."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    if t.device.type == "cpu":
        return t.numpy().copy()
    return t.cpu().numpy()


def _unstage(name, t, dtype, staging):
    """Feed staging (≙ paddle_tpu/framework/executor.py:297-318): a feed of
    its var's wire dtype is cast to the var's dtype and scaled where it
    lies — on the card, so only the wire bytes crossed PCIe. Any other
    dtype than those two is the caller's fault and raises: scaling it
    would corrupt the feed."""
    wire, scale = staging
    if t.dtype == dtype:
        return t
    if t.dtype != wire:
        raise TypeError(
            f"feed '{name}' has dtype {dtype_name(t.dtype)} but the var is "
            f"declared {dtype_name(dtype)} with staging dtype "
            f"{dtype_name(wire)}; feed either of those")
    t = t.to(dtype)
    return t if scale is None else t.mul_(scale)


def _run_seed(random_seed: int, counter: int) -> int:
    return (random_seed * 1000003 + counter) % 2147483648


class _Plan:
    """A program fused and fixed for one (feed signature, fetch list,
    scope contents): the op list plus the state analysis. `program` is the
    fused program itself, whose sub-blocks control-flow ops run."""

    def __init__(self, program, ro_names, rw_names, out_only, feed_names,
                 fetch_names):
        self.program = program
        self.ops = build_plan(program.global_block())
        self.ro_names = ro_names
        self.rw_names = rw_names
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.state_out_names = sorted(set(rw_names) | set(out_only))
        self.constants = {}     # LowerCtx.constant memo, per plan
        block = program.global_block()
        self.staged_feeds = tuple(
            (n, block.vars[n].dtype, block.vars[n].staging)
            for n in feed_names
            if n in block.vars and block.vars[n].staging is not None)
        self.census_state_bytes = None     # Executor._note_run_memory
        self.flops_estimate = 0.0          # per step, for `ptpu_mfu`
        self.mfu_warm = False
        self.read_names = frozenset(
            {n for blk in program.blocks for op in blk.ops
             for n in op.input_names()}
            | set(fetch_names) | set(self.state_out_names))
        self.release = _release_schedule(program, self.ops,
                                         set(feed_names) | set(fetch_names))


def _plan_accesses(op):
    """(reads, writes) of one top-level plan entry: a vjp_region (or a
    pipeline region) runs its forward ops inside it, so it reads and
    writes theirs too."""
    reads, writes = set(op.input_names()), set(op.output_names())
    if op.type in ("vjp_region", "pp_pipeline_region"):
        for i in op.attrs["fwd_ops"]:
            fop = op.block.ops[i]
            reads |= set(fop.input_names())
            writes |= set(fop.output_names())
    return reads, writes


def _release_schedule(program, plan_ops, keep):
    """For each top-level plan entry, the env names to drop after it: every
    transient at its last read or write in the plan. Kept whole: `keep`
    (feeds, fetches), persistables (the state), and names an op both reads and
    writes (an in-place update may alias a tensor the caller holds).
    Control-flow sub-blocks run in envs of their own, built from their
    op's inputs, so the top-level reads cover what they use."""
    persistable = {n for blk in program.blocks
                   for n, v in blk.vars.items() if v.persistable}
    last: Dict[str, int] = {}
    inplace = set()
    for i, op in enumerate(plan_ops):
        reads, writes = _plan_accesses(op)
        inplace |= reads & set(op.output_names())
        for n in reads | writes:
            last[n] = i
    skip = set(keep) | persistable | inplace
    release = [[] for _ in plan_ops]
    for n, i in last.items():
        if n not in skip:
            release[i].append(n)
    return [tuple(sorted(r)) for r in release]


class PreparedStep:
    """Bound (program, feed signature, fetch list, scope) handle with the
    per-call setup hoisted out: no fetch validation, no feed-signature
    hashing, no plan lookup. ≙ the JAX package's PreparedStep; here the
    hot loop is the serving engine's decode tick.

    State contract matches Executor.run: persistable state is read from the
    scope and written back after each call (read-write state in place); the
    random seed follows the same (program.random_seed, run counter)
    stream."""

    __slots__ = ("_plan", "_scope", "_owner", "_random_seed", "_b_feeds",
                 "_b_ro_vals", "_b_rw_vals", "_b_h2d_done")

    def __init__(self, plan, scope, owner, random_seed):
        self._plan = plan
        self._scope = scope
        self._owner = owner
        self._random_seed = random_seed
        self._b_feeds = None            # set by bind()
        self._b_rw_vals = None
        self._b_h2d_done = None

    @property
    def fetch_names(self):
        return list(self._plan.fetch_names)

    def run(self, feed, return_numpy=False):
        """feed: dict with EXACTLY the prepared names/shapes/dtypes (not
        re-validated). Returns the fetch list (device tensors unless
        return_numpy)."""
        plan = self._plan
        owner = self._owner
        feed_vals = tuple(owner._to_device(feed[n]) for n in plan.feed_names)
        scope = self._scope
        ro_vals = tuple(scope.get(n) for n in plan.ro_names)
        rw_vals = tuple(scope.get(n) for n in plan.rw_names)
        fetches = owner._execute(plan, feed_vals, ro_vals, rw_vals, scope,
                                 self._random_seed)
        if self._b_rw_vals is not None:
            self.refresh_state()
        if return_numpy:
            return [as_numpy(f) for f in fetches]
        return list(fetches)

    def bind(self, feed):
        """One-time setup of the bound tick: capture the caller's numpy
        feed arrays (the serving engine mutates them in place between
        ticks) with a device tensor for each, and pin the state tensors out
        of the scope. After bind(), run_bound() copies each feed to the
        device once — through a pinned host buffer on a CUDA device — and
        runs the plan.

        Contract: `feed` must hold the EXACT arrays fed forever after
        (mutate them in place; bind again if they are replaced), and state
        is pinned at bind time — swap weights in the scope -> bind() again
        (or refresh_state())."""
        plan = self._plan
        device = self._owner.device
        bound = []
        for n in plan.feed_names:
            arr = np.asarray(feed[n])
            host = torch.from_numpy(arr)            # shares arr's memory
            dev = torch.empty(host.shape, dtype=host.dtype, device=device)
            staging = (torch.empty(host.shape, dtype=host.dtype,
                                   pin_memory=True)
                       if device.type == "cuda" else None)
            bound.append((host, staging, dev))
        self._b_feeds = tuple(bound)
        self._b_h2d_done = (torch.cuda.Event() if device.type == "cuda"
                            else None)
        self.refresh_state()
        return self

    def refresh_state(self):
        """Re-point the bound state at the scope's CURRENT tensors (after
        another step or a caller replaced them in the scope)."""
        scope = self._scope
        self._b_ro_vals = tuple(scope.get(n) for n in self._plan.ro_names)
        self._b_rw_vals = tuple(scope.get(n) for n in self._plan.rw_names)
        return self

    def run_bound(self):
        """The steady-state tick over the buffers captured by bind().
        Returns the fetch tuple (device tensors); the caller synchronizes
        by reading them."""
        done = self._b_h2d_done
        if done is not None:
            # the previous tick's async copies must have left the pinned
            # buffers before they are overwritten
            done.synchronize()
        feed_vals = []
        for host, staging, dev in self._b_feeds:
            if staging is None:
                dev.copy_(host)
            else:
                staging.copy_(host)
                dev.copy_(staging, non_blocking=True)
            feed_vals.append(dev)
        if done is not None:
            done.record()
        return self._owner._execute(self._plan, tuple(feed_vals),
                                    self._b_ro_vals, self._b_rw_vals,
                                    self._scope, self._random_seed)


class Executor:
    """≙ fluid.Executor. `place` defaults to CUDAPlace(0) and raises when no
    CUDA card is visible; pass CPUPlace() to run on the CPU."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place
        self.device = resolve_device(place)
        self._cache: Dict[Any, _Plan] = {}
        self._run_counter = 0
        self._row_masks: Dict[int, torch.Tensor] = {}

    # -- planning ---------------------------------------------------------
    def _scope_avail_key(self, program: Program, scope: Scope):
        names = sorted({v.name for b in program.blocks
                        for v in b.vars.values() if v.persistable})
        return tuple(n for n in names if scope.has_var(n))

    def _analyze_state(self, program: Program, scope: Scope, feed_names,
                       fetch_names):
        block = program.global_block()
        read, written = set(), set()
        for op in block.ops:
            read |= set(op.input_names())
            written |= set(op.output_names())
        referenced = read | written | set(fetch_names)
        persistable = {v.name for b in program.blocks
                       for v in b.vars.values() if v.persistable}
        feed_set = set(feed_names)
        state_in = sorted(n for n in persistable
                          if n in referenced and scope.has_var(n)
                          and n not in feed_set)
        state_written = sorted(n for n in persistable if n in written)
        rw = sorted(set(state_in) & set(state_written))
        ro = sorted(set(state_in) - set(rw))
        out_only = sorted(set(state_written) - set(state_in))
        return ro, rw, out_only

    def _build_plan(self, program: Program, scope: Scope, feed_names,
                    fetch_names) -> _Plan:
        ro, rw, out_only = self._analyze_state(program, scope, feed_names,
                                               fetch_names)
        state_out = sorted(set(rw) | set(out_only))
        # operator fusion: a rewrite of a CLONE of the program, gated by
        # the fuse_* flags; the caller's program and the plan-cache key
        # (original program version) are untouched. On a CUDA device a
        # decode chain or a fusable recurrent op left unfused raises.
        from .passes import apply_fusion_passes
        fused = apply_fusion_passes(
            program, protected=set(fetch_names) | set(state_out),
            require_fused=self.device.type == "cuda")
        flags.vlog(1, "planning program id=%s version=%s feeds=%s "
                   "fetches=%s", id(program), program._version,
                   list(feed_names), list(fetch_names))
        return _Plan(fused, ro, rw, out_only,
                     list(feed_names), list(fetch_names))

    @staticmethod
    def _stash_flops_estimate(plan: _Plan, feed):
        """The analytic per-step model flops for the `ptpu_mfu` gauge
        (≙ the JAX executor's): the op walk of `costs.program_flops_bytes`
        over the planned program, batch dims at the fed batch."""
        from .costs import program_flops_bytes
        batch = max((np.shape(v)[0] for v in feed.values()
                     if np.ndim(v) >= 1), default=8)
        plan.flops_estimate = program_flops_bytes(
            plan.program, nominal_batch=int(batch))["flops"]

    def _validate_fetches(self, program: Program, feed, fetch_names):
        block = program.global_block()
        defined = set(feed)
        for op in block.ops:
            defined.update(op.output_names())
        for name in fetch_names:
            if name not in defined and not block.has_var(name):
                raise NotFoundError(
                    f"fetch target {name!r} is not produced by the program "
                    f"and not fed")

    def _lookup_or_plan(self, program: Program, feed: Dict[str, Any],
                        fetch_names, scope: Scope) -> _Plan:
        self._validate_fetches(program, feed, fetch_names)
        key = (id(program), program._version, _feed_signature(feed),
               tuple(fetch_names), id(scope),
               self._scope_avail_key(program, scope), _fusion_flags_key())
        plan = self._cache.get(key)
        if plan is None:
            # the span keeps the JAX package's name: here it covers the
            # plan build (fusion passes on a clone + the state analysis)
            with _tracing.span("compile", "executor/trace_and_compile",
                               program_version=program._version,
                               n_fetches=len(fetch_names)):
                plan = self._build_plan(program, scope, list(feed.keys()),
                                        fetch_names)
                self._stash_flops_estimate(plan, feed)
            self._cache[key] = plan
        return plan

    def _synthesize_batch_mask(self, program: Program,
                               feed: Dict[str, Any]) -> Dict[str, Any]:
        """≙ the JAX executor's `_synthesize_batch_mask`: when the program
        declares the batch-row mask (layers.batch_row_mask) and the caller
        did not feed it, feed all-ones of the batch length — every row of
        a directly run batch is real. The mask is made on the device once
        per batch length and reused, so it costs no copy a step."""
        if (BATCH_ROW_MASK_NAME not in program.global_block().vars
                or BATCH_ROW_MASK_NAME in feed):
            return feed
        bs = next((np.shape(v)[0] for v in feed.values()
                   if np.ndim(v) >= 1), None)
        if bs is not None:
            mask = self._row_masks.get(bs)
            if mask is None:
                mask = self._row_masks[bs] = torch.ones(
                    bs, dtype=torch.float32, device=self.device)
            feed[BATCH_ROW_MASK_NAME] = mask
        return feed

    # -- execution --------------------------------------------------------
    def _to_device(self, v) -> torch.Tensor:
        t = torch.as_tensor(v) if not isinstance(v, torch.Tensor) else v
        if t.dtype == torch.float64:
            t = t.float()     # float feeds run in float32, as in jax
        return t.to(self.device)

    def _step_seed(self, seed: int) -> int:
        """The seed one step's draws use (ParallelExecutor gives each dp
        rank its own)."""
        return seed

    def _step_extras(self, plan: _Plan) -> Dict[str, Any]:
        """Run-wide values for the lowerings beyond the program
        (ParallelExecutor's batch-global op overrides and gradient
        all-reduce, lowering.py `run_op` / `run_vjp_region`)."""
        return {}

    def _execute(self, plan: _Plan, feed_vals, ro_vals, rw_vals,
                 scope: Scope, random_seed: int):
        env = self._run_env(plan, feed_vals, ro_vals, rw_vals, random_seed)
        self._write_back(plan, env, scope)
        return tuple(env[n] for n in plan.fetch_names)

    def _run_env(self, plan: _Plan, feed_vals, ro_vals, rw_vals,
                 random_seed: int) -> Dict[str, Any]:
        """Run the plan's ops over the state and feeds; returns the
        environment (every value the plan defined, by name)."""
        self._run_counter += 1
        ctx = LowerCtx(device=self.device,
                       seed=self._step_seed(
                           _run_seed(random_seed, self._run_counter)),
                       constants=plan.constants,
                       fetch_names=tuple(plan.fetch_names),
                       read_names=plan.read_names,
                       extras={"program": plan.program,
                               **self._step_extras(plan)})
        env: Dict[str, Any] = {}
        env.update(zip(plan.ro_names, ro_vals))
        env.update(zip(plan.rw_names, rw_vals))
        env.update(zip(plan.feed_names, feed_vals))
        for name, dtype, staging in plan.staged_feeds:
            env[name] = _unstage(name, env[name], dtype, staging)
        with torch.no_grad():
            run_plan(plan.ops, env, ctx, plan.release)
        return env

    @staticmethod
    def _write_back(plan: _Plan, env: Dict[str, Any], scope: Scope):
        """Scope write-back: read-write state was updated in place, so
        this re-stores the same tensors; write-only state lands here."""
        sv = scope._vars
        for name in plan.state_out_names:
            sv[name] = env[name]

    @staticmethod
    def _note_run_memory(plan: _Plan, ro_vals, rw_vals, step_s: float,
                         steps: int = 1):
        """Per-run memory / utilization sample (≙ the JAX executor's
        `_note_run_memory`): the `device_state_bytes` watermark (the plan's
        state bytes, counted once per plan from the tensors' metadata) and
        the `ptpu_mfu` gauge, the plan's model flops over the run's host
        wall time. As in the JAX package, only a step that updates state
        publishes MFU, and not its plan's first run (warm-up). No device
        sync: on a card the window is the host's dispatch of the step,
        which a host-bound step's device time keeps up with."""
        sb = plan.census_state_bytes
        if sb is None:
            sb = plan.census_state_bytes = sum(
                _memory.per_device_bytes(v) for v in ro_vals + rw_vals)
        _memory.update_watermark("device_state_bytes", sb)
        if plan.flops_estimate and step_s > 0 and plan.rw_names:
            if plan.mfu_warm:
                _memory.note_mfu(plan.flops_estimate * steps, step_s)
            else:
                plan.mfu_warm = True

    def run(self,
            program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
            scope: Optional[Scope] = None,
            return_numpy: bool = True):
        """≙ Executor.run. Missing fetch vars raise."""
        program = program or default_main_program()
        feed = self._synthesize_batch_mask(program, dict(feed or {}))
        scope = scope or global_scope()
        fetch_names = _fetch_names(fetch_list)
        plan = self._lookup_or_plan(program, feed, fetch_names, scope)
        t0 = time.time()
        with _tracing.span("feed_fetch", "executor/feed",
                           n_feeds=len(plan.feed_names)):
            feed_vals = tuple(self._to_device(feed[n])
                              for n in plan.feed_names)
            ro_vals = tuple(scope.get(n) for n in plan.ro_names)
            rw_vals = tuple(scope.get(n) for n in plan.rw_names)
        with _tracing.span("step", "executor/run",
                           program_version=program._version):
            env = self._run_env(plan, feed_vals, ro_vals, rw_vals,
                                program.random_seed)
        with _tracing.span("feed_fetch", "executor/state_writeback",
                           n_state=len(plan.state_out_names)):
            self._write_back(plan, env, scope)
        self._note_run_memory(plan, ro_vals, rw_vals, time.time() - t0)
        fetches = tuple(env[n] for n in plan.fetch_names)
        if return_numpy:
            return [as_numpy(f) for f in fetches]
        return list(fetches)

    def run_steps(self,
                  feed_list: Sequence[Dict[str, Any]],
                  fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
                  program: Optional[Program] = None,
                  scope: Optional[Scope] = None,
                  return_numpy: bool = True):
        """Run len(feed_list) steps of `program` in one call (≙ the JAX
        executor's `run_steps`, which scans one compiled step over the
        stacked feeds). All feeds share one signature. Returns a list over
        fetch_list of values stacked over steps (the per-step loss curve,
        say); read-write state ends as after the last step, and write-only
        state holds the last step's value.

        The plan is built once; the feeds are stacked and copied to the
        device in one transfer per name; each step reads its slice and
        writes its state back to the scope on the device, so no step
        waits on the host. A fetched tensor that a later step updates in
        place is copied on the device; the stacked fetches cross to the
        host once, after the last step."""
        program = program or default_main_program()
        enforce(len(feed_list) >= 1, "run_steps needs at least one feed",
                exc=InvalidArgumentError)
        feed_list = [self._synthesize_batch_mask(program, dict(f))
                     for f in feed_list]
        sig0 = _feed_signature(feed_list[0])
        for f in feed_list[1:]:
            enforce(_feed_signature(f) == sig0,
                    "run_steps feeds must share one signature "
                    "(same names, shapes, dtypes)",
                    exc=InvalidArgumentError)
        scope = scope or global_scope()
        fetch_names = _fetch_names(fetch_list)
        plan = self._lookup_or_plan(program, feed_list[0], fetch_names,
                                    scope)
        t0 = time.time()
        with _tracing.span("feed_fetch", "executor/feed",
                           n_feeds=len(plan.feed_names), steps=len(feed_list)):
            stacks = [self._feed_stack([f[n] for f in feed_list])
                      for n in plan.feed_names]
        updated = set(plan.rw_names)
        per_step = []
        with _tracing.span("step", "executor/run_steps",
                           steps=len(feed_list)):
            for i in range(len(feed_list)):
                ro_vals = tuple(scope.get(n) for n in plan.ro_names)
                rw_vals = tuple(scope.get(n) for n in plan.rw_names)
                env = self._run_env(plan, tuple(s[i] for s in stacks),
                                    ro_vals, rw_vals, program.random_seed)
                self._write_back(plan, env, scope)
                per_step.append(tuple(
                    env[n].clone() if n in updated else env[n]
                    for n in plan.fetch_names))
        self._note_run_memory(plan, ro_vals, rw_vals, time.time() - t0,
                              steps=len(feed_list))
        fetches = [torch.stack([torch.as_tensor(step[j]) for step in per_step])
                   for j in range(len(plan.fetch_names))]
        if return_numpy:
            return [as_numpy(f) for f in fetches]
        return fetches

    def _feed_stack(self, values) -> torch.Tensor:
        """k same-shaped feeds as one [k, ...] device tensor: one copy."""
        if all(isinstance(v, torch.Tensor) for v in values):
            return self._to_device(torch.stack(
                [v.to(self.device) for v in values]))
        return self._to_device(np.stack([np.asarray(v) for v in values]))

    def prepare(self,
                program: Optional[Program] = None,
                feed: Optional[Dict[str, Any]] = None,
                fetch_list: Optional[Sequence[Union[str, Variable]]] = None,
                scope: Optional[Scope] = None) -> PreparedStep:
        """Plan (or fetch from cache) the step for this exact (program,
        feed signature, fetch list, scope) and return a PreparedStep whose
        run() skips every per-call setup cost. `feed` is an EXAMPLE feed
        carrying the signature every later call must match."""
        program = program or default_main_program()
        feed = self._synthesize_batch_mask(program, dict(feed or {}))
        fetch_names = _fetch_names(fetch_list)
        scope = scope or global_scope()
        plan = self._lookup_or_plan(program, feed, fetch_names, scope)
        return PreparedStep(plan, scope, self, program.random_seed)

    # -- analyses (≙ the JAX executor's, with its keys) --------------------
    def cost_analysis(self, program=None, feed=None, fetch_list=None,
                      scope=None):
        """Flops and bytes of one step of `program` for this feed: the
        port's own count over the planned (fused) program at the feed's
        batch (`costs.program_flops_bytes`: every op's flops and the bytes
        it reads and writes, from the declared shapes), where the JAX
        package reads XLA's cost analysis of the compiled step. Keys
        "flops" and "bytes accessed" as XLA's, "optimal_seconds" the
        roofline sum at the card's constants. Plans if needed."""
        from .costs import program_flops_bytes
        program = program or default_main_program()
        feed = self._synthesize_batch_mask(program, dict(feed or {}))
        scope = scope or global_scope()
        plan = self._lookup_or_plan(program, feed, _fetch_names(fetch_list),
                                    scope)
        batch = next((int(np.shape(v)[0]) for v in feed.values()
                      if np.ndim(v) >= 1), 8)
        c = program_flops_bytes(plan.program, nominal_batch=batch)
        return {"flops": c["flops"], "bytes accessed": c["bytes"],
                "optimal_seconds": c["roofline_s"], "source": "program"}

    def memory_analysis(self, program=None, feed=None, fetch_list=None,
                        scope=None):
        """Measured memory of one step: argument / output / temp / alias
        bytes (`observability.memory.executable_memory`: the caching
        allocator's peak over one step run on copies of the read-write
        state on a card, the lifetime walk on the CPU). The scope is not
        changed. Updates the `executor_temp_bytes` watermark."""
        program = program or default_main_program()
        stats = _memory.executable_memory(self, program, feed, fetch_list,
                                          scope or global_scope())
        _memory.update_watermark("executor_temp_bytes", stats["temp_bytes"])
        return stats

    def memory_census(self, feed=None, program=None, scope=None,
                      kv_names=(), fetch_list=None):
        """The full measured memory census of one step
        (`observability.memory.device_memory_census`): state bytes by
        category from the scope's tensors, feed bytes, the step's
        argument / output / temp / alias figures and the live-tensor
        sweep."""
        return _memory.device_memory_census(
            self, dict(feed or {}), scope or global_scope(),
            program=program, fetch_list=fetch_list, kv_names=kv_names)

    def close(self):
        """≙ Executor::Close — drop cached plans."""
        self._cache.clear()
