"""Memory + utilization observability: watermarks and MFU.

≙ paddle_tpu/observability/memory.py, the part the serving engines and
the executor feed:

- **watermarks** (`update_watermark`): live per-channel high-water
  marks — device state, KV cache (reserved and used), the host tier's
  KV and staging bytes — each update records a `memory`-channel counter
  sample (Chrome counter track via `tracing.record_counter`) and backs
  the `ptpu_memory_*` gauges in `metrics.default_registry()`, so one
  /metrics scrape and /healthz both carry the memory board;
- **MFU** (`note_mfu`): predicted flops over measured step time as the
  `ptpu_mfu` gauge, a fraction of the card's dense bfloat16 peak
  (`costs.mfu`, `costs.H100_PEAK_FLOPS`);
- `per_device_bytes`: the bytes of one tensor (`numel × element_size`);
- `state_census`: a plan's state bytes by category (params, optimizer
  state, KV caches, ...), from the tensors' metadata;
- the measured census of one step (`executable_memory`,
  `device_memory_census`, `live_array_census`), with the JAX package's
  keys. Where the JAX package reads XLA's buffer assignment, the port
  runs the step once on copies of its read-write state (the scope is not
  touched) between `torch.cuda.reset_peak_memory_stats` and
  `max_memory_allocated`; on the CPU, where torch keeps no allocator
  statistics, the temp figure is the lifetime walk
  (`analysis.peak_live_bytes` at the feed's batch), as the JAX package
  falls back to its HLO liveness walk. `temp_source` / `source` say which
  gave each figure. For `jax.live_arrays()` the port sweeps what it can
  name: the scope's tensors and the executor's cached tensors, beside the
  allocator's total on a card.

The watermark updates are host arithmetic on numbers the caller already
holds: none reads a device tensor, so none adds a host sync to a tick. The
census runs a step and synchronizes: it is a measurement, off the step's
path.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Sequence

import numpy as np

from ..core.enforce import InvalidArgumentError

#: the watermark channels (fixed set: a typo'd channel raises instead of
#: minting a gauge no scrape ever finds)
CHANNELS = ("device_state_bytes", "executor_temp_bytes",
            "kv_cache_bytes", "kv_cache_used_bytes",
            "host_staging_bytes", "host_kv_bytes",
            "host_optimizer_bytes")

_lock = threading.Lock()
_marks: Dict[str, Dict[str, float]] = {
    c: {"current": 0.0, "peak": 0.0} for c in CHANNELS}
_mfu = {"value": 0.0, "flops": 0.0, "step_s": 0.0}
_metrics = None


def memory_metrics():
    """The memory/utilization series, registered (idempotently) into
    `metrics.default_registry()` — `ptpu_memory_<channel>` (current
    level), `ptpu_memory_watermark_bytes{channel=...}` (high-water), and
    `ptpu_mfu`."""
    global _metrics
    if _metrics is None:
        from . import metrics as m
        r = m.default_registry()
        out: Dict[str, Any] = {}
        for c in CHANNELS:
            out[c] = m.get_or_create(
                r, "gauge", f"ptpu_memory_{c}",
                f"Current {c.replace('_', ' ')} (memory census channel).",
                fn=(lambda c=c: _marks[c]["current"]))
            out[f"{c}_peak"] = m.get_or_create(
                r, "gauge", "ptpu_memory_watermark_bytes",
                "Per-channel high-water mark of the memory census.",
                labels={"channel": c},
                fn=(lambda c=c: _marks[c]["peak"]))
        out["mfu"] = m.get_or_create(
            r, "gauge", "ptpu_mfu",
            "Model-flops utilization: predicted step flops over measured "
            "step time, fraction of the hardware peak.",
            fn=(lambda: _mfu["value"]))
        _metrics = out
    return _metrics


def update_watermark(channel: str, value: float):
    """Set a channel's current level; the high-water mark ratchets.
    When tracing is enabled the sample also lands on the ring as a
    `memory/<channel>` counter event. This is the executor's per-step
    hot path — no eager f-strings, one dict probe for the channel
    check."""
    m = _marks.get(channel)
    if m is None:
        raise InvalidArgumentError(
            f"unknown memory channel {channel!r}; known: "
            f"{list(CHANNELS)}")
    if _metrics is None:
        memory_metrics()
    v = float(value)
    with _lock:
        m["current"] = v
        if v > m["peak"]:
            m["peak"] = v
    from . import tracing as _tracing
    if _tracing.enabled():
        _tracing.record_counter("memory/" + channel, v)


def note_mfu(flops: float, step_s: float):
    """One measured step: flops over wall seconds -> the `ptpu_mfu`
    gauge (+ a `memory/mfu` counter sample when tracing). The executor
    passes its run's host window (no device sync, as the JAX package's
    dispatch window)."""
    from ..framework import costs as _costs
    memory_metrics()
    with _lock:
        _mfu["flops"] = float(flops)
        _mfu["step_s"] = float(step_s)
        _mfu["value"] = _costs.mfu(flops, step_s)
    from . import tracing as _tracing
    _tracing.record_counter("memory/mfu", _mfu["value"])


def watermark_board() -> Dict[str, Dict[str, float]]:
    """{channel: {current, peak}} + the last MFU reading — what
    /healthz embeds as the memory board."""
    with _lock:
        out: Dict[str, Any] = {c: dict(v) for c, v in _marks.items()}
        out["mfu"] = dict(_mfu)
    return out


def reset_watermarks():
    """Test isolation: zero every channel and the MFU reading."""
    with _lock:
        for v in _marks.values():
            v["current"] = v["peak"] = 0.0
        _mfu.update(value=0.0, flops=0.0, step_s=0.0)


def per_device_bytes(val) -> float:
    """Bytes of one value on its device: `numel × element_size` for a
    torch tensor (read from its metadata, no device access), `nbytes`
    for a numpy array."""
    numel = getattr(val, "numel", None)
    if callable(numel):
        return float(numel() * val.element_size())
    return float(getattr(val, "nbytes", 0) or 0)


def state_census(scope, program, names: Sequence[str],
                 kv_names: Sequence[str] = ()) -> Dict:
    """Measured state bytes by category for the named scope vars (a plan's
    read-only + read-write lists), ≙ the JAX package's `state_census`:
    params / params_quantized / params_draft / optimizer_state /
    ef_residual / kv_cache / other_state, each summed from the tensors'
    own bytes (`per_device_bytes`, metadata only: no device access).
    `kv_names` marks the serving engine's cache vars, which are plain
    persistables to the program."""
    from ..framework.costs import state_category
    kv = set(kv_names)
    cats: Dict[str, float] = {"params": 0.0, "params_quantized": 0.0,
                              "params_draft": 0.0,
                              "optimizer_state": 0.0, "ef_residual": 0.0,
                              "kv_cache": 0.0, "other_state": 0.0}
    per_var: Dict[str, Dict] = {}
    for name in names:
        if not scope.has_var(name):
            continue
        nb = per_device_bytes(scope.get(name))
        v = next((b.var(name) for b in program.blocks if b.has_var(name)),
                 None)
        if name in kv:
            cat = "kv_cache"
        else:
            cat = state_category(v, name) if v is not None else "other_state"
        cats[cat] += nb
        per_var[name] = {"category": cat, "per_device_bytes": nb}
    cats["state_total"] = sum(cats.values())
    return {"categories": cats, "per_var": per_var}


def _tensor_bytes(t) -> float:
    return per_device_bytes(t) if hasattr(t, "element_size") else 0.0


def _executor_cached(executor):
    """Tensors the executor keeps between runs: its batch-row masks and
    each plan's attribute-built constants."""
    import torch
    out = list(getattr(executor, "_row_masks", {}).values())
    for plan in getattr(executor, "_cache", {}).values():
        for c in plan.constants.values():
            out.extend(c if isinstance(c, (tuple, list)) else (c,))
    return [t for t in out if isinstance(t, torch.Tensor)]


def live_array_census(scope=None, tracked_names: Sequence[str] = (),
                      executor=None, device=None) -> Dict:
    """The tensors the process holds, split into scope-tracked and
    untracked bytes (≙ the JAX package's sweep of `jax.live_arrays()`).
    Tracked: the scope's tensors (`tracked_names`, or every name), each
    storage once. Untracked: the executor's cached tensors, and on a CUDA
    `device` everything else the caching allocator has handed out
    (`memory_allocated` less the tracked and cached bytes: fetches the
    caller holds, autograd's leftovers). On the CPU the committed figure
    is the sum of what was named (`source` says which)."""
    import torch
    seen = set()

    def add(t):
        key = (t.device, t.untyped_storage().data_ptr())
        if key in seen:
            return 0.0
        seen.add(key)
        return float(t.untyped_storage().nbytes())

    tracked = 0.0
    n = 0
    if scope is not None:
        for name in (tracked_names or scope.local_var_names()):
            if scope.has_var(name):
                v = scope.get(name)
                if isinstance(v, torch.Tensor):
                    tracked += add(v)
                    n += 1
    cached = 0.0
    for t in (_executor_cached(executor) if executor is not None else ()):
        cached += add(t)
        n += 1
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        total = float(torch.cuda.memory_allocated(dev))
        source = "cuda_allocator"
    else:
        total = tracked + cached
        source = "named_tensors"
    return {"live_arrays": n, "committed_bytes": total,
            "tracked_bytes": tracked,
            "untracked_bytes": total - tracked, "source": source}


def _state_copies(plan, scope):
    """(read-only, read-write) state tensors for a census step: the
    read-write ones copied, so the step's in-place updates land on the
    copies and the scope stays as it was."""
    return (tuple(scope.get(n) for n in plan.ro_names),
            tuple(scope.get(n).clone() for n in plan.rw_names))


def _step_on(executor, plan, feed_vals, ro_vals, rw_vals):
    """Run `plan` once over the given state, leaving the run-seed stream
    as it was. Returns the env."""
    counter = executor._run_counter
    try:
        return executor._run_env(plan, feed_vals, ro_vals, rw_vals,
                                 getattr(plan.program, "random_seed", 0))
    finally:
        executor._run_counter = counter


def executable_memory(executor, program=None, feed=None, fetch_list=None,
                      scope=None) -> Dict:
    """Per-device memory of one step of `program` on `executor` (≙ the JAX
    package's figures from XLA's buffer assignment; same keys):

      argument_bytes  the step's inputs: read-only and read-write state
                      plus the feeds on the device
      output_bytes    what it writes that outlives it: the fetches and the
                      state it writes
      alias_bytes     outputs written into an input's own tensor (the
                      read-write state, updated in place)
      temp_bytes      the step's transient peak: on a CUDA device the
                      allocator's peak during one step (run on copies of
                      the read-write state, made before the window
                      opens, between reset_peak_memory_stats and
                      max_memory_allocated) above what was allocated at
                      its start, less the non-aliased outputs; on the CPU
                      the lifetime walk over the planned program at the
                      feed's batch
      generated_code_bytes  0 (the port runs no compiled executable; its
                      kernels' code is not device data)

    `temp_source` names the source: "cuda_allocator" or "lifetime_walk".
    Plans the step if needed; the scope is not changed."""
    import torch
    from ..framework.analysis import peak_live_bytes
    from ..framework.executor import _fetch_names
    from ..framework.program import default_main_program
    from ..framework.scope import global_scope
    program = program or default_main_program()
    scope = scope or global_scope()
    feed = executor._synthesize_batch_mask(program, dict(feed or {}))
    fetch_names = _fetch_names(fetch_list)
    plan = executor._lookup_or_plan(program, feed, fetch_names, scope)
    feed_vals = tuple(executor._to_device(feed[n]) for n in plan.feed_names)
    state_in = [scope.get(n) for n in plan.ro_names + plan.rw_names]
    argument = sum(_tensor_bytes(t) for t in state_in) + sum(
        _tensor_bytes(t) for t in feed_vals)
    alias = sum(_tensor_bytes(scope.get(n)) for n in plan.rw_names)
    dev = executor.device
    ro_vals, rw_vals = _state_copies(plan, scope)
    if dev.type == "cuda":
        # the window opens after the copies: they stand in for the state
        # the step updates in place, and are no part of its transients
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        env = _step_on(executor, plan, feed_vals, ro_vals, rw_vals)
        torch.cuda.synchronize(dev)
        peak = torch.cuda.max_memory_allocated(dev)
    else:
        env = _step_on(executor, plan, feed_vals, ro_vals, rw_vals)
    outs = {n: env[n] for n in set(plan.fetch_names) | set(
        plan.state_out_names) if n in env}
    output = sum(_tensor_bytes(t) for t in outs.values())
    if dev.type == "cuda":
        temp = max(0.0, float(peak - start) - (output - alias))
        source = "cuda_allocator"
    else:
        batch = next((int(np.shape(v)[0]) for v in feed.values()
                      if np.ndim(v) >= 1), 8)
        temp = float(peak_live_bytes(
            program, nominal_batch=batch)["peak_transient_bytes"])
        source = "lifetime_walk"
    del env, outs, rw_vals
    return {"argument_bytes": int(argument), "output_bytes": int(output),
            "temp_bytes": int(temp), "alias_bytes": int(alias),
            "generated_code_bytes": 0, "temp_source": source}


def device_memory_census(executor, feed: Dict[str, Any], scope, *,
                         program=None, fetch_list=None, dp: int = 1,
                         kv_names: Sequence[str] = ()) -> Dict:
    """The full measured memory census of one step (≙ the JAX package's;
    the ledger's measured side, same keys):

      state     bytes by category of the step's read-only and read-write
                scope tensors (`state_census`)
      feeds     bytes of the feeds as the device holds them (a float64
                feed runs as float32); batch-led feeds split over dp
      seed_bytes  0: the port's step seed is a host integer (the JAX
                package passes a 4-byte uint32 argument)
      xla       `executable_memory` of the same step (argument / output
                / temp / alias; the key keeps the JAX package's name)
      live      `live_array_census`
      peak_bytes  argument + temp + non-aliased output bytes
      host_tier   the pinned host pool's ledger rows

    Updates the `device_state_bytes` and `executor_temp_bytes`
    watermarks with what it measured. The scope is not changed."""
    from ..framework import offload as _offload
    from ..framework.executor import _fetch_names
    from ..framework.program import default_main_program
    program = program or default_main_program()
    feed = executor._synthesize_batch_mask(program, dict(feed or {}))
    plan = executor._lookup_or_plan(program, feed, _fetch_names(fetch_list),
                                    scope)
    st = state_census(scope, plan.program,
                      sorted(set(plan.ro_names) | set(plan.rw_names)),
                      kv_names=kv_names)
    feed_bytes = 0.0
    per_feed = {}
    for name in plan.feed_names:
        nb = _tensor_bytes(executor._to_device(feed[name]))
        shape = None
        for b in plan.program.blocks:
            if b.has_var(name):
                shape = getattr(b.var(name), "shape", None)
                break
        batch_led = shape is None or (bool(shape) and shape[0] == -1)
        if batch_led and dp > 1:
            nb /= dp
        per_feed[name] = {"per_device_bytes": nb, "batch_led": batch_led}
        feed_bytes += nb
    xla = executable_memory(executor, program, feed, fetch_list, scope)
    peak = (xla["argument_bytes"] + xla["temp_bytes"]
            + max(0, xla["output_bytes"] - xla["alias_bytes"]))
    update_watermark("device_state_bytes", st["categories"]["state_total"])
    update_watermark("executor_temp_bytes", xla["temp_bytes"])
    return {
        "state": st,
        "feeds": {"per_device_bytes": feed_bytes, "per_feed": per_feed,
                  "dp": dp},
        "seed_bytes": 0,
        "xla": xla,
        "live": live_array_census(scope, executor=executor,
                                  device=executor.device),
        "peak_bytes": peak,
        "host_tier": _offload.shared_host_pool().rows(),
    }
