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
  `ptpu_mfu` gauge, a fraction of the H100's dense bfloat16 peak;
- `per_device_bytes`: the bytes of one tensor (`numel × element_size`);
- `state_census`: a plan's state bytes by category (params, optimizer
  state, KV caches, ...), from the tensors' metadata.

Every update is host arithmetic on numbers the caller already holds: no
call here reads a device tensor, so none adds a host sync to a tick.

`live_array_census`, `executable_memory` and `device_memory_census` (the
JAX package's census over XLA's buffer assignment and `jax.live_arrays`)
wait for ROADMAP.md §1 item 4 and raise NotImplementedError naming it.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Sequence

from ..core.enforce import InvalidArgumentError

#: the watermark channels (fixed set: a typo'd channel raises instead of
#: minting a gauge no scrape ever finds)
CHANNELS = ("device_state_bytes", "executor_temp_bytes",
            "kv_cache_bytes", "kv_cache_used_bytes",
            "host_staging_bytes", "host_kv_bytes",
            "host_optimizer_bytes")

#: dense bfloat16 tensor-core peak of one H100 SXM (NVIDIA's data sheet),
#: the MFU denominator
H100_BF16_PEAK_FLOPS = 989e12

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


def mfu(flops: float, step_s: float,
        peak_flops: float = H100_BF16_PEAK_FLOPS) -> float:
    """Model-flops utilization: `flops` done in `step_s` seconds as a
    fraction of `peak_flops` (default: the H100's dense bfloat16 peak)."""
    if step_s <= 0 or peak_flops <= 0:
        return 0.0
    return float(flops) / float(step_s) / float(peak_flops)


def note_mfu(flops: float, step_s: float):
    """One measured step: flops over wall seconds -> the `ptpu_mfu`
    gauge (+ a `memory/mfu` counter sample when tracing). `step_s` must
    come from a window that ends in a device synchronization."""
    memory_metrics()
    with _lock:
        _mfu["flops"] = float(flops)
        _mfu["step_s"] = float(step_s)
        _mfu["value"] = mfu(flops, step_s)
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


_ITEM4 = ("is not ported yet: it is the device-memory census of ROADMAP.md "
          "§1 item 4 (observability)")


def live_array_census(*args, **kwargs):
    """≙ the JAX package's sweep of `jax.live_arrays()`: not ported."""
    raise NotImplementedError("live_array_census " + _ITEM4)


def executable_memory(*args, **kwargs):
    """≙ the JAX package's XLA buffer-assignment figures: not ported."""
    raise NotImplementedError("executable_memory " + _ITEM4)


def device_memory_census(*args, **kwargs):
    """≙ the JAX package's full measured census of a compiled step: not
    ported."""
    raise NotImplementedError("device_memory_census " + _ITEM4)
