"""Profiler: ≙ paddle_tpu/profiler.py (itself ≙ fluid.profiler).

The recorder is `paddle_tpu_torch.observability.tracing`: one span ring
shared with the executor and the serving engines. `profiler(...)` /
`start_profiler` open a window on the ring (force-enabling it, so
profiling works with PTPU_TRACE=0), `print_profiler_summary` aggregates
the window's spans by name, and `export_chrome_tracing` writes them as one
Chrome trace, as in the JAX package.

The device timeline: where the JAX package starts a `jax.profiler` trace,
the port starts `torch.profiler` with the CUDA activity (CUPTI) whenever a
CUDA device is visible and the state asks for the device ("GPU" / "All" /
"TPU"), and sets `tracing.annotation_factory` to
`torch.profiler.record_function`, so every span of the window is also a
range on the profiler's timeline. `stop_profiler` stops it (the one host
sync the profiler adds) and keeps its device events: kernels, copies and
sets, each on a device lane; `export_chrome_tracing` merges them with the
span ring into one trace. With a
`trace_dir`, the torch.profiler trace is also written there whole. On the
CPU (no card) the window holds the host spans only, as the JAX package's
without a trace dir.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Optional

from .core import flags
from .core.enforce import InvalidArgumentError, enforce
from .observability import tracing as _tracing

_enabled = False
_forced = False           # we hold one tracing.force_enable(True) ref
_trace_dir: Optional[str] = None
_device_tracing = False
_window_mark = 0          # ring position where the current window began
_torch_prof = None        # the running torch.profiler.profile, if any
_device_events: list = []  # the last device window's events (Chrome form)


class RecordEvent(_tracing.span):
    """RAII scope annotation (≙ platform::RecordEvent, profiler.h:73) —
    a thin alias over the observability span API (kind 'user'). Nesting
    shows up in the Chrome trace via overlapping ts/dur spans and in the
    span's parent/depth attribution.

    While a device trace is active, the same name is also entered as a
    torch.profiler.record_function, so it appears on the profiler's
    timeline beside the kernels launched inside the scope (the reference's
    CUPTI correlation, device_tracer.h:49)."""

    def __init__(self, name: str):
        super().__init__("user", name)


record_event = RecordEvent  # snake_case alias used by layers/executor


def reset_profiler():
    """≙ fluid.profiler.reset_profiler — drop all recorded events (the
    summary/export window restarts here; the tracer ring itself keeps
    spans for observability consumers)."""
    global _window_mark
    _window_mark = _tracing.mark()


def reset():
    """Full state reset for test isolation: disable recording, release
    the force-enable ref, detach the device-annotation factory, and
    restart the window. Safe to call at any point, any number of times
    (tests/conftest.py runs it around every test so neither recorded
    events nor the enabled bit bleed between suites)."""
    global _enabled, _forced, _device_tracing, _trace_dir, _torch_prof
    if _forced:
        _tracing.force_enable(False)
        _forced = False
    if _torch_prof is not None:
        prof, _torch_prof = _torch_prof, None
        try:
            prof.stop()
        except Exception:  # noqa: BLE001 — already stopped
            pass
    _enabled = False
    _device_tracing = False
    _trace_dir = None
    _tracing.annotation_factory = None
    _device_events.clear()
    reset_profiler()


def _start_device_trace():
    """torch.profiler with the CUDA activity (CUPTI) and the CPU activity
    (the record_function ranges and the launches), started now."""
    global _torch_prof, _device_tracing
    from torch.profiler import ProfilerActivity, profile, record_function
    _torch_prof = profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA])
    _torch_prof.start()
    _device_tracing = True
    _tracing.annotation_factory = record_function
    _device_events.clear()


def _stop_device_trace():
    """Stop the torch.profiler window (it synchronizes the device) and
    keep its device events in Chrome form, each lane's pid shifted past the
    host's (pid 0). With a trace dir, also write its whole trace there."""
    global _torch_prof
    import tempfile
    prof, _torch_prof = _torch_prof, None
    prof.stop()
    trace_dir = _trace_dir or os.environ.get("PTPU_TRACE_DIR")
    fd, tmp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        with open(tmp) as f:
            data = json.load(f)
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
            os.replace(tmp, os.path.join(trace_dir, "device_trace.json"))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    _device_events[:] = _device_trace_events(data)


def _device_trace_events(data):
    """The device lanes of a torch.profiler Chrome trace: kernels, copies
    and sets (and their lanes' metadata), pids shifted up by 1 so they
    never collide with the host spans' pid 0."""
    keep = ("kernel", "gpu_memcpy", "gpu_memset")
    out, pids = [], set()
    for ev in data.get("traceEvents", []):
        if isinstance(ev, dict) and ev.get("cat") in keep and "ts" in ev:
            ev = dict(ev)
            ev["pid"] = int(ev.get("pid", 0)) + 1 if str(
                ev.get("pid", "0")).isdigit() else 1
            pids.add(ev["pid"])
            out.append(ev)
    for pid in sorted(pids):
        out.append({"ph": "M", "name": "process_name", "pid": pid,
                    "args": {"name": f"device{pid - 1}"}})
    return out



def start_profiler(state: str = "All", tracer_option: Optional[str] = None):
    """Enable host-event recording; states 'GPU' / 'All' / 'TPU' also start
    the torch.profiler device trace when a CUDA device is visible.

    ≙ EnableProfiler (reference profiler.h:116; states CPU/GPU/All map to
    host-only vs host+device here).
    """
    global _enabled, _forced, _trace_dir, _device_tracing, _window_mark
    enforce(state in ("CPU", "GPU", "All", "TPU"),
            f"invalid profiler state {state!r}", exc=InvalidArgumentError)
    if not _enabled:
        _window_mark = _tracing.mark()
    _enabled = True
    if not _forced:
        _tracing.force_enable(True)
        _forced = True
    if state in ("GPU", "All", "TPU") and _torch_prof is None:
        import torch
        if torch.cuda.is_available():
            _start_device_trace()


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None):
    """Disable recording, print the per-event summary table, optionally
    dump a Chrome trace JSON to profile_path (≙ DisableProfiler
    profiler.h:119 + tools/timeline.py)."""
    global _enabled, _forced, _device_tracing
    if not _enabled:
        return
    _enabled = False
    if _forced:
        _tracing.force_enable(False)
        _forced = False
    _device_tracing = False
    _tracing.annotation_factory = None
    if _torch_prof is not None:
        _stop_device_trace()
    if profile_path:
        export_chrome_tracing(profile_path)
    print_profiler_summary(sorted_key or "default")


def _window_spans():
    spans = _tracing.spans_since(_window_mark)
    # the recorder is a bounded ring (PTPU_TRACE_RING, default 65536);
    # a window longer than that has lost its oldest events — say so
    # instead of printing a silently-truncated report (the pre-r12
    # profiler kept an unbounded list)
    if len(spans) >= int(flags.get_flag("trace_ring")):
        print("[profiler] span ring capacity reached: oldest events in "
              "this window were dropped — raise PTPU_TRACE_RING to keep "
              "longer windows")
    return spans


def print_profiler_summary(sorted_key: str = "default"):
    """Aggregate the window's spans by name: calls, total/min/max/avg ms
    (≙ the reference's sorted profiling report, profiler.cc
    PrintProfiler)."""
    enforce(sorted_key in ("default", "calls", "total", "max", "min", "ave"),
            f"invalid sorted_key {sorted_key!r}", exc=InvalidArgumentError)
    agg = _tracing.aggregate(_window_spans())
    if not agg:
        print("[profiler] no events recorded")
        return
    key = {"default": "total_ms", "calls": "calls", "total": "total_ms",
           "max": "max_ms", "min": "min_ms", "ave": "avg_ms"}[sorted_key]
    rows = sorted(agg.items(), key=lambda kv: -kv[1][key])
    hdr = f"{'Event':<44} {'Calls':>7} {'Total(ms)':>11} {'Max':>9} " \
          f"{'Min':>9} {'Ave':>9}"
    print("-" * len(hdr))
    print(hdr)
    print("-" * len(hdr))
    for name, r in rows:
        print(f"{name[:44]:<44} {r['calls']:>7} {r['total_ms']:>11.3f} "
              f"{r['max_ms']:>9.3f} {r['min_ms']:>9.3f} {r['avg_ms']:>9.3f}")
    print("-" * len(hdr))


def export_chrome_tracing(path: str, device_trace_dir: Optional[str] = None):
    """Write the window's host spans and the last device window's events
    (kernels, copies, sets) as ONE Chrome trace
    (catapult) JSON (≙ tools/timeline.py, which merges host + CUPTI
    device records). `device_trace_dir`: a directory holding a
    torch.profiler Chrome trace (`device_trace.json`, as a `trace_dir`
    window writes it) to merge instead."""
    trace = {"traceEvents": _tracing.chrome_trace_events(_window_spans(),
                                                         pid=0),
             "displayTimeUnit": "ms"}
    if device_trace_dir:
        with open(os.path.join(device_trace_dir, "device_trace.json")) as f:
            trace["traceEvents"].extend(_device_trace_events(json.load(f)))
    else:
        trace["traceEvents"].extend(_device_events)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def merge_process_traces(trace_paths, path: str, labels=None):
    """Merge per-process Chrome traces — each produced by
    `export_chrome_tracing` inside one trainer process — into ONE timeline
    with per-process lanes (≙ the reference's tools/timeline.py:24-33,
    whose --profile_path takes a list of per-trainer profile files and
    emits a single catapult view).

    Each input trace's pids are shifted into a disjoint range and labeled
    `rank{r}/host` / `rank{r}/device{k}`, so an N-process world reads as N
    stacked lanes in chrome://tracing / Perfetto."""
    traces = []
    for p in trace_paths:
        with open(p) as f:
            traces.append(json.load(f))
    # pid stride: one disjoint block per rank, wide enough for the
    # largest pid any input trace carries (device-trace planes can be
    # numerous)
    max_pid = 0
    for t in traces:
        for ev in t.get("traceEvents", []):
            if isinstance(ev, dict):
                max_pid = max(max_pid, int(ev.get("pid", 0)))
    stride = max(100, max_pid + 1)
    merged = {"traceEvents": [], "displayTimeUnit": "ms"}
    for r, t in enumerate(traces):
        label = (labels[r] if labels and r < len(labels) else f"rank{r}")
        base = r * stride
        seen = set()
        for ev in t.get("traceEvents", []):
            if not isinstance(ev, dict):
                continue
            ev = dict(ev)
            pid = int(ev.get("pid", 0))
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                # rewritten below with the rank prefix
                continue
            ev["pid"] = base + pid
            seen.add(pid)
            merged["traceEvents"].append(ev)
        for pid in sorted(seen):
            merged["traceEvents"].append({
                "ph": "M", "name": "process_name", "pid": base + pid,
                "args": {"name": label + ("/host" if pid == 0
                                          else f"/device{pid - 1}")}})
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(merged, f)
    return path


@contextmanager
def profiler(state: str = "All", sorted_key: str = "default",
             profile_path: Optional[str] = None,
             trace_dir: Optional[str] = None):
    """Context manager (≙ fluid.profiler.profiler, profiler.py:221):

        with profiler('All', sorted_key='total', profile_path='/tmp/t.json'):
            for batch in data:
                exe.run(...)
    """
    global _trace_dir
    _trace_dir = trace_dir
    reset_profiler()
    start_profiler(state)
    try:
        yield
    finally:
        stop_profiler(sorted_key=sorted_key, profile_path=profile_path)
        _trace_dir = None


@contextmanager
def device_tracer(log_dir: str):
    """Trace the device (torch.profiler with the CUDA activity) into
    `log_dir`/device_trace.json, spans annotated as ranges (≙ the CUPTI
    DeviceTracer, device_tracer.h:49). Needs a CUDA device."""
    global _trace_dir, _device_tracing
    import torch
    enforce(torch.cuda.is_available(),
            "device_tracer needs a CUDA device", exc=InvalidArgumentError)
    _trace_dir = log_dir
    _start_device_trace()
    try:
        yield
    finally:
        _device_tracing = False
        _tracing.annotation_factory = None
        _stop_device_trace()
        _trace_dir = None


def profiler_enabled() -> bool:
    return _enabled
