"""The profiler (`paddle_tpu_torch/profiler.py`) against the JAX package.

The same small program profiled in both packages on the CPU (no card, so
neither traces a device) gives the same span names and summary rows
(calls a name, not times); RecordEvent ranges nest; `export_chrome_tracing`
writes the window, `merge_process_traces` gives per-process lanes as the
JAX package's; `reset` leaves no state. The device half's event filter
reads a torch.profiler trace's kernels, copies and sets onto device lanes.
"""

import json

import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu import profiler as jprof

import paddle_tpu_torch as ptt
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.observability import tracing as ttracing

from test_torch_analysis import fresh_port_state  # noqa: F401


@pytest.fixture(autouse=True)
def jax_profiler_reset():
    jprof.reset()
    yield
    jprof.reset()


def _program(pkg):
    main, start = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, start), pkg.unique_name.guard():
        x = pkg.layers.data("x", [4])
        loss = pkg.layers.mean(pkg.layers.fc(x, 3))
        pkg.optimizer.SGD(0.1).minimize(loss)
    return main, start, loss


def _profile(pkg, prof, path):
    main, start, loss = _program(pkg)
    if pkg is pt:
        exe, scope = pt.Executor(), pt.Scope()
    else:
        exe, scope = ptt.Executor(place=ptt.CPUPlace()), ptt.Scope()
    exe.run(start, scope=scope)
    feed = {"x": np.ones((2, 4), "float32")}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)   # planned
    with prof.profiler("All", sorted_key="calls", profile_path=path):
        for _ in range(3):
            with prof.RecordEvent("user/step"):
                exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    with open(path) as f:
        return json.load(f)


def _rows(trace):
    """{name: calls} of the host spans (pid 0, complete events)."""
    out = {}
    for ev in trace["traceEvents"]:
        if ev.get("ph") == "X" and ev.get("pid") == 0:
            out[ev["name"]] = out.get(ev["name"], 0) + 1
    return out


def test_profiled_window_has_the_jax_names_and_calls(tmp_path, capsys):
    jt = _profile(pt, jprof, str(tmp_path / "j.json"))
    jout = capsys.readouterr().out
    tt = _profile(ptt, tprof, str(tmp_path / "t.json"))
    tout = capsys.readouterr().out
    assert _rows(tt) == _rows(jt)
    assert _rows(tt)["user/step"] == 3
    # the summary tables: the same event names with the same call counts,
    # ordered by calls
    def table(text):
        rows = [ln.split() for ln in text.splitlines()
                if ln and not ln.startswith(("-", "Event"))]
        return [(r[0], r[1]) for r in rows if len(r) >= 6]
    assert table(tout) == table(jout)
    assert not tprof.profiler_enabled()
    assert tprof._device_events == []        # no card: host spans only


def test_print_summary_sorts_and_rejects_unknown_keys(capsys):
    tprof.start_profiler("CPU")
    with tprof.record_event("a"):
        pass
    for _ in range(2):
        with tprof.RecordEvent("b"):
            pass
    tprof.print_profiler_summary("calls")
    lines = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()
             if ln[:1] in ("a", "b")]
    assert lines == ["b", "a"]
    with pytest.raises(Exception, match="sorted_key"):
        tprof.print_profiler_summary("nope")
    tprof.stop_profiler()


def test_merge_process_traces_equals_jax(tmp_path):
    paths = []
    for r in range(2):
        p = tmp_path / f"r{r}.json"
        p.write_text(json.dumps({"traceEvents": [
            {"ph": "X", "name": f"s{r}", "pid": 0, "tid": 1, "ts": 1,
             "dur": 2},
            {"ph": "X", "name": "k", "pid": 1, "tid": 7, "ts": 2,
             "dur": 1}]}))
        paths.append(str(p))
    jm = json.load(open(jprof.merge_process_traces(
        paths, str(tmp_path / "j.json"))))
    tm = json.load(open(tprof.merge_process_traces(
        paths, str(tmp_path / "t.json"))))
    assert tm == jm


def test_device_events_from_a_torch_profiler_trace():
    data = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_tc_kernel",
         "pid": 0, "tid": 7, "ts": 10, "dur": 5},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "pid": 0, "tid": 7, "ts": 20, "dur": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 123,
         "tid": 1, "ts": 9, "dur": 3},
        {"ph": "X", "cat": "user_annotation", "name": "executor/run",
         "pid": 123, "tid": 1, "ts": 8, "dur": 30}]}
    evs = tprof._device_trace_events(data)
    names = [e["name"] for e in evs if e.get("ph") == "X"]
    assert names == ["flash_fwd_tc_kernel", "Memcpy HtoD"]
    assert {e["pid"] for e in evs} == {1}
    assert any(e.get("ph") == "M" and e["args"]["name"] == "device0"
               for e in evs)


def test_reset_leaves_no_state():
    tprof.start_profiler("All")
    assert tprof.profiler_enabled()
    assert ttracing.enabled()
    tprof.reset()
    assert not tprof.profiler_enabled()
    assert ttracing.annotation_factory is None
    assert tprof._torch_prof is None and tprof._device_events == []
    assert ttracing._force_count == 0
    tprof.reset()        # idempotent
