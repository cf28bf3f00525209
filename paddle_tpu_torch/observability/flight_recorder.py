"""≙ paddle_tpu/observability/flight_recorder.py, line for line (host
only: beacons, dossiers, the state board, the post-mortem).

Distributed flight recorder: beacons, crash dossiers, post-mortems.

The r12 ring answers "what happened on THIS thread while the process was
alive". It cannot answer the questions a dying distributed run poses:
which rank died, in which barrier phase, who was still waiting on whom —
a SIGKILL leaves no chance to serialize anything at death. This module
closes that gap with three artifacts, all plain JSON under one
`dossier_dir` (configured explicitly or via `PTPU_DOSSIER_DIR`, so
supervised child processes inherit it through the environment):

- **beacons** (`flight-<pid>-rank<r>.jsonl`): an append-only
  write-ahead log of protocol phase transitions. `note_phase` is called
  at every barrier phase boundary (process_world.fault /
  parallel/elastic.py) BEFORE the phase's work — and, when a fault
  directive is about to fire, with `crashing`/`dropped` markers before
  the SIGKILL/RankDead. The OS page cache survives process death, so
  after a kill -9 the beacon's last line names the dead rank and the
  exact phase it reached. Timestamps per line give the straggler
  timeline.
- **dossiers** (`dossier-<ts>-pid<pid>[-rank<r>].json`): a full dump —
  last-N spans from the trace ring, a metrics snapshot, the live state
  board, the environment's world identity — written on the deaths the
  process CAN see coming: an enforce error escaping to the top
  (`install()` wires sys.excepthook), SIGTERM (preemption notice), and
  simulated rank death (RankDead in process_world.run).
- **post-mortems** (`post_mortem-<k>.json`): the Supervisor's synthesis
  after a gang incarnation dies — beacons + dossiers folded into
  {dead_rank, phase, serial, per-rank timeline} so the operator reads
  one file, not N logs. tests/test_process_world.py asserts the
  crash-anywhere SIGKILL sweep produces a correct one for every fault
  in the matrix.

Everything here is OFF until configured: `note_phase` with no dossier
dir updates the in-memory state board only (a dict merge — nanoseconds),
so the tracing overhead budget is unaffected.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ..core import flags
from ..core.enforce import InvalidArgumentError, enforce

#: spans included in a dossier (newest last)
DOSSIER_SPANS = 256
BEACON_PREFIX = "flight-"
DOSSIER_PREFIX = "dossier-"
POST_MORTEM_PREFIX = "post_mortem-"

_lock = threading.Lock()
_dossier_dir: Optional[str] = None
#: True once configure() ran — even with None. Distinguishes
#: "explicitly disabled" (no PTPU_DOSSIER_DIR fallback) from
#: "never configured" (a fresh process inherits the env var).
_configured = False
_world_id: Optional[str] = None
#: component -> {field: value} — the live "what is in flight" board a
#: dossier snapshots (barrier serial/phase, engine tick state, ...)
_state_board: Dict[str, Dict[str, Any]] = {}
_beacon_files: Dict[int, Any] = {}          # rank -> open file handle
_extra_registries: List[Any] = []
_prev_excepthook = None
_prev_sigterm = None
_sigterm_installed = False
_dossier_seq = 0


def configure(dossier_dir: Optional[str], world_id: Optional[str] = None):
    """Point the recorder at a dossier directory. None DISABLES it —
    explicitly, i.e. a later call will NOT fall back to
    PTPU_DOSSIER_DIR; only a process that never configured inherits the
    env var (how supervised children pick up the Supervisor's dir)."""
    global _dossier_dir, _world_id, _configured
    with _lock:
        for f in _beacon_files.values():
            try:
                f.close()
            except OSError:
                pass
        _beacon_files.clear()
        _dossier_dir = dossier_dir
        _world_id = world_id
        _configured = True
        if dossier_dir:
            os.makedirs(dossier_dir, exist_ok=True)


def dossier_dir() -> Optional[str]:
    if _configured or _dossier_dir is not None:
        return _dossier_dir
    env = os.environ.get("PTPU_DOSSIER_DIR")
    if env:
        configure(env)
        return _dossier_dir
    return None


def enabled() -> bool:
    return dossier_dir() is not None


def set_state(component: str, **fields):
    """Merge fields into the component's state-board entry (the live
    snapshot a dossier captures: active barrier serial, engine draining
    flag, supervisor restart count...). None values delete keys."""
    with _lock:
        entry = _state_board.setdefault(component, {})
        for k, v in fields.items():
            if v is None:
                entry.pop(k, None)
            else:
                entry[k] = v


def clear_state(component: str):
    with _lock:
        _state_board.pop(component, None)


def state_board() -> Dict[str, Dict[str, Any]]:
    with _lock:
        return {k: dict(v) for k, v in _state_board.items()}


def register_metrics(registry):
    """Add a registry whose snapshot rides every dossier (the engine's
    per-instance registry; the default registry is always included)."""
    with _lock:
        if registry not in _extra_registries:
            _extra_registries.append(registry)


def _beacon_file(rank: int):
    d = dossier_dir()
    if d is None:
        return None
    with _lock:
        f = _beacon_files.get(rank)
        if f is None:
            path = os.path.join(
                d, f"{BEACON_PREFIX}{os.getpid()}-rank{rank}.jsonl")
            f = open(path, "a", buffering=1)   # line-buffered: each note
            _beacon_files[rank] = f            # hits the page cache whole
        return f


def note_phase(component: str, phase: str, rank: int = 0,
               serial: Optional[int] = None, **extra):
    """One phase-transition note: updates the state board always, and —
    when a dossier dir is configured — appends a beacon line that
    survives a SIGKILL landing ANY time after this call. `extra` carries
    the fault markers (`crashing=True` just before a SIGKILL directive
    fires, `dropped=True` before a RankDead) the post-mortem keys on."""
    set_state(component, phase=phase, rank=rank, serial=serial,
              ts=time.time(), **extra)
    f = _beacon_file(rank)
    if f is None:
        return
    row = {"component": component, "phase": phase, "rank": rank,
           "ts": time.time(), "pid": os.getpid()}
    if serial is not None:
        row["serial"] = serial
    if _world_id is not None:
        row["world"] = _world_id
    row.update(extra)
    try:
        f.write(json.dumps(row) + "\n")
    except (OSError, ValueError):
        pass   # a full disk must not take the protocol down with it


def _metrics_snapshot() -> Dict[str, str]:
    from . import metrics as _metrics
    out = {}
    regs = [("default", _metrics.default_registry())]
    with _lock:
        regs += [(f"extra{i}", r)
                 for i, r in enumerate(_extra_registries)]
    for name, r in regs:
        try:
            out[name] = r.expose()
        except Exception as e:   # a broken scrape callback must not
            out[name] = f"<scrape failed: {e}>"   # block the dossier
    return out


def dump_dossier(reason: str, rank: int = 0, exc: Optional[BaseException]
                 = None, extra: Optional[dict] = None) -> Optional[str]:
    """Write one dossier (returns its path; None when disabled): the
    last-N trace spans, a metrics snapshot, the state board, and the
    world identity — everything a post-mortem needs from a death the
    process could still serialize (enforce error / SIGTERM / RankDead).
    Never raises: a failing dossier must not mask the original error."""
    global _dossier_seq
    d = dossier_dir()
    if d is None:
        return None
    try:
        from . import tracing as _tracing
        spans = [s.to_dict() for s in _tracing.spans()[-DOSSIER_SPANS:]]
    except Exception:
        spans = []
    try:
        # the memory board: current + high-water bytes per channel and
        # the last MFU reading — an OOM-shaped death is attributable
        # from the dossier alone (was the KV cache or the checkpoint
        # staging holding the bytes?). SAME shape as /healthz's
        # "memory" field, so one post-mortem tool reads both.
        from . import memory as _memory
        mem_board = _memory.watermark_board()
    except Exception:
        mem_board = {}
    with _lock:
        _dossier_seq += 1
        seq = _dossier_seq
    doc = {
        "reason": reason,
        "ts": time.time(),
        "pid": os.getpid(),
        "rank": rank,
        "world": _world_id or os.environ.get("PTPU_WORLD_RANK", ""),
        "world_size": os.environ.get("PTPU_WORLD_SIZE", ""),
        "exception": (f"{type(exc).__name__}: {exc}"
                      if exc is not None else None),
        "state": state_board(),
        "memory": mem_board,
        "spans": spans,
        "metrics": _metrics_snapshot(),
        "extra": dict(extra or {}),
    }
    path = os.path.join(
        d, f"{DOSSIER_PREFIX}{int(time.time() * 1e3)}-"
           f"pid{os.getpid()}-rank{rank}-{seq}.json")
    try:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=str)
    except (OSError, TypeError, ValueError):
        return None
    flags.vlog(1, "flight recorder: dossier %s (%s)", path, reason)
    return path


def install(dir: Optional[str] = None, excepthook: bool = True,
            sigterm: bool = True):
    """Arm the recorder for a process: configure the dossier dir (or
    inherit PTPU_DOSSIER_DIR) and wire the two deaths a process can
    observe — an uncaught exception (sys.excepthook chain) and SIGTERM
    (main thread only; the prior handler is chained, so the
    EngineServer drain installed first still runs)."""
    global _prev_excepthook, _prev_sigterm, _sigterm_installed
    if dir is not None:
        configure(dir)
    if not enabled():
        return
    if excepthook and _prev_excepthook is None:
        _prev_excepthook = sys.excepthook

        def _hook(etype, evalue, etb):
            dump_dossier("uncaught exception", exc=evalue)
            (_prev_excepthook or sys.__excepthook__)(etype, evalue, etb)

        sys.excepthook = _hook
    # install the SIGTERM wrapper at most ONCE: a second install() must
    # not stack wrappers (one SIGTERM would then dump N dossiers), and
    # reset() restores the captured original
    if sigterm and not _sigterm_installed \
            and threading.current_thread() is threading.main_thread():
        import signal as _signal
        prev = _prev_sigterm = _signal.getsignal(_signal.SIGTERM)

        def _on_term(signum, frame):
            dump_dossier("SIGTERM")
            if callable(prev):
                prev(signum, frame)
            elif prev == _signal.SIG_DFL:   # pragma: no cover
                _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
                os.kill(os.getpid(), _signal.SIGTERM)

        _signal.signal(_signal.SIGTERM, _on_term)
        _sigterm_installed = True


# ---------------------------------------------------------------------------
# post-mortem synthesis (the Supervisor's side)
# ---------------------------------------------------------------------------

def read_beacons(dir_path: str) -> Dict[int, List[dict]]:
    """{rank: [beacon rows, oldest first]} across every pid that wrote
    into `dir_path`. Torn last lines (the writer died mid-write) are
    dropped silently — that is exactly the crash the log exists for."""
    out: Dict[int, List[dict]] = {}
    if not os.path.isdir(dir_path):
        return out
    for name in sorted(os.listdir(dir_path)):
        if not (name.startswith(BEACON_PREFIX)
                and name.endswith(".jsonl")):
            continue
        with open(os.path.join(dir_path, name)) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                out.setdefault(int(row.get("rank", 0)), []).append(row)
    for rows in out.values():
        rows.sort(key=lambda r: r.get("ts", 0.0))
    return out


def collect_dossiers(dir_path: str) -> List[dict]:
    out = []
    if not os.path.isdir(dir_path):
        return out
    for name in sorted(os.listdir(dir_path)):
        if not (name.startswith(DOSSIER_PREFIX)
                and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(dir_path, name)) as f:
                doc = json.load(f)
            doc["_path"] = os.path.join(dir_path, name)
            out.append(doc)
        except (OSError, json.JSONDecodeError):
            continue
    return out


def analyze(dir_path: str) -> Dict[str, Any]:
    """Fold beacons + dossiers into the post-mortem verdict:

    - `dead_rank`/`dead_phase`/`serial`: the rank whose beacon carries a
      `crashing`/`dropped` marker (a fault directive announced itself),
      else the LEAST-ADVANCED rank by last-note timestamp — in an
      unplanned whole-world death, the rank that stopped logging first
      is the best available culprit;
    - `timeline`: per-rank [(phase, ts)] — who waited on whom;
    - `straggler_order`: ranks by last-note time, laggard first."""
    beacons = read_beacons(dir_path)
    dossiers = collect_dossiers(dir_path)
    verdict: Dict[str, Any] = {
        "dead_rank": None, "dead_phase": None, "serial": None,
        "cause": None,
        "timeline": {str(r): [
            {"phase": row.get("phase"), "ts": row.get("ts"),
             "serial": row.get("serial"),
             "component": row.get("component")}
            for row in rows] for r, rows in beacons.items()},
        "n_dossiers": len(dossiers),
        "dossier_reasons": [d.get("reason") for d in dossiers],
    }
    marked = []
    for r, rows in beacons.items():
        for row in rows:
            if row.get("crashing") or row.get("dropped"):
                marked.append((row.get("ts", 0.0), r, row))
    if marked:
        # beacons ACCUMULATE across gang restarts into one dossier dir —
        # the verdict must describe the incarnation that just died, i.e.
        # the MOST RECENT marker, not the first crash ever recorded
        marked.sort(key=lambda x: x[0])
        _, r, row = marked[-1]
        verdict.update(dead_rank=r, dead_phase=row.get("phase"),
                       serial=row.get("serial"),
                       cause=("crash_rank SIGKILL" if row.get("crashing")
                              else "drop_rank simulated death"))
    elif beacons:
        last = {r: rows[-1].get("ts", 0.0)
                for r, rows in beacons.items()}
        r = min(last, key=last.get)
        verdict.update(dead_rank=r,
                       dead_phase=beacons[r][-1].get("phase"),
                       serial=beacons[r][-1].get("serial"),
                       cause="least-advanced rank (heuristic)")
    verdict["straggler_order"] = [
        r for r, _ in sorted(((r, rows[-1].get("ts", 0.0))
                              for r, rows in beacons.items()),
                             key=lambda x: x[1])]
    return verdict


def write_post_mortem(dir_path: str, incarnation: int = 0,
                      extra: Optional[dict] = None) -> str:
    """Analyze `dir_path` and commit the verdict as
    post_mortem-<incarnation>.json (what Supervisor writes after each
    gang death). Returns the path."""
    enforce(os.path.isdir(dir_path),
            f"post-mortem: dossier dir {dir_path!r} does not exist",
            exc=InvalidArgumentError)
    doc = analyze(dir_path)
    doc["incarnation"] = int(incarnation)
    doc["written_ts"] = time.time()
    doc.update(extra or {})
    path = os.path.join(dir_path,
                        f"{POST_MORTEM_PREFIX}{int(incarnation)}.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=str)
    return path


def reset():
    """Test isolation: drop configuration, state board, beacon handles,
    and the installed excepthook/SIGTERM chains."""
    global _prev_excepthook, _prev_sigterm, _sigterm_installed, \
        _dossier_seq
    configure(None)
    with _lock:
        _state_board.clear()
        _extra_registries.clear()
        _dossier_seq = 0
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    if _sigterm_installed:
        import signal as _signal
        try:
            _signal.signal(_signal.SIGTERM,
                           _prev_sigterm
                           if _prev_sigterm is not None
                           else _signal.SIG_DFL)
        except ValueError:   # not the main thread: leave it installed
            pass
        else:
            _sigterm_installed = False
            _prev_sigterm = None
