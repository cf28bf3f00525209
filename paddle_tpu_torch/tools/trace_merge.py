"""Merge per-rank Chrome traces into ONE cross-rank timeline.

≙ tools/trace_merge.py, the port's own copy (it needs only the standard
library): for the same input JSON, `merge` returns the same document.
Every span a rank of a world records carries {world, rank, world_size}
(the port's `tracing.rank_scope`; a StoreWorld's and a ProcessWorld's
protocol rounds stamp it), and each rank process exports its own Chrome
trace. This tool folds them into one timeline the way chrome://tracing /
Perfetto expects a distributed trace to be laid out:

- **rank → pid**: every rank becomes its own process lane, named
  "rank <r> (<world>)" via process_name metadata events;
- **phase → tid**: spans whose name matches a known protocol-phase
  family (barrier/<phase>, request/<phase>, pp_send//pp_recv) are
  grouped onto a stable per-phase thread lane with a thread_name
  metadata event, so the same phase lines up vertically across ranks
  and "who waited on whom" reads off the gaps; everything else keeps
  its recording thread's lane;
- **per-rank clock alignment**: perf_counter origins differ across
  processes. With `--align-span NAME` every input's timeline is shifted
  so its FIRST event of that name lands at the same merged timestamp
  (default `barrier/stage`: every rank records it for every snapshot
  serial; pass an empty string to disable). Within one process the
  shift is 0 by construction.

Usage:
    python -m paddle_tpu_torch.tools.trace_merge rankA.json rankB.json \
        -o merged.json
    python -m paddle_tpu_torch.tools.trace_merge one_ring_export.json \
        -o merged.json
        # spans carry args.rank: the single file splits into rank lanes

Events without a rank tag land on pid --untagged-pid (default 999,
lane "untagged (host)").
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple

#: name prefixes whose spans collapse onto one named thread lane per
#: (rank, phase family) — the "phase → tid" naming of the merged view.
#: "memory/" carries the memory watermark COUNTER events (ph "C"):
#: each rank's memory levels plot on one lane under its span lanes.
PHASE_FAMILIES = ("barrier/", "request/", "pp_send/", "pp_recv/",
                  "elastic/", "engine/", "memory/")


def _load_events(path: str) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    evs = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    return [e for e in evs if e.get("ph") != "M"]   # re-derive metadata


def _rank_of(ev: dict) -> Optional[int]:
    args = ev.get("args") or {}
    r = args.get("rank")
    try:
        return int(r)
    except (TypeError, ValueError):
        return None


def _world_of(ev: dict) -> str:
    return str((ev.get("args") or {}).get("world", ""))


def _phase_tid(name: str) -> Optional[str]:
    for fam in PHASE_FAMILIES:
        if name.startswith(fam):
            return name if name.startswith(("barrier/", "request/")) \
                else fam.rstrip("/")
    return None


def _align_shift(events: List[dict], align_span: str) -> float:
    """Shift (us) that moves this input's first `align_span` event to
    t=0; 0.0 when the span is absent (nothing to align on)."""
    ts = [e["ts"] for e in events
          if e.get("name") == align_span and "ts" in e]
    return -min(ts) if ts else 0.0


def merge(inputs: List[str], align_span: str = "barrier/stage",
          untagged_pid: int = 999) -> dict:
    """The merged Chrome trace document (see module docstring)."""
    out_events: List[dict] = []
    pid_names: Dict[int, str] = {}
    tid_names: Dict[Tuple[int, int], str] = {}
    tid_alloc: Dict[Tuple[int, str], int] = {}

    def _tid_for(pid: int, key: str, pretty: str) -> int:
        k = (pid, key)
        if k not in tid_alloc:
            tid_alloc[k] = len([1 for (p, _) in tid_alloc if p == pid]) + 1
            tid_names[(pid, tid_alloc[k])] = pretty
        return tid_alloc[k]

    for path in inputs:
        events = _load_events(path)
        shift = _align_shift(events, align_span) if align_span else 0.0
        for ev in events:
            ev = dict(ev)
            rank = _rank_of(ev)
            if rank is None:
                pid = untagged_pid
                pid_names.setdefault(pid, "untagged (host)")
            else:
                pid = rank
                world = _world_of(ev)
                pid_names.setdefault(
                    pid, f"rank {rank}" + (f" ({world})" if world else ""))
            ev["pid"] = pid
            if "ts" in ev:
                ev["ts"] = ev["ts"] + shift
            fam = _phase_tid(str(ev.get("name", "")))
            if fam is not None:
                ev["tid"] = _tid_for(pid, f"phase:{fam}", fam)
            else:
                ev["tid"] = _tid_for(pid, f"thread:{ev.get('tid', 0)}",
                                     f"thread {ev.get('tid', 0)}")
            out_events.append(ev)

    meta = []
    for pid, name in sorted(pid_names.items()):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "args": {"name": name}})
    for (pid, tid), name in sorted(tid_names.items()):
        meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                     "tid": tid, "args": {"name": name}})
    out_events.sort(key=lambda e: e.get("ts", 0.0))
    return {"traceEvents": meta + out_events, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("inputs", nargs="+",
                    help="per-rank Chrome trace JSON files (or one "
                         "ring export with rank-tagged spans)")
    ap.add_argument("-o", "--out", required=True,
                    help="merged Chrome trace output path")
    ap.add_argument("--align-span", default="barrier/stage",
                    help="span name to align per-input clocks on "
                         "('' disables; default barrier/stage)")
    ap.add_argument("--untagged-pid", type=int, default=999)
    args = ap.parse_args(argv)
    for p in args.inputs:
        if not os.path.exists(p):
            print(f"trace_merge: no such input {p!r}", file=sys.stderr)
            return 2
    doc = merge(args.inputs, align_span=args.align_span,
                untagged_pid=args.untagged_pid)
    d = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f)
    n_ranks = len({e['pid'] for e in doc['traceEvents']
                   if e.get('ph') != 'M'})
    print(f"trace_merge: {len(doc['traceEvents'])} events, "
          f"{n_ranks} process lane(s) -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
