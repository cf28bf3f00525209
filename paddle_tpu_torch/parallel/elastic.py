"""Elastic fault-tolerant training: atomic snapshots and preemption
recovery.

≙ paddle_tpu/parallel/elastic.py (reference listen_and_serv_op.cc
checkpoint handler + trainer.py:641), on the port's executors:

- `save_train_state` snapshots the COMPLETE training state: parameters,
  ZeRO-1 accumulators (each rank's dp block), per-rank error-feedback
  residuals (`dp_comm_err_*`), the executor's run counter (the dropout
  seed stream's position), `random_seed`, and the BuildStrategy / mesh —
  with the ATOMIC TWO-PHASE COMMIT: every file lands in a hidden staging
  directory, every byte is fsync'd, the directory is renamed into place,
  and only then a `COMMIT` marker (every file's size and crc32) is
  renamed in. A kill at any byte offset leaves either a committed
  snapshot (which restores exactly) or an uncommitted one (which restore
  skips) — never a restorable half-write.
- the ASYNC path (`block=False`): on a card the chunks are copied on a
  CUDA side stream (framework/offload.py `TransferStream`) into one
  page-locked host slab (`HostSlab`), after an event of the compute
  stream; the compute stream then waits on the copy's event, so the next
  step's in-place optimizer writes are ordered after the copy on the
  device. The step path pays the enqueue and that wait; a writer thread
  waits on the copy's event, then writes and commits. On the CPU the
  chunks are cloned at once.
- MULTI-WRITER saves run the CHIEF-COMMITS BARRIER: every rank stages and
  fsyncs its own `shard-<rank>.pts` + manifest in a rank-private staging
  directory and acks a per-file digest manifest to the chief; the chief
  waits with a deadline, binds every rank's manifest into ONE COMMIT
  record, and one rename commits the snapshot. `world=ProcessWorld(N)`
  simulates the ranks inside one process (the JAX package's meaning); an
  executor whose mesh spans several processes of a joined
  torch.distributed world runs the same protocol over its real ranks,
  the ack / commit / abort messages riding the world's c10d store
  (`process_world.StoreWorld`). A missing ack at the deadline aborts the
  snapshot (`ptpu_ckpt_barrier_aborts_total`); training continues.
- `restore_train_state` is ELASTIC across mesh changes (dp2×tp2 → dp4,
  dp2×pp2 → dp2×tp2, a mesh over fewer ranks): each rank reads only the
  chunks its new block intersects, straight onto the executor's device;
  error-feedback residuals re-map across dp and tp changes
  (`_resize_replica_rows` / `_remap_error_feedback`). The re-layout is
  planned first (parallel/reshard.py) and checked exactly against
  `framework.costs.reshard_wire_bytes`; the restored program and every
  restored block's placement are verified before the first step.
- `PTPU_FAULT_INJECT` makes recovery testable: crash_at_step,
  crash_mid_save (SIGKILL at a byte offset of the staged payload),
  slow_writer, and process_world's per-rank directives.

Directory layout:

    <root>/
      snapshot-00000003/          committed snapshot, serial 3
        shard-<r>.pts             rank r's chunks (data/tensor_store.py)
        manifest-<r>.json         rank r's chunk -> global-offset map
        train_meta.json           counters, strategy, EF layout,
                                  per-var placements
        COMMIT                    commit marker + integrity record
      .tmp-00000004-1234/         staging of an interrupted single-writer
                                  save
      .tmp-00000004-rank2/        rank 2's private staging (barrier)
      .tmp-00000004-world1234/    the chief's assembly dir (barrier)
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import flags
from ..core.enforce import InvalidArgumentError, NotFoundError, enforce

class SnapshotDigestError(InvalidArgumentError):
    """A committed snapshot file's content digest disagrees with the
    COMMIT integrity record (silent corruption after commit) — its own
    type so tooling classifies it structurally, not by error text."""


SNAPSHOT_PREFIX = "snapshot-"
STAGING_PREFIX = ".tmp-"
COMMIT_MARKER = "COMMIT"
META_FILE = "train_meta.json"
META_FORMAT = 2
#: version of the COMMIT integrity record THIS reader understands; a
#: snapshot committed by a newer protocol is skipped (warn-once), never
#: half-understood
COMMIT_FORMAT = 2


# ---------------------------------------------------------------------------
# fault injection (PTPU_FAULT_INJECT)
# ---------------------------------------------------------------------------

def fault_injection_config() -> Dict[str, float]:
    """Parse PTPU_FAULT_INJECT: comma-separated `directive:value` pairs.

      crash_at_step:<k>     SIGKILL self when maybe_crash_at_step(k) fires
      crash_mid_save:<b>    SIGKILL during the snapshot protocol at byte
                            offset b of the staged payload (b < payload:
                            truncated staging files; b == payload: after
                            the directory rename, BEFORE the COMMIT
                            marker; b > payload: just after commit)
      slow_writer:<s>       sleep s seconds in the background writer
                            before touching disk (widens the async
                            window; exercises drain paths)

    World-aware directives (crash_rank/drop_rank/straggle_rank) are
    parsed by process_world.world_fault_plan — they pass through here
    unchecked so one env var carries both families.

    Parsed per call — tests flip the env var between runs."""
    from .process_world import WORLD_DIRECTIVES
    raw = os.environ.get("PTPU_FAULT_INJECT", "")
    out: Dict[str, float] = {}
    if not raw:
        return out
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        enforce(":" in part,
                f"PTPU_FAULT_INJECT directive {part!r} must be "
                f"`name:value`", exc=InvalidArgumentError)
        name, val = part.split(":", 1)
        if name in WORLD_DIRECTIVES:
            continue  # structured values, owned by process_world
        enforce(name in ("crash_at_step", "crash_mid_save", "slow_writer"),
                f"unknown PTPU_FAULT_INJECT directive {name!r}",
                exc=InvalidArgumentError)
        out[name] = float(val)
    return out


def _sigkill_self():  # pragma: no cover - the process dies here
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_crash_at_step(step: int):
    """Training loops call this once per step: under
    `PTPU_FAULT_INJECT=crash_at_step:<k>` the process SIGKILLs itself
    when step == k — the supervisor/recovery tests' preemption."""
    cfg = fault_injection_config()
    k = cfg.get("crash_at_step")
    if k is not None and int(step) == int(k):
        flags.vlog(0, "fault injection: SIGKILL at step %d", step)
        _sigkill_self()  # pragma: no cover


def _payload_files(staging: str) -> List[str]:
    """Deterministic order of the staged payload files the
    crash_mid_save byte offset indexes into."""
    names = sorted(n for n in os.listdir(staging)
                   if n != COMMIT_MARKER and not n.endswith(".tmp"))
    return names


def _crash_mid_staging(staging: str, offset: int) -> bool:
    """crash_mid_save with offset inside the payload: make the staging
    dir look exactly as if the writer died `offset` bytes into its
    sequential write (sharded_checkpoint.truncate_payload_at — shared
    with the world-aware crash_rank stage faults), then SIGKILL.
    Returns False when the offset lies beyond the payload (the caller
    crashes later in the protocol)."""
    from ..sharded_checkpoint import truncate_payload_at
    if not truncate_payload_at(staging, offset,
                               exclude=(COMMIT_MARKER,)):
        return False
    _sigkill_self()  # pragma: no cover
    return True


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

_registry = None
_reg_lock = threading.Lock()


def metrics_registry():
    """The checkpoint telemetry series (save / restore durations, bytes
    written, snapshots committed, barrier aborts, pending async writes),
    registered once, idempotently, into `observability.metrics
    .default_registry()`: one /metrics scrape sees checkpoint, training
    and serving series together. Returns the default registry."""
    global _registry
    with _reg_lock:
        if _registry is None:
            from ..observability import metrics as m
            r = m.default_registry()
            c = m.get_or_create
            c(r, "counter", "ptpu_ckpt_saves_total",
              "Snapshots committed by this process.")
            c(r, "counter", "ptpu_ckpt_save_bytes_total",
              "Payload bytes written across committed snapshots.")
            c(r, "counter", "ptpu_ckpt_restores_total",
              "Snapshots restored.")
            c(r, "counter", "ptpu_ckpt_barrier_aborts_total",
              "Multi-rank snapshot attempts aborted at the "
              "chief's barrier (straggler past the deadline or a "
              "dead rank); training continues, the snapshot is "
              "discarded.")
            c(r, "counter", "ptpu_ckpt_skipped_foreign_total",
              "Snapshot dirs skipped during latest-snapshot "
              "selection because their COMMIT record was written "
              "by a newer protocol/world config than this "
              "process understands.")
            c(r, "counter", "ptpu_ckpt_digest_failures_total",
              "Snapshot files whose content digest disagreed "
              "with the COMMIT integrity record (silent "
              "bit-flips caught at validate/restore).")
            c(r, "histogram", "ptpu_ckpt_save_seconds",
              "Wall time of the write+commit phase.",
              buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                       5.0, 10.0, 30.0))
            c(r, "histogram", "ptpu_ckpt_restore_seconds",
              "Wall time of restore_train_state.",
              buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                       5.0, 10.0, 30.0))
            c(r, "gauge", "ptpu_ckpt_pending_async",
              "Async snapshot writes not yet committed.",
              fn=lambda: float(len(_PENDING)))
            _registry = r
    return _registry


def pending_async_count() -> int:
    """In-flight async snapshot writes not yet committed — the number
    the serving /healthz endpoint reports as pending_checkpoints."""
    with _pending_lock:
        return len(_PENDING)


def _metric(name):
    return metrics_registry().get(name)


# ---------------------------------------------------------------------------
# snapshot directory bookkeeping
# ---------------------------------------------------------------------------

_SNAP_RE = re.compile(re.escape(SNAPSHOT_PREFIX) + r"(\d+)$")


def is_committed(dirname: str) -> bool:
    return os.path.exists(os.path.join(dirname, COMMIT_MARKER))


def file_digest(path: str) -> str:
    """Content digest recorded per file in the COMMIT integrity record:
    crc32 over the full file, rendered as 8 hex chars. Catches the
    silent bit-flips a size check cannot (cheap enough to verify on
    every restore)."""
    crc = 0
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(block, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def list_snapshots(root: str, committed_only: bool = True):
    """[(serial, path)] ascending by serial. committed_only=True (the
    default — restore's view) skips snapshot dirs without a COMMIT
    marker: an interrupted save must never be picked as "latest"."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _SNAP_RE.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        if committed_only and not is_committed(path):
            continue
        out.append((int(m.group(1)), path))
    return sorted(out)


def _read_commit_record(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(path, COMMIT_MARKER)) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None


_warned_foreign: set = set()


def _ranked_snapshots(root: str) -> List[str]:
    """Committed snapshot paths ascending by (step, commit_ts, serial) —
    the ONE ranking shared by latest-snapshot selection AND retention,
    so retention can never delete the snapshot selection would pick.
    Directories whose COMMIT record declares a NEWER protocol format
    than this reader understands (a newer world config writing into the
    same root) are excluded — never selected, never pruned — with a
    warn-once vlog + the ptpu_ckpt_skipped_foreign_total counter:
    adopting (or deleting) a half-understood snapshot would turn the
    integrity story into noise."""
    ranked = []
    for serial, path in list_snapshots(root, committed_only=True):
        record = _read_commit_record(path) or {}
        fmt = int(record.get("format", 1))
        if fmt > COMMIT_FORMAT:
            if path not in _warned_foreign:
                _warned_foreign.add(path)
                flags.vlog(0, "skipping snapshot %s: COMMIT format %d is "
                           "newer than this process understands (%d) — "
                           "written by a newer world config?", path, fmt,
                           COMMIT_FORMAT)
                _metric("ptpu_ckpt_skipped_foreign_total").inc()
            continue
        key = (int(record.get("step", -1)),
               float(record.get("commit_ts", 0.0)), serial)
        ranked.append((key, path))
    return [p for _, p in sorted(ranked)]


def latest_snapshot(root: str) -> Optional[str]:
    """Path of the newest COMMITTED snapshot under root, or None.

    Deterministic under concurrent/stale writers: candidates order by
    (step, commit_ts, serial) from the COMMIT record — two snapshots at
    the SAME step (a stale supervisor racing a live one on one root)
    tie-break by commit timestamp, then serial, instead of whichever
    serial a racing _alloc_serial happened to mint last (see
    `_ranked_snapshots` for the foreign-format skip)."""
    ranked = _ranked_snapshots(root)
    return ranked[-1] if ranked else None


def _record_size_digest(entry) -> (int, Optional[str]):
    """A COMMIT `files` entry: format 1 recorded a bare byte size;
    format 2 records {"size": s, "crc32": "xxxxxxxx"}."""
    if isinstance(entry, dict):
        return int(entry["size"]), entry.get("crc32")
    return int(entry), None


def validate_snapshot(dirname: str, digests: bool = True):
    """Raise a clear enforce error unless `dirname` is a complete,
    committed snapshot: COMMIT marker present and parseable, every file
    it records present at exactly the recorded size AND (digests=True,
    the default) matching its recorded content digest — a silent
    bit-flip inside a shard container is rejected with an error naming
    the file, not surfaced as garbage weights — manifest count matching.
    The property the crash-anywhere tests pin: a directory that passes
    here restores exactly; one that fails is rejected with the directory
    and the missing/damaged piece named."""
    enforce(os.path.isdir(dirname),
            f"snapshot dir {dirname!r} does not exist",
            exc=NotFoundError)
    marker = os.path.join(dirname, COMMIT_MARKER)
    enforce(os.path.exists(marker),
            f"snapshot dir {dirname!r} has no {COMMIT_MARKER} marker — an "
            f"interrupted (uncommitted) save; it is not restorable. "
            f"restore_train_state(root) picks the latest COMMITTED "
            f"snapshot automatically", exc=InvalidArgumentError)
    try:
        with open(marker) as f:
            record = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise InvalidArgumentError(
            f"snapshot dir {dirname!r}: {COMMIT_MARKER} marker is corrupt "
            f"({e})") from e
    fmt = int(record.get("format", 1))
    enforce(fmt <= COMMIT_FORMAT,
            f"snapshot dir {dirname!r}: {COMMIT_MARKER} format {fmt} is "
            f"newer than this process understands ({COMMIT_FORMAT}) — "
            f"restore with the world config that wrote it",
            exc=InvalidArgumentError)
    files = record.get("files", {})
    for name, entry in files.items():
        path = os.path.join(dirname, name)
        enforce(os.path.exists(path),
                f"snapshot dir {dirname!r} is missing {name!r} recorded "
                f"in its {COMMIT_MARKER} marker",
                exc=InvalidArgumentError)
        size, digest = _record_size_digest(entry)
        got = os.path.getsize(path)
        enforce(got == size,
                f"snapshot dir {dirname!r}: {name!r} is {got} bytes but "
                f"the {COMMIT_MARKER} marker recorded {size} — truncated "
                f"or overwritten after commit",
                exc=InvalidArgumentError)
        if digests and digest is not None:
            got_digest = file_digest(path)
            if got_digest != digest:
                _metric("ptpu_ckpt_digest_failures_total").inc()
            enforce(got_digest == digest,
                    f"snapshot dir {dirname!r}: {name!r} content digest "
                    f"crc32:{got_digest} does not match the "
                    f"{COMMIT_MARKER} marker's crc32:{digest} — the file "
                    f"was corrupted (bit-flip/partial overwrite) after "
                    f"commit; restore from another committed snapshot",
                    exc=SnapshotDigestError)
    n_manifests = len([n for n in os.listdir(dirname)
                       if n.startswith("manifest-")
                       and n.endswith(".json")])
    want = int(record.get("manifests", n_manifests))
    enforce(n_manifests == want,
            f"snapshot dir {dirname!r} holds {n_manifests} manifest(s) "
            f"but the {COMMIT_MARKER} marker recorded {want} — shard "
            f"files from another world mixed in?",
            exc=InvalidArgumentError)


def _resolve_snapshot_dir(path: str) -> str:
    """Accept either a snapshot dir or a root of snapshot-* dirs."""
    if os.path.basename(os.path.normpath(path)).startswith(SNAPSHOT_PREFIX):
        return path
    if os.path.isdir(path) and any(
            _SNAP_RE.match(n) for n in os.listdir(path)):
        latest = latest_snapshot(path)
        enforce(latest is not None,
                f"checkpoint root {path!r} holds snapshot dirs but none "
                f"is committed (no {COMMIT_MARKER} markers) — every save "
                f"was interrupted before its commit point",
                exc=NotFoundError)
        return latest
    return path


# ---------------------------------------------------------------------------
# train-state metadata
# ---------------------------------------------------------------------------


def _strategy_dict(strategy) -> Dict[str, Any]:
    if strategy is None:
        return {}
    from .strategy import ReduceStrategy
    return {
        "reduce_strategy": ReduceStrategy(strategy.reduce_strategy).name,
        "quant_comm": strategy.quant_comm,
        "quant_comm_block": strategy.quant_comm_block,
        "comm_error_feedback": strategy.comm_error_feedback,
        "comm_bucket_bytes": strategy.comm_bucket_bytes,
        "pipeline_stages": strategy.pipeline_stages,
        "num_microbatches": strategy.num_microbatches,
        "pipeline_schedule": strategy.pipeline_schedule,
    }


def _ef_layout(program) -> Optional[Dict[str, Any]]:
    """The error-feedback transfer layout of a comm-rewritten program:
    which grads ride which transfer, in which order, at which flat
    sizes — everything `_remap_error_feedback` needs to re-map residual
    state onto a DIFFERENT dp world (var names and row counts both
    change with dp)."""
    if not getattr(program, "_dp_comm_applied", False):
        return None
    block = program.global_block()
    comm = next((op for op in block.ops if op.type == "dp_grad_comm"), None)
    if comm is None or not comm.attrs.get("error_feedback"):
        return None
    err_names = list(comm.inputs.get("ErrIn", []))
    if not err_names:
        return None
    kinds = comm.attrs["kinds"]
    numels = comm.attrs["numels"]
    grads = list(comm.inputs["X"])
    dp = int(comm.attrs["dp"])
    tp = int(getattr(program, "_tp_size", 0) or 0) \
        if getattr(program, "_tp_applied", False) else 0

    def _grad_geometry(gname):
        """(global shape, tp-sharded dim index or None) of a gradient —
        what lets the restore re-map a residual segment through the
        GLOBAL gradient space when the tp degree changes across a
        resize. The comm plan's numels are tp-LOCAL; the grad var's
        declared shape is global, its `tp_spec` (tp_shard_pass marker)
        names the dim the tp axis splits."""
        from ..framework.sharding import tp_component
        g = block.var(gname)
        gshape = list(g.shape or ())
        comp = tp_component(getattr(g, "tp_spec", None)) if tp > 1 \
            else None
        tp_dim = None
        if comp is not None:
            dims = [d for d, s in enumerate(comp) if s is not None]
            enforce(len(dims) == 1,
                    f"gradient {gname!r} is tp-sharded on {len(dims)} "
                    f"dims — the error-feedback resize re-map supports "
                    f"single-dim tp sharding", exc=InvalidArgumentError)
            tp_dim = dims[0]
        return gshape, tp_dim

    transfers = []
    # the pass lays err state out sharded-transfers-first, then buckets —
    # mirror that order (grad_comm.py _comm_optimize_pass_impl)
    for i, kind in enumerate(kinds):
        if kind == "sharded":
            gshape, tp_dim = _grad_geometry(grads[i])
            transfers.append({"kind": "sharded", "grads": [grads[i]],
                              "numels": [numels[i]], "flat": numels[i],
                              "gshapes": [gshape], "tp_dims": [tp_dim]})
    for idxs in comm.attrs["buckets"]:
        flat = sum(numels[i] for i in idxs)
        geo = [_grad_geometry(grads[i]) for i in idxs]
        transfers.append({"kind": "bucket",
                          "grads": [grads[i] for i in idxs],
                          "numels": [numels[i] for i in idxs],
                          "flat": -(-flat // dp) * dp,
                          "gshapes": [g for g, _ in geo],
                          "tp_dims": [d for _, d in geo]})
    enforce(len(transfers) == len(err_names),
            f"error-feedback layout mismatch: {len(transfers)} transfers "
            f"vs {len(err_names)} state vars", exc=InvalidArgumentError)
    for t, name in zip(transfers, err_names):
        t["var"] = name
    return {"dp": dp, "tp": max(tp, 1),
            "quant": comm.attrs["quant"], "block": comm.attrs["block"],
            "transfers": transfers}



# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

_PENDING: List["AsyncSnapshot"] = []
_pending_lock = threading.Lock()
_serial_lock = threading.Lock()
_last_serial = -1

# host bytes currently staged for in-flight snapshot writes (the copies a
# writer still holds) ride the shared host pool ledger
# (framework/offload.py, category "staging"): the host_staging_bytes
# watermark, the census host-tier rows and /healthz read the same source
# as the KV spill tier.


def _note_staging(delta: float):
    from ..framework import offload as _offload
    # the pool's lock computes the total AND publishes the watermark in
    # one critical section: two writers finishing together publish in
    # total order, so the channel's "current" cannot stick stale
    _offload.shared_host_pool()._credit("staging", int(delta))


def _alloc_serial(root: str) -> int:
    """Monotone snapshot serial: max(disk, in-process counter) under a
    lock, so two async saves racing before either's directory exists
    cannot mint the same serial (their staging dirs would collide and
    the second rename would clobber the first commit)."""
    global _last_serial
    with _serial_lock:
        snaps = list_snapshots(root, committed_only=False)
        serial = max(_last_serial + 1,
                     (snaps[-1][0] + 1) if snaps else 0)
        _last_serial = serial
        return serial


class AsyncSnapshot:
    """Handle for a background snapshot write. The copy off the card is
    enqueued (on a card: ordered before the next step's writes on the
    device) when this handle exists — the training loop may go on at
    once. result() blocks until the commit (re-raising any writer
    exception) and returns the committed snapshot path (None when a
    barrier aborted)."""

    def __init__(self, serial: Optional[int] = None):
        self._event = threading.Event()
        self._path: Optional[str] = None
        self._exc: Optional[BaseException] = None
        self._serial = serial
        self._copies: List[_HostCopy] = []

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> str:
        if not self._event.wait(timeout):
            raise TimeoutError("snapshot write not committed in time")
        if self._exc is not None:
            raise self._exc
        return self._path

    def _finish(self, path=None, exc=None):
        self._path = path
        self._exc = exc
        with _pending_lock:
            if self in _PENDING:
                _PENDING.remove(self)
        self._event.set()


def wait_for_pending(timeout: Optional[float] = None):
    """Block until every in-flight async snapshot committed — the drain
    hook (EngineServer drain, end of training) that guarantees no writer
    thread still holds staged state when the process exits."""
    with _pending_lock:
        pending = list(_PENDING)
    for h in pending:
        h.result(timeout)


def _collect_train_arrays(program, scope) -> Dict[str, object]:
    """Every persistable of the training state. Optimizer state a
    ParallelExecutor offloaded to the host is restored first, so a
    snapshot is complete with offload on too (the JAX package keeps only
    what its scope holds, and drops the offloaded moments)."""
    from ..framework.offload import restore_offloaded
    from ..io import _is_persistable, _select_vars
    restore_offloaded(scope)
    arrays = {}
    for v in _select_vars(program, _is_persistable):
        if scope.has_var(v.name):
            arrays[v.name] = scope.get(v.name)
    enforce(arrays, "no persistable state in scope — run the startup "
            "program before snapshotting", exc=InvalidArgumentError)
    return arrays


def _prepared_view(executor, program, scope):
    """The program AS THE EXECUTOR RUNS IT: ParallelExecutor rewrites it
    (tp / dp-comm / pipeline), and the checkpoint's contents and
    placements follow the rewritten view (split accumulators,
    error-feedback vars)."""
    if executor is not None and hasattr(executor, "prepare_program"):
        return executor.prepare_program(program, scope)
    return program



# ---------------------------------------------------------------------------
# the device -> host copy (the GPU mechanism of the async path)
# ---------------------------------------------------------------------------

_ALIGN = 256
_transfer_streams: Dict[Any, Any] = {}
_slabs: List[Any] = []          # page-locked slabs free for reuse
_slab_lock = threading.Lock()


class _HostCopy:
    """The host side of one snapshot's chunks: `chunks` (key -> CPU
    tensor), valid once `wait()` returned. `release()` gives a pinned slab
    back for the next snapshot."""

    def __init__(self, chunks, ticket=None, slab=None):
        self.chunks = chunks
        self.ticket = ticket
        self.slab = slab
        self.nbytes = int(sum(t.numel() * t.element_size()
                              for t in chunks.values()))

    def wait(self):
        if self.ticket is not None:
            self.ticket.wait()

    def d2h_seconds(self) -> Optional[float]:
        """The side stream's copy time (timing events), once done."""
        return None if self.ticket is None else self.ticket.elapsed_s()

    def release(self):
        if self.slab is not None:
            with _slab_lock:
                _slabs.append(self.slab)
            self.slab = None


def _take_slab(nbytes: int):
    """A page-locked slab of at least `nbytes` (reused when one is free)."""
    from ..framework import offload as _offload
    with _slab_lock:
        for i, s in enumerate(_slabs):
            if s.slot_nbytes >= nbytes:
                return _slabs.pop(i)
    return _offload.HostSlab(_offload.shared_host_pool(), 1, max(nbytes, 1),
                             "staging", pin=True)


def _host_copy(chunks: Dict[str, torch.Tensor], block: bool) -> _HostCopy:
    """Copy the chunks off the card. Blocking: one synchronous copy each.
    Async on a card: every chunk into one pinned slab on the device's
    side stream after an event of the compute stream, then the compute
    stream waits on the copy's event (the next step's in-place writes
    cannot overtake the copy). On the CPU the chunks are cloned: the
    next step updates the state in place."""
    cuda = [t for t in chunks.values() if t.device.type == "cuda"]
    if not cuda:
        return _HostCopy({k: t.detach().clone() if not block else t.detach()
                          for k, t in chunks.items()})
    if block:
        return _HostCopy({k: t.detach().cpu() for k, t in chunks.items()})
    from ..framework import offload as _offload
    device = cuda[0].device
    enforce(all(t.device == device for t in cuda),
            "a snapshot's chunks lie on several cards; a rank owns one",
            exc=InvalidArgumentError)
    offsets, total = {}, 0
    for k, t in chunks.items():
        offsets[k] = total
        total += -(-t.numel() * t.element_size() // _ALIGN) * _ALIGN
    slab = _take_slab(total)
    flat = slab.tensor.view(-1)
    host = {}
    for k, t in chunks.items():
        n = t.numel() * t.element_size()
        host[k] = flat[offsets[k]:offsets[k] + n].view(t.dtype).view(
            t.shape)
    ts = _transfer_streams.get(device)
    if ts is None:
        from ..core.places import CUDAPlace
        ts = _transfer_streams[device] = _offload.TransferStream(
            CUDAPlace(device.index))
    compute = torch.cuda.current_stream(device)
    after = torch.cuda.Event()
    after.record(compute)

    def copy():
        for k, t in chunks.items():
            host[k].copy_(t.detach(), non_blocking=True)

    ticket = ts.submit("d2h", copy, total, tag="snapshot", after=after)
    compute.wait_event(ticket.event)
    return _HostCopy(host, ticket=ticket, slab=slab)


def _after(earlier):
    """Wait for the async snapshots taken before this one: a process's
    snapshots commit in the order they were taken, so of two taken at one
    step the later one is the one latest_snapshot picks (it ranks equal
    steps by commit time)."""
    for h in earlier:
        h._event.wait()


def _placement_of(executor, prepared, name):
    if executor is not None and hasattr(executor, "state_sharding"):
        return executor.state_sharding(prepared, name)
    return None


def _placements(executor, prepared, arrays) -> Dict[str, Any]:
    """Per-var placement at save time, recorded in train_meta.json — the
    `old placement` side of the resize planner (parallel/reshard.py):
    which mesh axes split which dim; [] replicated over the mesh, null
    with no mesh."""
    out = {}
    for name in arrays:
        p = _placement_of(executor, prepared, name)
        if p is None:
            out[name] = None
            continue
        out[name] = [None if s is None else
                     list(s) if isinstance(s, (tuple, list)) else [s]
                     for s in p]
    return out


def _global_shapes(prepared, arrays) -> Dict[str, tuple]:
    from ..parallel.parallel_executor import ParallelExecutor
    out = {}
    for name, val in arrays.items():
        v = ParallelExecutor._find_var(prepared, name)
        shape = tuple(getattr(v, "shape", None) or ())
        out[name] = shape if shape and -1 not in shape else tuple(val.shape)
    return out


#: the last single-writer commit of this process: its path, the bytes
#: copied off the device, the side stream's copy seconds (async on a
#: card; else None) and the write + commit seconds
last_save: Dict[str, Any] = {}

_round_seq: Dict[tuple, int] = {}


def _store_world(mesh):
    """The StoreWorld of this rank for the next barrier round over the
    ranks of `mesh` (every rank of the mesh counts rounds alike)."""
    import torch.distributed as dist

    from .process_world import StoreWorld
    key = tuple(mesh.ranks)
    _round_seq[key] = _round_seq.get(key, 0) + 1
    tag = "ckpt-" + "-".join(map(str, key)) + f"-{_round_seq[key]}"
    store = dist.distributed_c10d._get_default_store()
    return StoreWorld(store, mesh.ranks, mesh.rank, tag)


def save_train_state(root: str,
                     program=None, scope=None, executor=None,
                     step: int = 0, extra_meta: Optional[dict] = None,
                     max_snapshots: int = 3,
                     block: bool = True,
                     world=None,
                     barrier_deadline_s: float = 60.0):
    """Snapshot the complete training state under `root` with the atomic
    two-phase commit. Returns the committed snapshot path (block=True) or
    an AsyncSnapshot handle (block=False: the caller's thread pays only
    the copy's enqueue; a writer thread writes and commits).

    `executor` is the executor DRIVING training (Executor or
    ParallelExecutor): its run counter rides the metadata, so a restored
    run draws exactly the seeds the uninterrupted run would have; a
    ParallelExecutor adds its BuildStrategy / mesh, the rewritten
    program's state (ZeRO-1 accumulators, error-feedback residuals) and
    each var's placement.

    Every rank of a ParallelExecutor's mesh that spans several processes
    calls this at the same step: each writes its own blocks, and the
    chief-commits barrier (over the world's c10d store, deadline
    `barrier_deadline_s`) commits one snapshot. `world` (a
    ProcessWorld) runs that barrier over simulated ranks inside this
    process, the mesh's ranks split among them. A straggler past the
    deadline or a dead rank ABORTS the snapshot (returns None /
    AsyncSnapshot.result() -> None; counted in
    ptpu_ckpt_barrier_aborts_total) and training continues."""
    from ..framework.program import default_main_program
    from ..framework.scope import global_scope
    from ..observability import tracing as _tracing
    from ..sharded_checkpoint import collect_chunks

    program = program or default_main_program()
    scope = scope or global_scope()
    prepared = _prepared_view(executor, program, scope)
    arrays = _collect_train_arrays(prepared, scope)
    mesh = getattr(executor, "mesh", None)
    strategy = getattr(executor, "build_strategy", None)
    real = world is None and mesh is not None and mesh.joined \
        and mesh.num_devices > 1
    if real:
        world = _store_world(mesh)
    placements = {n: _placement_of(executor, prepared, n) for n in arrays}
    shapes = _global_shapes(prepared, arrays)
    meta = {
        "format": META_FORMAT,
        "step": int(step),
        "run_counter": int(getattr(executor, "_run_counter", 0) or 0),
        "random_seed": int(program.random_seed),
        "world": dict(getattr(mesh, "axes", {}) or {}),
        "world_size": world.world_size if world is not None else 1,
        "strategy": _strategy_dict(strategy),
        "ef_layout": _ef_layout(prepared),
        "placements": _placements(executor, prepared, arrays),
        "extra": dict(extra_meta or {}),
        "var_names": sorted(arrays),
    }

    if world is not None:
        with _tracing.span("checkpoint", "elastic/snapshot_d2h",
                           n_vars=len(arrays), step=int(step),
                           world_size=world.world_size):
            if real:
                chunks, manifest, _ = collect_chunks(
                    arrays, process_index=world.rank,
                    world_size=world.world_size, mesh=mesh,
                    placements=placements, shapes=shapes, local=True)
                copies = {world.rank: (_host_copy(chunks, block), manifest)}
            else:
                copies = {r: (_host_copy(c, block), m) for r, (c, m) in
                          _collect_rank_chunks(world, arrays, mesh,
                                               placements).items()}
        staged = sum(float(h.nbytes) for h, _ in copies.values())
        os.makedirs(root, exist_ok=True)
        serial = (world.agree("serial", lambda: _alloc_serial(root))
                  if real else _alloc_serial(root))
        _note_staging(staged)

        def _commit_world():
            for h, _ in copies.values():
                h.wait()
            payloads = {r: (h.chunks, m) for r, (h, m) in copies.items()}
            return _barrier_write_and_commit(
                world, root, serial, payloads, meta, max_snapshots, step,
                barrier_deadline_s)

        def _done():
            _note_staging(-staged)
            for h, _ in copies.values():
                h.release()

        if block:
            try:
                return _commit_world()
            finally:
                _done()
        handle = AsyncSnapshot(serial)
        handle._copies = [h for h, _ in copies.values()]
        with _pending_lock:
            earlier = list(_PENDING)
            _PENDING.append(handle)

        def _bwriter():
            try:
                _after(earlier)
                handle._finish(path=_commit_world())
            except BaseException as e:  # noqa: BLE001 - via result()
                handle._finish(exc=e)
            finally:
                _done()

        t = threading.Thread(target=_bwriter,
                             name=f"ckpt-barrier-{serial}", daemon=True)
        t.start()
        return handle

    with _tracing.span("checkpoint", "elastic/snapshot_d2h",
                       n_vars=len(arrays), step=int(step)):
        chunks, manifest, pid = collect_chunks(arrays, local=False)
        copy = _host_copy(chunks, block)
    staged = float(copy.nbytes)

    os.makedirs(root, exist_ok=True)
    serial = _alloc_serial(root)
    final = os.path.join(root, f"{SNAPSHOT_PREFIX}{serial:08d}")
    staging = os.path.join(root,
                           f"{STAGING_PREFIX}{serial:08d}-{os.getpid()}")
    # only note once the can-raise setup is done, so the compensating
    # decrement in the finally always runs
    _note_staging(staged)

    def _commit_one():
        copy.wait()
        t0 = time.perf_counter()
        path = _write_and_commit(staging, final, copy.chunks, manifest,
                                 pid, meta, root, max_snapshots, step,
                                 serial)
        last_save.update(path=path, bytes=copy.nbytes,
                         d2h_s=copy.d2h_seconds(),
                         write_s=time.perf_counter() - t0)
        return path

    if block:
        try:
            return _commit_one()
        finally:
            _note_staging(-staged)
            copy.release()
    handle = AsyncSnapshot(serial)
    handle._copies = [copy]
    with _pending_lock:
        earlier = list(_PENDING)
        _PENDING.append(handle)

    def _writer():
        try:
            _after(earlier)
            handle._finish(path=_commit_one())
        except BaseException as e:  # noqa: BLE001 - surfaced via result()
            handle._finish(exc=e)
        finally:
            _note_staging(-staged)
            copy.release()

    t = threading.Thread(target=_writer, name=f"ckpt-writer-{serial}",
                         daemon=True)
    t.start()
    return handle

def _stage_digests(staging: str) -> Dict[str, dict]:
    """Per-file {size, crc32} integrity entries for a staging dir's
    payload. The digest re-reads the just-written files: page-cache-hot,
    so it is a memory-speed pass rather than a second disk round trip,
    and hashing the on-disk container bytes keeps the digest's meaning
    independent of the writer's serialization internals (a streamed
    in-memory hash would silently diverge from disk if the container
    format ever buffered/reordered)."""
    return {n: {"size": os.path.getsize(os.path.join(staging, n)),
                "crc32": file_digest(os.path.join(staging, n))}
            for n in _payload_files(staging)}


def _commit_marker_and_retain(root: str, final: str, files: Dict,
                              n_manifests: int, step: int,
                              world_info: Dict, max_snapshots: int):
    """THE commit point, shared by the single-writer save and the
    chief's barrier commit so the COMMIT record format and the
    retention rule exist exactly once: write the integrity record to a
    temp name, fsync, atomically rename it in, fsync the dir, then
    prune retention by the SAME (step, commit_ts, serial) ranking
    selection uses — a stale writer minting later serials at earlier
    steps must never push the newest-step snapshot out of retention."""
    from ..sharded_checkpoint import _fsync_file
    marker = os.path.join(final, COMMIT_MARKER)
    with open(marker + ".tmp", "w") as f:
        json.dump({"format": COMMIT_FORMAT, "manifests": n_manifests,
                   "files": files, "step": int(step),
                   "commit_ts": time.time(), "world": world_info}, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(marker + ".tmp", marker)
    _fsync_file(final)
    if max_snapshots and max_snapshots > 0:
        for old in _ranked_snapshots(root)[:-max_snapshots]:
            shutil.rmtree(old, ignore_errors=True)


def _write_and_commit(staging, final, chunks, manifest, pid, meta,
                      root, max_snapshots, step, serial) -> str:
    """Phase 2: staged writes, fsync, rename, COMMIT marker, retention.
    The fault-injection crash points live here (see
    fault_injection_config)."""
    from ..observability import tracing as _tracing
    from ..sharded_checkpoint import _fsync_file, write_chunks

    fault = fault_injection_config()
    slow = fault.get("slow_writer")
    if slow:
        time.sleep(float(slow))
    t0 = time.perf_counter()
    with _tracing.span("checkpoint", "elastic/snapshot_write",
                       step=int(step)):
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        write_chunks(staging, chunks, manifest, pid, fsync=True)
        meta_path = os.path.join(staging, META_FILE)
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=1)
            f.flush()
            os.fsync(f.fileno())

        mid = fault.get("crash_mid_save")
        if mid is not None:
            _crash_mid_staging(staging, int(mid))  # may not return
        payload = _stage_digests(staging)
        n_manifests = len([n for n in payload if n.startswith("manifest-")])

    with _tracing.span("checkpoint", "elastic/commit", step=int(step)):
        if os.path.isdir(final):
            # leftovers of a preempted save that never committed (a
            # COMMITTED dir at this serial is impossible: the serial scan
            # above counted it)
            shutil.rmtree(final)
        os.replace(staging, final)
        _fsync_file(root)
        payload_bytes = sum(e["size"] for e in payload.values())
        if mid is not None and int(mid) == payload_bytes:
            # crash point "after rename, before COMMIT": the snapshot dir
            # is visible but uncommitted — restore must skip it
            _sigkill_self()  # pragma: no cover
        _commit_marker_and_retain(
            root, final, payload, n_manifests, step,
            {"world_size": meta.get("world_size", 1),
             "axes": meta.get("world", {})}, max_snapshots)
    if mid is not None and int(mid) > payload_bytes:
        _sigkill_self()  # pragma: no cover

    # sweep stale SINGLE-WRITER staging dirs (.tmp-<serial>-<pid>) from
    # earlier preempted/dead saves — never one a LIVE async writer of
    # this process still owns (its serial is >= the oldest pending
    # serial), and never the barrier protocol's -rank<r>/-world<pid>
    # dirs, whose rounds are not tracked in _PENDING (blocking barrier
    # saves) and are swept by the barrier's own commit
    with _pending_lock:
        live = {h._serial for h in _PENDING if h._serial is not None}
    floor = min(live | {serial})
    stale_re = re.compile(re.escape(STAGING_PREFIX) + r"(\d+)-(\d+)$")
    for name in os.listdir(root):
        m = stale_re.match(name)
        if m and int(m.group(1)) < floor and \
                os.path.join(root, name) != staging:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)

    dt = time.perf_counter() - t0
    _metric("ptpu_ckpt_saves_total").inc()
    _metric("ptpu_ckpt_save_bytes_total").inc(payload_bytes)
    _metric("ptpu_ckpt_save_seconds").observe(dt)
    flags.vlog(1, "committed snapshot %s (%d bytes, %.3fs)", final,
               payload_bytes, dt)
    return final



# ---------------------------------------------------------------------------
# chief-commits multi-writer barrier
# ---------------------------------------------------------------------------

def _collect_rank_chunks(world, arrays: Dict[str, object], mesh,
                         placements: Dict[str, Any]):
    """The per-rank selection of a simulated multi-writer save (one
    process holding every value whole): the mesh's ranks split into
    world_size contiguous groups, and each simulated rank collects the
    blocks of its group's ranks that those ranks write (the replicated
    blocks once, by coordinate 0). Vars with no placement (no mesh) are
    written by the chief alone. Returns {rank: (chunks, manifest)}."""
    from ..sharded_checkpoint import collect_chunks

    enforce(mesh is not None,
            "a multi-writer save needs the executor's mesh to partition "
            "ownership across ranks", exc=InvalidArgumentError)
    ranks = list(mesh.ranks)
    n = world.world_size
    enforce(len(ranks) % n == 0,
            f"mesh has {len(ranks)} rank(s), not divisible by "
            f"world_size={n}: every rank must own an equal group",
            exc=InvalidArgumentError)
    per = len(ranks) // n
    placed = {k: v for k, v in arrays.items()
              if placements.get(k) is not None}
    host = {k: v for k, v in arrays.items() if placements.get(k) is None}
    payloads = {}
    for r in range(n):
        chunks, manifest = {}, None
        for m in ranks[r * per:(r + 1) * per]:
            c, man, _ = collect_chunks(placed, process_index=r,
                                       world_size=n, mesh=mesh,
                                       placements=placements, rank=m,
                                       local=False)
            chunks.update(c)
            if manifest is None:
                manifest = man
            else:
                for name, entry in man.items():
                    if name == "__meta__":
                        continue
                    if name in manifest:
                        manifest[name]["chunks"].extend(entry["chunks"])
                    else:
                        manifest[name] = entry
        if world.is_chief(r) and host:
            c, man, _ = collect_chunks(host, process_index=r, world_size=n,
                                       local=False)
            chunks.update(c)
            manifest.update({k: v for k, v in man.items()
                             if k != "__meta__"})
        payloads[r] = (chunks, manifest)
    return payloads

def _rank_staging_dir(root: str, serial: int, rank: int) -> str:
    return os.path.join(root, f"{STAGING_PREFIX}{serial:08d}-rank{rank}")


def _stage_rank_files(world, root: str, serial: int, rank: int,
                      chunks, manifest) -> Dict[str, dict]:
    """Phase `stage` + `ack` of one rank: write this rank's shard
    container + manifest into its RANK-PRIVATE staging directory, fsync
    everything, then build the per-file digest manifest the ack carries.
    The two fault points bracket exactly the states the crash matrix
    needs: died mid-write (possibly at a byte offset) vs staged-durable-
    but-ack-unsent."""
    from ..observability import tracing as _tracing
    from ..sharded_checkpoint import write_chunks

    staging = _rank_staging_dir(root, serial, rank)
    with _tracing.span("checkpoint", "barrier/stage", rank=rank,
                       serial=serial):
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        write_chunks(staging, chunks, manifest, rank, fsync=True)
        world.fault(rank, "stage", staging=staging, serial=serial)
        digests = _stage_digests(staging)
    world.fault(rank, "ack", serial=serial)
    return digests


def _chief_commit(world, root: str, serial: int, own_files: Dict,
                  expected: List[int], meta: Dict, max_snapshots: int,
                  step: int, deadline_s: float) -> Optional[str]:
    """The chief's half of the barrier: collect every expected rank's
    digest ack within the deadline, then make the ensemble atomic —
    assemble every rank's staged files into one directory, write the
    train metadata, rename the directory into place, and only then
    atomically rename in the ONE global COMMIT record binding every
    rank's manifest. Any rank missing at the deadline aborts the
    snapshot (training continues; the attempt's staging is swept).
    Returns (committed path, payload bytes) — (None, 0) on abort."""
    from ..observability import tracing as _tracing
    from ..sharded_checkpoint import _fsync_file

    chief = world.chief
    acks: Dict[int, Dict] = {chief: own_files}
    t_wait = time.perf_counter()
    deadline = time.monotonic() + deadline_s
    while set(acks) < set(expected):
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        msg = world.recv(chief, timeout=remaining)
        if msg is None:
            break
        if (msg.get("kind") == "ack"
                and int(msg.get("serial", -1)) == serial):
            acks[int(msg["rank"])] = msg["files"]
    # the chief's wait-for-acks window as a span: its duration IS the
    # straggler gap a merged timeline shows the chief blocked on
    _tracing.record_span("checkpoint", "barrier/collect_acks",
                         t_wait, time.perf_counter(), rank=chief,
                         serial=serial, acked=sorted(acks))

    missing = sorted(set(expected) - set(acks))
    if missing:
        flags.vlog(0, "barrier abort: snapshot serial %d missing ack(s) "
                   "from rank(s) %s after %.1fs deadline — training "
                   "continues without this snapshot", serial, missing,
                   deadline_s)
        _metric("ptpu_ckpt_barrier_aborts_total").inc()
        # sweep only ACKED ranks' staging: a missing rank may be a
        # straggler STILL writing its private dir — it cleans up itself
        # on the abort verdict, or the next commit's stale sweep does
        for r in acks:
            shutil.rmtree(_rank_staging_dir(root, serial, r),
                          ignore_errors=True)
        for r in range(world.world_size):
            if r != chief:
                world.send(chief, r, "abort", serial=serial)
        return None, 0

    # every live rank's shards are durable on disk — the commit point
    world.fault(chief, "barrier", serial=serial)
    t_commit = time.perf_counter()
    assembly = os.path.join(
        root, f"{STAGING_PREFIX}{serial:08d}-world{os.getpid()}")
    if os.path.isdir(assembly):
        shutil.rmtree(assembly)
    os.makedirs(assembly)
    files: Dict[str, dict] = {}
    for r, rank_files in sorted(acks.items()):
        staging = _rank_staging_dir(root, serial, r)
        for name, entry in rank_files.items():
            enforce(name not in files,
                    f"barrier commit: rank {r} staged {name!r} which "
                    f"another rank already owns — rank file namespaces "
                    f"must be disjoint", exc=InvalidArgumentError)
            os.replace(os.path.join(staging, name),
                       os.path.join(assembly, name))
            files[name] = entry
        shutil.rmtree(staging, ignore_errors=True)
    meta_path = os.path.join(assembly, META_FILE)
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    files[META_FILE] = {"size": os.path.getsize(meta_path),
                        "crc32": file_digest(meta_path)}
    _fsync_file(assembly)

    final = os.path.join(root, f"{SNAPSHOT_PREFIX}{serial:08d}")
    if os.path.isdir(final):
        # leftovers of a preempted attempt that never committed (a
        # COMMITTED dir at this serial is impossible: _alloc_serial
        # scanned past it)
        shutil.rmtree(final)
    os.replace(assembly, final)
    _fsync_file(root)
    world.fault(chief, "commit", serial=serial)
    n_manifests = len([n for n in files if n.startswith("manifest-")])
    _commit_marker_and_retain(
        root, final, files, n_manifests, step,
        {"world_size": world.world_size, "axes": meta.get("world", {})},
        max_snapshots)
    world.fault(chief, "post", serial=serial)
    _tracing.record_span("checkpoint", "barrier/commit", t_commit,
                         time.perf_counter(), rank=chief, serial=serial)

    # sweep staging leftovers of EARLIER barrier rounds (aborted or
    # crashed attempts); rounds are serialized on world.barrier_lock, so
    # a lower serial can never belong to a live writer
    stale_re = re.compile(re.escape(STAGING_PREFIX)
                          + r"(\d+)-(?:rank\d+|world\d+)$")
    for name in os.listdir(root):
        m = stale_re.match(name)
        if m and int(m.group(1)) < serial:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
    for r in range(world.world_size):
        if r != chief:
            world.send(chief, r, "committed", serial=serial, path=final)
    return final, sum(e["size"] for e in files.values())


def _barrier_write_and_commit(world, root: str, serial: int,
                              rank_payloads: Dict, meta: Dict,
                              max_snapshots: int, step: int,
                              deadline_s: float) -> Optional[str]:
    """Run the chief-commits barrier over the world: every rank stages
    and acks; the chief waits, binds, and commits. Returns the committed
    path, or None when the barrier aborted (straggler/dead rank)."""
    from ..observability import flight_recorder as _fr
    from ..observability import tracing as _tracing

    fault = fault_injection_config()
    slow = fault.get("slow_writer")
    if slow:
        time.sleep(float(slow))
    if world.dead:
        # a dead rank can never stage its shard of the state, so no
        # COMPLETE snapshot can commit in this world again: fail fast
        # instead of letting the live ranks stage and time out. The
        # recovery is a whole-gang restart (Supervisor world_size
        # semantics), not a partial commit.
        flags.vlog(0, "barrier abort: rank(s) %s are dead — no complete "
                   "snapshot can commit in this world; restart the gang",
                   sorted(world.dead))
        _metric("ptpu_ckpt_barrier_aborts_total").inc()
        return None
    t0 = time.perf_counter()
    committed_bytes: List[int] = []   # filled by the chief on commit

    def rank_fn(rank: int):
        chunks, manifest = rank_payloads[rank]
        if world.is_chief(rank):
            # the whole chief branch — its OWN staging included — is
            # wrapped: a chief dying at ANY phase (stage/ack/barrier/
            # commit) must not leave the other ranks blocked on a
            # verdict that will never come, and the abort must be
            # visible in the metrics
            try:
                digests = _stage_rank_files(world, root, serial, rank,
                                            chunks, manifest)
                path, nbytes = _chief_commit(world, root, serial,
                                             digests, expected, meta,
                                             max_snapshots, step,
                                             deadline_s)
                committed_bytes.append(nbytes)
                return path
            except BaseException:
                _metric("ptpu_ckpt_barrier_aborts_total").inc()
                for r in range(world.world_size):
                    if r != rank:
                        world.send(rank, r, "abort", serial=serial)
                raise
        digests = _stage_rank_files(world, root, serial, rank, chunks,
                                    manifest)
        world.send(rank, world.chief, "ack", serial=serial, rank=rank,
                   files=digests)
        # wait for the chief's verdict; a silent timeout (chief dead)
        # counts as an abort from this rank's perspective
        limit = time.monotonic() + deadline_s + 30.0
        while True:
            msg = world.recv(rank, timeout=max(0.1,
                                               limit - time.monotonic()))
            if msg is None and time.monotonic() >= limit:
                return None
            if msg and int(msg.get("serial", -1)) == serial:
                if msg["kind"] == "committed":
                    return msg["path"]
                if msg["kind"] == "abort":
                    shutil.rmtree(_rank_staging_dir(root, serial, rank),
                                  ignore_errors=True)
                    return None

    # the state board names the ACTIVE barrier round: a dossier dumped
    # while this round runs (rank death, enforce error) records which
    # serial/step was in flight
    _fr.set_state("barrier", serial=serial, step=int(step),
                  world_size=world.world_size, world=world.world_id,
                  status="running")
    with _tracing.span("checkpoint", "elastic/barrier_commit",
                       step=int(step), world_size=world.world_size), \
            world.barrier_lock:
        # EVERY rank's shard is needed for a complete snapshot: a rank
        # dying mid-round surfaces as a missing ack -> abort
        expected = list(range(world.world_size))
        world.drain(world.chief)  # no stale acks from an aborted round
        results = world.run(rank_fn)
    # this rank's verdict (the chief's, in a simulated world)
    path = results[getattr(world, "rank", world.chief)]
    _fr.set_state("barrier", serial=serial,
                  status="committed" if path is not None else "aborted")
    if path is not None:
        dt = time.perf_counter() - t0
        nbytes = committed_bytes[0] if committed_bytes else 0
        _metric("ptpu_ckpt_saves_total").inc()
        _metric("ptpu_ckpt_save_bytes_total").inc(nbytes)
        _metric("ptpu_ckpt_save_seconds").observe(dt)
        flags.vlog(1, "barrier-committed snapshot %s (%d ranks, %d "
                   "bytes, %.3fs)", path, len(expected), nbytes, dt)
    return path



# ---------------------------------------------------------------------------
# error-feedback N→M re-mapping
# ---------------------------------------------------------------------------

def _resize_replica_rows(rows: np.ndarray, new_n: int) -> np.ndarray:
    """Re-map per-replica residual rows [N, n] onto M replicas while
    preserving the EFFECTIVE pending gradient: each step applies
    mean_i(g_i + e_i), so the pending correction is (1/N)·Σe — rows are
    scaled by M/N so (1/M)·Σe' == (1/N)·Σe exactly. Growing pads zero
    rows (new replicas start with no residual); shrinking folds rows
    modulo M. pad-then-fold is the identity, so an N→M→N round trip with
    M ≥ N restores the original rows bit-exactly when M/N is a power of
    two (f32 scaling by powers of two is exact)."""
    n_old = rows.shape[0]
    scale = np.float32(new_n) / np.float32(n_old)
    out = np.zeros((new_n,) + rows.shape[1:], rows.dtype)
    if new_n >= n_old:
        out[:n_old] = rows
    else:
        for i in range(n_old):
            out[i % new_n] += rows[i]
    return (out * scale).astype(rows.dtype)


def _remap_error_feedback(ckpt, old_layout: Dict, new_layout: Dict,
                          new_dp: int) -> Dict[str, np.ndarray]:
    """Saved residual state (old transfer layout, old dp×tp rows) → host
    arrays for the NEW layout's error-feedback vars (new dp×tp rows),
    across an ARBITRARY mesh resize of the dp and tp axes.

    Per-gradient segments are extracted from the old flat vectors; dp
    replica rows re-map via `_resize_replica_rows` (grow pads zero rows,
    shrink folds mod M, scaled M/N so the effective pending correction
    (1/N)·Σe is preserved); gradients may move between transfers when
    their dp/quant-block classification changes with the resize. Bucket
    pad regions carry an identically zero residual (quantizing an exact
    zero leaves no residual), so dropping/re-padding them is lossless.

    The tp axis: when the tp degree is UNCHANGED, every (tp, dp)
    coordinate's rows re-map independently — a same-world restore is
    bitwise. When it CHANGES, segments travel through the gradient's
    GLOBAL coordinate space (`ef_layout` gshapes/tp_dims): a tp-sharded
    gradient's per-shard segments reassemble along the recorded tp dim
    and re-slice into the new degree's locals EXACTLY; a gradient
    replicated over tp collapses to the MEAN of its per-shard rows and
    broadcasts to the new shards — per-shard residuals legitimately
    differ there (quantization scale blocks span neighboring tp-local
    bucket segments), so no bijection exists across a tp change and the
    mean is the unbiased mass-preserving choice, off from any single
    shard's rows by at most the wire-format quantization noise."""
    enforce((old_layout["quant"], old_layout["block"])
            == (new_layout["quant"], new_layout["block"]),
            f"error-feedback state is only meaningful under the wire "
            f"config that produced it: checkpoint quant="
            f"{old_layout['quant']!r}/block={old_layout['block']} vs "
            f"target {new_layout['quant']!r}/{new_layout['block']} — "
            f"restore with the same quant_comm config, or drop "
            f"comm_error_feedback to start residuals at zero",
            exc=InvalidArgumentError)
    old_tp = int(old_layout["tp"])
    new_tp = int(new_layout["tp"])
    old_dp = int(old_layout["dp"])
    tp_resize = old_tp != new_tp
    enforce(not tp_resize or all("gshapes" in t
                                 for t in old_layout["transfers"]),
            f"elastic restore across a tp resize ({old_tp}→{new_tp}) "
            f"needs the gradient geometry in the snapshot's ef_layout — "
            f"this snapshot predates it (format 1); restore at "
            f"tp={old_tp}, or drop comm_error_feedback to start "
            f"residuals at zero", exc=InvalidArgumentError)

    # old per-grad residual segments: grad -> [old_tp, old_dp, n_local]
    per_grad: Dict[str, np.ndarray] = {}
    geometry: Dict[str, tuple] = {}   # grad -> (gshape, tp_dim)
    for t in old_layout["transfers"]:
        arr = np.asarray(ckpt.read(t["var"]))
        enforce(arr.shape == (old_dp * old_tp, t["flat"]),
                f"saved error-feedback var {t['var']!r} has shape "
                f"{arr.shape}, expected {(old_dp * old_tp, t['flat'])} — "
                f"checkpoint metadata disagrees with its contents",
                exc=InvalidArgumentError)
        arr = arr.reshape(old_tp, old_dp, t["flat"])
        gshapes = t.get("gshapes") or [None] * len(t["grads"])
        tp_dims = t.get("tp_dims") or [None] * len(t["grads"])
        off = 0
        for g, n, gshape, tp_dim in zip(t["grads"], t["numels"],
                                        gshapes, tp_dims):
            per_grad[g] = arr[:, :, off:off + n]
            geometry[g] = (gshape, tp_dim)
            off += n

    def _to_global(g, seg):
        """[old_tp, old_dp, n] -> [old_dp, *gshape] (tp resize only)."""
        gshape, tp_dim = geometry[g]
        if tp_dim is None or old_tp == 1:
            # replicated over tp: collapse to the per-shard mean (see
            # docstring — no bijection exists; the mean preserves the
            # average pending correction)
            return seg.mean(axis=0).reshape((old_dp,) + tuple(gshape))
        loc = list(gshape)
        enforce(loc[tp_dim] % old_tp == 0,
                f"gradient {g!r} dim {tp_dim} ({loc[tp_dim]}) does not "
                f"divide over tp={old_tp}", exc=InvalidArgumentError)
        loc[tp_dim] //= old_tp
        parts = [seg[ti].reshape((old_dp,) + tuple(loc))
                 for ti in range(old_tp)]
        return np.concatenate(parts, axis=1 + tp_dim)

    out: Dict[str, np.ndarray] = {}
    for t in new_layout["transfers"]:
        new = np.zeros((new_tp, new_dp, t["flat"]), np.float32)
        gshapes = t.get("gshapes") or [None] * len(t["grads"])
        tp_dims = t.get("tp_dims") or [None] * len(t["grads"])
        off = 0
        for g, n, gshape, tp_dim in zip(t["grads"], t["numels"],
                                        gshapes, tp_dims):
            seg = per_grad.get(g)
            if seg is None:
                off += n
                continue
            if not tp_resize:
                # tp unchanged: every (tp, dp) coordinate re-maps its
                # own rows independently — same-world restores are
                # bitwise, per-shard residual identity preserved
                enforce(seg.shape[-1] == n,
                        f"gradient {g!r} changed size across the resize "
                        f"({seg.shape[-1]} vs {n}) — the checkpoint "
                        f"does not match this program",
                        exc=InvalidArgumentError)
                for ti in range(new_tp):
                    new[ti, :, off:off + n] = _resize_replica_rows(
                        seg[ti], new_dp)
                off += n
                continue
            old_gshape, _ = geometry[g]
            enforce(gshape is not None and old_gshape is not None
                    and list(old_gshape) == list(gshape),
                    f"gradient {g!r} changed global shape across the "
                    f"resize ({old_gshape and list(old_gshape)} vs "
                    f"{gshape and list(gshape)}) — the checkpoint does "
                    f"not match this program", exc=InvalidArgumentError)
            glob = _to_global(g, seg)
            resized = _resize_replica_rows(
                glob.reshape(old_dp, -1), new_dp) \
                .reshape((new_dp,) + tuple(gshape))
            if tp_dim is None or new_tp == 1:
                flat = resized.reshape(new_dp, -1)
                enforce(flat.shape[-1] == n,
                        f"gradient {g!r}: global numel {flat.shape[-1]} "
                        f"vs transfer segment {n} — tp geometry "
                        f"mismatch", exc=InvalidArgumentError)
                for ti in range(new_tp):
                    new[ti, :, off:off + n] = flat
            else:
                k = gshape[tp_dim]
                enforce(k % new_tp == 0,
                        f"gradient {g!r} dim {tp_dim} ({k}) does not "
                        f"divide over tp={new_tp}",
                        exc=InvalidArgumentError)
                step = k // new_tp
                for ti in range(new_tp):
                    idx = (slice(None),) * (1 + tp_dim) + \
                        (slice(ti * step, (ti + 1) * step),)
                    new[ti, :, off:off + n] = \
                        resized[idx].reshape(new_dp, n)
            off += n
        out[t["var"]] = new.reshape(new_tp * new_dp, t["flat"])
    return out



# ---------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------

def read_meta(dirname: str) -> Dict[str, Any]:
    """The train_meta.json of a snapshot dir (resolves a root to its
    latest committed snapshot first). Validates sizes and commit
    structure but NOT content digests — a metadata peek must not re-hash
    the whole payload; restore_train_state runs the full validation."""
    dirname = _resolve_snapshot_dir(dirname)
    validate_snapshot(dirname, digests=False)
    with open(os.path.join(dirname, META_FILE)) as f:
        return json.load(f)


def verify_restored_placement(executor, program, scope,
                              names=None) -> List[str]:
    """Static placement check of live state against the executor's
    policy: for every persistable in `names` (default: all in scope) that
    the executor places over its mesh, the scope's value must be this
    rank's block of the declared global shape. Returns the violations
    (empty = clean); restore_train_state enforces on them."""
    from ..io import _is_persistable, _select_vars
    from ..sharded_checkpoint import block_of
    problems = []
    mesh = getattr(executor, "mesh", None)
    if mesh is None or not hasattr(executor, "state_sharding"):
        return problems
    for v in _select_vars(program, _is_persistable):
        if names is not None and v.name not in names:
            continue
        if not scope.has_var(v.name) or not v.shape or -1 in v.shape:
            continue
        val = scope.get(v.name)
        if not isinstance(val, torch.Tensor):
            continue
        want = executor.state_sharding(program, v.name)
        _, block, _ = block_of(mesh, want, mesh.rank, v.shape)
        if list(val.shape) != list(block):
            problems.append(
                f"{v.name}: restored as {list(val.shape)}, the executor "
                f"places this rank's block of {list(v.shape)} as "
                f"{list(block)} ({want!r})")
    return problems


def restore_train_state(path: str,
                        program=None, scope=None, executor=None,
                        strict: bool = True,
                        verify: bool = True,
                        replan: Optional[bool] = None) -> Dict[str, Any]:
    """Restore the latest committed snapshot under `path` (or `path`
    itself when it is a snapshot dir) into `scope`, each rank's block
    placed as the CURRENT executor places it — which may be a different
    dp × pp × tp world than the one that saved (dp2×tp2 → dp4, dp2×pp2 →
    dp2×tp2, a mesh over fewer ranks): parameters and ZeRO-1
    accumulators are read from the chunks each new block intersects,
    straight onto the executor's device; error-feedback residuals re-map
    through `_remap_error_feedback` across dp and tp changes. When the
    world changed, the re-layout is planned first (parallel/reshard.py),
    checked exactly against `framework.costs.reshard_wire_bytes`, and its
    summary returned as meta["reshard"]. Restores the executor's run
    counter, so a fixed-seed resumed run replays the uninterrupted one's
    seeds.

    verify=True (default) runs `analysis.verify_program` over the program
    as the executor rewrites it and checks every restored block against
    the executor's placement before returning.

    strict=True errors on persistables the snapshot lacks; False leaves
    them at their startup values (warm-starting a grown model).

    replan: when the snapshot's world differs from the executor's, run
    the auto-parallel planner over the new world and adopt its choice
    onto the executor before any state is placed
    (framework/auto_parallel.py replan_on_restore; the decision record
    returns as meta["replan"]). Default None follows the executor's
    `BuildStrategy.auto_parallel` (and the PTPU_AUTO_PARALLEL switch).

    Every rank of a ParallelExecutor's mesh calls this. Returns the
    snapshot metadata (step, extra, world, strategy...)."""
    from ..framework.program import default_main_program
    from ..framework.scope import global_scope
    from ..io import _is_persistable, _select_vars
    from ..observability import tracing as _tracing
    from ..sharded_checkpoint import ShardedCheckpoint, restore_array

    from ..framework.offload import restore_offloaded

    t0 = time.perf_counter()
    program = program or default_main_program()
    scope = scope or global_scope()
    # offloaded optimizer state comes home first, so the snapshot's values
    # replace it (and the executor's next step offloads those)
    restore_offloaded(scope)
    dirname = _resolve_snapshot_dir(path)
    validate_snapshot(dirname)
    with open(os.path.join(dirname, META_FILE)) as f:
        meta = json.load(f)

    # re-plan BEFORE the prepared view: the planner may adopt a different
    # strategy and mesh, and everything below must follow the adopted one
    mesh = getattr(executor, "mesh", None)
    want_replan = (replan if replan is not None else bool(
        executor is not None
        and getattr(getattr(executor, "build_strategy", None),
                    "auto_parallel", False)
        and flags.get_flag("auto_parallel")))
    old_world = dict(meta.get("world", {}) or {})
    if (want_replan and executor is not None and mesh is not None
            and old_world != dict(getattr(mesh, "axes", {}) or {})):
        from ..framework import auto_parallel as _auto
        meta["replan"] = _auto.replan_on_restore(
            executor, program, scope, meta, dirname)
        mesh = executor.mesh

    prepared = _prepared_view(executor, program, scope)
    new_ef = _ef_layout(prepared)
    old_ef = meta.get("ef_layout")
    new_dp = int(mesh.axis_size("dp")) if mesh is not None else 1
    device = getattr(executor, "device", None)

    with _tracing.span("checkpoint", "elastic/restore",
                       snapshot=os.path.basename(dirname)):
        ckpt = ShardedCheckpoint(dirname)
        new_world = dict(getattr(mesh, "axes", {}) or {})
        if mesh is not None and old_world != new_world:
            from . import reshard as _reshard
            plan = _reshard.plan_restore(ckpt, meta, prepared, executor)
            bad = _reshard.validate_schedule(plan)
            enforce(not bad,
                    "mesh-resize redistribution schedule does not "
                    "balance against framework.costs predictions:\n  "
                    + "\n  ".join(bad[:10]), exc=InvalidArgumentError)
            meta["reshard"] = plan.summary()
            meta["reshard"]["rank_read_bytes"] = plan.rank_read_bytes(
                mesh.rank)
            flags.vlog(1, "mesh resize %s -> %s: %d var(s), %d moved, "
                       "%.0f wire bytes equivalent, %d bytes read",
                       old_world, new_world, len(plan.variables),
                       len(plan.moved_vars()), plan.wire_bytes,
                       plan.read_bytes)
        saved = set(ckpt.names())
        # the same error-feedback layout as saved: the residuals restore
        # as they are (the re-map would be the identity)
        same_ef = new_ef is not None and \
            json.loads(json.dumps(new_ef)) == old_ef
        ef_vars = set() if same_ef else {
            t["var"] for t in (new_ef or {}).get("transfers", ())}
        restorable, missing = [], []
        for v in _select_vars(prepared, _is_persistable):
            name = v.name
            if name in ef_vars:
                continue  # handled below via the layout re-map
            if name not in saved:
                if getattr(v, "dp_replica_state", False):
                    continue  # stale EF var of another config: skip
                missing.append(name)
                continue
            restorable.append(name)
        # the strict check fires BEFORE any scope mutation: a caller that
        # catches it must not be left with a half-restored mixed state
        enforce(not (strict and missing),
                f"snapshot {dirname!r} lacks persistable var(s) "
                f"{missing[:8]}{'...' if len(missing) > 8 else ''} that "
                f"this program declares — restoring it would silently "
                f"mix checkpointed and freshly initialized state. Pass "
                f"strict=False to warm-start the missing vars from their "
                f"startup values", exc=InvalidArgumentError)
        for name in restorable:
            scope.set_var(name, restore_array(
                ckpt, name, _placement_of(executor, prepared, name), mesh,
                device))
        # what this rank read: reshard's plan predicts it per rank
        meta["restore_read_bytes"] = ckpt.read_bytes

        if new_ef is not None and not same_ef:
            enforce(old_ef is not None,
                    f"this program carries error-feedback state "
                    f"(comm_error_feedback) but snapshot {dirname!r} "
                    f"recorded none — it was saved without quantized "
                    f"error feedback. Restore with the saving config, or "
                    f"disable comm_error_feedback to start residuals at "
                    f"zero", exc=InvalidArgumentError)
            remapped = _remap_error_feedback(ckpt, old_ef, new_ef, new_dp)
            for name, host in remapped.items():
                t = torch.from_numpy(host)
                placement = _placement_of(executor, prepared, name)
                if mesh is not None and placement is not None:
                    t = mesh.local_slice(t, placement).contiguous()
                scope.set_var(name, t if device is None else t.to(device))
        ckpt.close()

    if executor is not None and "run_counter" in meta:
        executor._run_counter = int(meta["run_counter"])
    if strict and "random_seed" in meta:
        enforce(int(program.random_seed) == int(meta["random_seed"]),
                f"program.random_seed={program.random_seed} but the "
                f"snapshot was trained with random_seed="
                f"{meta['random_seed']}: the resumed seed stream would "
                f"diverge from the uninterrupted run. Rebuild the "
                f"program with the saved seed (or strict=False to accept "
                f"the divergence)", exc=InvalidArgumentError)

    if verify:
        from ..framework.analysis import verify_program
        errors = [d for d in verify_program(prepared)
                  if d.severity == "error"]
        enforce(not errors,
                "restored program failed static verification:\n  "
                + "\n  ".join(str(d) for d in errors[:10]),
                exc=InvalidArgumentError)
        problems = verify_restored_placement(executor, prepared, scope)
        enforce(not problems,
                "restored state placement disagrees with the executor's "
                "policy:\n  " + "\n  ".join(problems[:10]),
                exc=InvalidArgumentError)

    _metric("ptpu_ckpt_restores_total").inc()
    _metric("ptpu_ckpt_restore_seconds").observe(time.perf_counter() - t0)
    return meta
