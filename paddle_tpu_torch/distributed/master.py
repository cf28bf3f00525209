"""Fault-tolerant data-dispatch master (the Go master, rebuilt).

≙ paddle_tpu/distributed/master.py, copied as logic (it uses no device).
≙ reference go/master/service.go — the etcd-backed job master that hands out
file-chunk *tasks* to workers with lease timeouts, retries failed/expired
tasks up to a max (processFailedTask service.go:313, max-retry discard :331),
snapshots its queues for crash recovery (:166-207), and starts a new pass
when all tasks finish. The reference pairs it with etcd for liveness and a Go
pserver; here the snapshot goes to a local/NFS path (the coordinator's
durable store), liveness is heartbeat-based, and the service speaks stdlib
XML-RPC so a localhost multi-process test needs no extra deps (the reference
tests fork local subprocesses the same way, test_dist_base.py:27).
"""

from __future__ import annotations

import os
import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

DEFAULT_TIMEOUT_S = 60.0
DEFAULT_MAX_RETRY = 3     # ≙ MaxTaskFailures semantics (service.go:331)


@dataclass
class Task:
    """A unit of dispatch: a set of data chunks (≙ master.Task over recordio
    chunks, go/master/service.go:89)."""
    task_id: int
    chunks: List[str]
    num_failures: int = 0
    deadline: float = 0.0      # only meaningful while pending
    epoch: int = 0


@dataclass
class _Queues:
    todo: List[Task] = field(default_factory=list)
    pending: Dict[int, Task] = field(default_factory=dict)
    done: List[Task] = field(default_factory=list)
    failed_forever: List[Task] = field(default_factory=list)
    epoch: int = 0


class Master:
    """Task-queue master with timeout/retry/snapshot (≙ go/master Service).

    Thread-safe; serve with `serve_forever` (XML-RPC) or call in-process.
    """

    def __init__(self, snapshot_path: Optional[str] = None,
                 timeout_s: float = DEFAULT_TIMEOUT_S,
                 max_retry: int = DEFAULT_MAX_RETRY,
                 chunks_per_task: int = 1,
                 num_passes: int = 1):
        self._lock = threading.RLock()
        self._q = _Queues()
        self._next_id = 0
        self.timeout_s = timeout_s
        self.max_retry = max_retry
        self.chunks_per_task = chunks_per_task
        # ≙ the v2 trainer's num_passes: epochs to dispatch before get_task
        # reports exhaustion (0 = endless recycling like the Go master)
        self.num_passes = num_passes
        self.snapshot_path = snapshot_path
        self._heartbeats: Dict[str, float] = {}
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()

    # -- dataset ----------------------------------------------------------

    def set_dataset(self, chunk_paths: Sequence[str]) -> int:
        """Partition chunks into tasks (≙ SetDataset/partition,
        service.go:140). Idempotent: only the first call seeds the queue
        (recovered state wins, matching the reference's recover-over-reseed
        behavior)."""
        with self._lock:
            if self._q.todo or self._q.pending or self._q.done:
                return 0
            chunks = list(chunk_paths)
            for i in range(0, len(chunks), self.chunks_per_task):
                self._q.todo.append(
                    Task(task_id=self._next_id,
                         chunks=chunks[i:i + self.chunks_per_task]))
                self._next_id += 1
            self._snapshot()
            return len(self._q.todo)

    # -- worker protocol --------------------------------------------------

    def get_task(self, worker_id: str = "") -> Optional[dict]:
        """Lease the next task (≙ GetTask, service.go:280). Returns None
        when nothing is available (caller backs off); implicitly rolls to
        the next pass when a pass completes."""
        with self._lock:
            self._check_timeouts()
            if worker_id:
                self._heartbeats[worker_id] = time.time()
            if not self._q.todo:
                more = (self.num_passes == 0 or
                        self._q.epoch + 1 < self.num_passes)
                if not self._q.pending and self._q.done and more:
                    self._new_pass()        # all done -> next epoch
                else:
                    return None
            if not self._q.todo:
                return None
            t = self._q.todo.pop(0)
            t.deadline = time.time() + self.timeout_s
            self._q.pending[t.task_id] = t
            from ..core.flags import vlog
            vlog(2, "master: leased task %d (%d chunks) to %s",
                 t.task_id, len(t.chunks), worker_id or "?")
            self._snapshot()
            return {"task_id": t.task_id, "chunks": list(t.chunks),
                    "epoch": self._q.epoch}

    def task_finished(self, task_id: int) -> bool:
        """≙ TaskFinished (service.go:313 area)."""
        with self._lock:
            t = self._q.pending.pop(int(task_id), None)
            if t is None:
                return False
            t.num_failures = 0
            self._q.done.append(t)
            self._snapshot()
            return True

    def task_failed(self, task_id: int) -> bool:
        """≙ TaskFailed -> processFailedTask (service.go:313): requeue, or
        discard after max_retry failures (:331)."""
        with self._lock:
            t = self._q.pending.pop(int(task_id), None)
            if t is None:
                return False
            self._fail(t)
            self._snapshot()
            return True

    def heartbeat(self, worker_id: str) -> float:
        """Record liveness; returns the master's clock (workers can detect
        skew). ≙ etcd keepalive in the reference."""
        with self._lock:
            now = time.time()
            self._heartbeats[worker_id] = now
            return now

    def live_workers(self, horizon_s: float = 30.0) -> List[str]:
        """Failure detection: workers with a heartbeat in the last
        `horizon_s` seconds."""
        with self._lock:
            now = time.time()
            return sorted(w for w, ts in self._heartbeats.items()
                          if now - ts <= horizon_s)

    def stats(self) -> dict:
        with self._lock:
            return {"todo": len(self._q.todo),
                    "pending": len(self._q.pending),
                    "done": len(self._q.done),
                    "discarded": len(self._q.failed_forever),
                    "epoch": self._q.epoch}

    # -- internals --------------------------------------------------------

    def _fail(self, t: Task):
        t.num_failures += 1
        if t.num_failures >= self.max_retry:
            self._q.failed_forever.append(t)   # discard (service.go:331)
        else:
            self._q.todo.append(t)

    def _check_timeouts(self):
        """≙ the checkTimeout goroutine: expired leases are failures."""
        now = time.time()
        expired = [tid for tid, t in self._q.pending.items()
                   if t.deadline < now]
        for tid in expired:
            self._fail(self._q.pending.pop(tid))

    def _new_pass(self):
        """All tasks done: recycle into the next pass (epoch)."""
        self._q.epoch += 1
        for t in self._q.done:
            t.num_failures = 0
            t.epoch = self._q.epoch
        self._q.todo = self._q.done
        self._q.done = []

    # -- snapshot/recover (≙ service.go:166-207, etcd -> file) -----------

    def _snapshot(self):
        if not self.snapshot_path:
            return
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"q": self._q, "next_id": self._next_id}, f)
        os.replace(tmp, self.snapshot_path)   # atomic like etcd txn

    def _recover(self):
        with open(self.snapshot_path, "rb") as f:
            state = pickle.load(f)
        self._q = state["q"]
        self._next_id = state["next_id"]
        # leases don't survive a master restart: pending -> todo, preserving
        # failure counts (≙ recover path re-queuing in the reference)
        for t in list(self._q.pending.values()):
            self._q.todo.append(t)
        self._q.pending.clear()

    # -- serving ----------------------------------------------------------

    def serve_forever(self, host: str = "127.0.0.1", port: int = 0):
        """Serve the worker protocol over XML-RPC. Returns (server, thread)
        with the bound port in server.server_address."""
        from xmlrpc.server import SimpleXMLRPCServer
        server = SimpleXMLRPCServer((host, port), allow_none=True,
                                    logRequests=False)
        for name in ("set_dataset", "get_task", "task_finished",
                     "task_failed", "heartbeat", "live_workers", "stats"):
            server.register_function(getattr(self, name), name)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        return server, thread


class MasterClient:
    """Worker-side client (≙ go/master client lib). `next_record`-style
    iteration: lease a task, read its chunks, report finish/failure."""

    def __init__(self, endpoint: str, worker_id: str = ""):
        from xmlrpc.client import ServerProxy
        self._proxy = ServerProxy(f"http://{endpoint}", allow_none=True)
        self.worker_id = worker_id or f"worker-{os.getpid()}"

    def set_dataset(self, chunks: Sequence[str]) -> int:
        return self._proxy.set_dataset(list(chunks))

    def get_task(self) -> Optional[dict]:
        return self._proxy.get_task(self.worker_id)

    def task_finished(self, task_id: int) -> bool:
        return self._proxy.task_finished(task_id)

    def task_failed(self, task_id: int) -> bool:
        return self._proxy.task_failed(task_id)

    def heartbeat(self) -> float:
        return self._proxy.heartbeat(self.worker_id)

    def live_workers(self, horizon_s: float = 30.0) -> List[str]:
        """Workers with a heartbeat inside the horizon — lets a chief-side
        FailureDetector watch peers through the master from any process."""
        return self._proxy.live_workers(horizon_s)

    def stats(self) -> dict:
        return self._proxy.stats()

    def tasks(self, poll_interval_s: float = 0.2, max_polls: int = 0):
        """Generator over leased tasks; yields (task_id, chunks). Stops
        after `max_polls` consecutive empty polls (0 = forever)."""
        empty = 0
        while True:
            t = self.get_task()
            if t is None:
                empty += 1
                if max_polls and empty >= max_polls:
                    return
                time.sleep(poll_interval_s)
                continue
            empty = 0
            yield t["task_id"], t["chunks"]
