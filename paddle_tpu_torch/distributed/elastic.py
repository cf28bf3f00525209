"""Preemption-tolerant training: checkpoint-restart elasticity.

≙ paddle_tpu/distributed/elastic.py, copied as logic. The reference
combines (a) Trainer checkpoints (trainer.py:641-1202), (b) pserver
barrier counts that tolerate trainer exit (SendComplete,
executor.cc:48-54), and (c) the Go master's task retry. A
torch.distributed world is static too — an NCCL communicator cannot lose
a participant — so elasticity is checkpoint-restart: detect preemption or
peer failure, persist a consistent step, and restart the job with the
survivors.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Optional

from ..framework.program import default_main_program
from ..trainer import load_checkpoint, save_checkpoint


class PreemptionGuard:
    """Install SIGTERM/SIGINT handlers that request a clean checkpoint stop
    (the TPU-pod preemption notice pattern). Training loops poll
    `should_stop` once per step; on preemption the current step finishes,
    a checkpoint is written, and the process exits 0 so the scheduler
    restarts it."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:
                pass  # not main thread — polling still works via request()

    def _handler(self, signum, frame):
        self._stop.set()

    def request(self):
        """Programmatic preemption request (tests, health watchers)."""
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()


class ElasticTrainer:
    """Checkpoint-restart training loop (≙ Trainer + CheckpointConfig +
    master retry composed; reference trainer.py:442-519 train loop shape).

    train_step(step) -> loss is user code; this loop owns resume,
    periodic checkpointing, preemption, and peer-failure restart.
    """

    def __init__(self, executor, checkpoint_dir: str,
                 save_interval_steps: int = 100,
                 max_checkpoints: int = 3,
                 guard: Optional[PreemptionGuard] = None,
                 main_program=None):
        self.exe = executor
        self.dir = checkpoint_dir
        self.program = main_program or default_main_program()
        self.interval = save_interval_steps
        self.max_checkpoints = max_checkpoints
        self.guard = guard or PreemptionGuard(signals=())
        os.makedirs(checkpoint_dir, exist_ok=True)

    def resume_step(self) -> int:
        """Latest durable step, -1 if fresh (≙ load_checkpoint on init,
        trainer.py:741)."""
        extra = load_checkpoint(self.exe, self.dir, self.program)
        if extra is None:
            return -1
        return int(extra.get("step", -1))

    def run(self, train_step: Callable[[int], float], num_steps: int,
            start_step: Optional[int] = None) -> dict:
        """Run to `num_steps`, checkpointing every `interval` steps and on
        preemption. Returns {last_step, losses, preempted}."""
        step = (self.resume_step() if start_step is None else start_step - 1)
        losses = []
        preempted = False
        last_saved = step
        while step + 1 < num_steps:
            step += 1
            losses.append(float(train_step(step)))
            # read the flag ONCE: a signal landing between two reads must
            # not skip the checkpoint the docstring promises
            stopping = self.guard.should_stop
            if stopping or (step + 1) % self.interval == 0:
                save_checkpoint(self.exe, self.dir, self.program,
                                trainer_args={"step": step},
                                max_num_checkpoints=self.max_checkpoints)
                last_saved = step
            if stopping:
                preempted = True
                break
        if not preempted and last_saved != step:
            save_checkpoint(self.exe, self.dir, self.program,
                            trainer_args={"step": step},
                            max_num_checkpoints=self.max_checkpoints)
        return {"last_step": step, "losses": losses, "preempted": preempted}


class FailureDetector:
    """Chief-side peer liveness watcher over master heartbeats
    (≙ etcd liveness + barrier counts). Calls `on_failure(dead_workers)`
    once when any expected worker misses the horizon."""

    def __init__(self, master, expected_workers, horizon_s: float = 30.0,
                 poll_s: float = 1.0, grace_s: Optional[float] = None):
        self.master = master
        self.expected = set(expected_workers)
        self.horizon_s = horizon_s
        self.poll_s = poll_s
        # startup grace: workers still booting have sent no heartbeat yet —
        # without this the detector fires spuriously on every cold start
        self.grace_s = horizon_s if grace_s is None else grace_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self, on_failure: Callable[[set], None]):
        started = time.time()

        def watch():
            seen: set = set()
            while not self._stop.is_set():
                live = set(self.master.live_workers(self.horizon_s))
                seen.update(live)
                in_grace = time.time() - started < self.grace_s
                # during grace, only workers that already joined can "die"
                watched = self.expected if not in_grace \
                    else self.expected & seen
                dead = watched - live
                if dead:
                    on_failure(dead)
                    return
                time.sleep(self.poll_s)
        self._thread = threading.Thread(target=watch, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
