"""High-level event-driven training loop with checkpoint/resume.

≙ paddle_tpu/trainer.py (reference python/paddle/fluid/trainer.py: Trainer
:169 with Begin/EndEpoch + Begin/EndStep events :40-99, CheckpointConfig
:100, serial-numbered checkpoint dirs with retention (_scroll_delete
:1168), trainer-args persistence, `_SUCCESS` markers :1190, and
resume-on-init, load_checkpoint :741). A checkpoint is
io.save_persistables of the training program: parameters, optimizer
moments and the learning-rate schedule's step counter, in the JAX
package's format.

`parallel=True` trains through a ParallelExecutor over the default dp
mesh (or `mesh=`); every rank of the world builds the Trainer and feeds
the same global batches. Not ported (ROADMAP.md §1 item 4, elasticity
and sharded checkpoints): `elastic` and `sharded` checkpoints and the
`Supervisor` that restarts a preempted run; the trainer also stamps no
memory series (observability/memory.py waits for the same item).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from time import perf_counter as _perf_counter
from typing import Callable, List, Optional, Sequence

import numpy as np

from . import io as _io
from . import optimizer as _optimizer_mod
from .core.enforce import InvalidArgumentError, enforce
from .data.feeder import DataFeeder
from .framework.executor import Executor
from .framework.program import Program, Variable, program_guard
from .framework.scope import Scope

_MULTI_GPU = ("{what} is not ported: ROADMAP.md §1 item 4 (elasticity "
              "and sharded checkpoints)")


class BeginEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id: int):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id: int, step_id: int):
        self.epoch = epoch_id
        self.step = step_id
        #: a handler sets this False to skip fetching the metrics this step
        #: (no device->host copy, and no wait for the step to finish)
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id: int, step_id: int, metrics: list):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """≙ trainer.CheckpointConfig (reference trainer.py:100): a checkpoint
    every `step_interval` steps and every `epoch_interval` epochs, the
    newest `max_num_checkpoints` kept."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3,
                 epoch_interval: int = 1,
                 step_interval: int = 10,
                 sharded: bool = False,
                 elastic: bool = False,
                 async_save: bool = False):
        if sharded:
            raise NotImplementedError(
                _MULTI_GPU.format(what="a sharded checkpoint"))
        if elastic or async_save:
            raise NotImplementedError(
                _MULTI_GPU.format(what="an elastic checkpoint"))
        self.checkpoint_dir = checkpoint_dir or \
            os.path.join(os.getcwd(), "checkpoint")
        enforce(epoch_interval >= 1 and step_interval >= 1,
                "checkpoint intervals must be >= 1",
                exc=InvalidArgumentError)
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval
        self.epoch_id = 0
        self.step_id = 0
        self.load_serial: Optional[int] = None


CHECKPOINT_PREFIX = "checkpoint"
TRAINER_ARGS_FILE = "trainer_args.json"
SUCCESS_MARKER = "_SUCCESS"

_train_metrics = None


def training_metrics():
    """The trainer-side operational series, registered (idempotently) into
    `observability.metrics.default_registry()`: steps, epochs and the wall
    time of each step."""
    global _train_metrics
    if _train_metrics is None:
        from .observability import metrics as m
        r = m.default_registry()
        _train_metrics = {
            "steps": m.get_or_create(
                r, "counter", "ptpu_train_steps_total",
                "Training steps executed by Trainer.train."),
            "epochs": m.get_or_create(
                r, "counter", "ptpu_train_epochs_total",
                "Training epochs completed by Trainer.train."),
            "step_seconds": m.get_or_create(
                r, "histogram", "ptpu_train_step_seconds",
                "Wall time of one training step (feed + dispatch + "
                "fetch).",
                buckets=(1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2, 0.1,
                         0.25, 0.5, 1.0, 2.5, 5.0, 10.0)),
        }
    return _train_metrics


# -- checkpoint telemetry (≙ paddle_tpu/parallel/elastic.py:208-263) -------
# The JAX package keeps these beside its elastic checkpoint writer; the
# port's checkpoint code is this module, and its async writer is not
# ported (CheckpointConfig(async_save=True) raises), so no async write is
# ever pending: the families register at zero and `pending_async_count`
# is 0. /healthz and a /metrics scrape read them through EngineServer.

_ckpt_registry = None
_ckpt_lock = threading.Lock()


def checkpoint_metrics():
    """The `ptpu_ckpt_*` series, registered (idempotently and lazily)
    into `observability.metrics.default_registry()` under the JAX
    package's names, types and help: one /metrics scrape sees
    checkpoint, training and serving series together. Returns the
    default registry."""
    global _ckpt_registry
    with _ckpt_lock:
        if _ckpt_registry is None:
            from .observability import metrics as m
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
              fn=lambda: float(pending_async_count()))
            _ckpt_registry = r
    return _ckpt_registry


def pending_async_count() -> int:
    """In-flight async snapshot writes not yet committed — what /healthz
    reports. Always 0: the port has no async checkpoint writer."""
    return 0


def _serial_dir(root: str, serial: int) -> str:
    return os.path.join(root, f"{CHECKPOINT_PREFIX}_{serial}")


def _list_serials(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if not name.startswith(CHECKPOINT_PREFIX + "_"):
            continue
        suffix = name[len(CHECKPOINT_PREFIX) + 1:]
        if suffix.isdigit() and os.path.exists(
                os.path.join(root, name, SUCCESS_MARKER)):
            out.append(int(suffix))
    return sorted(out)


def get_latest_checkpoint_serial(root: str) -> int:
    """Latest *complete* (marker present) checkpoint serial, or -1."""
    serials = _list_serials(root)
    return serials[-1] if serials else -1


def _world():
    """(rank, world size) of the initialised torch.distributed process
    group, or (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _global_barrier():
    """Block until every process of the torch.distributed process group
    reaches it; a no-op when none is initialised."""
    import torch.distributed as dist
    if _world()[1] > 1:
        dist.barrier()


def save_checkpoint(executor: Executor, checkpoint_dir: str,
                    main_program: Program,
                    trainer_args: Optional[dict] = None,
                    max_num_checkpoints: int = 3,
                    scope: Optional[Scope] = None,
                    sharded: bool = False,
                    serial: Optional[int] = None) -> int:
    """Write persistables + trainer args into the next serial dir; commit
    via the `_SUCCESS` marker only after all state hit disk (crash-safe:
    readers ignore marker-less dirs); then scroll-delete old serials
    (≙ trainer.save_checkpoint :641 + _scroll_delete :1168). Returns the
    serial.

    In a torch.distributed process group every process calls this at the
    same point; the state is replicated, so rank 0 alone writes, between
    two barriers (everyone sees the same directory state on entry, and
    nobody returns before the marker exists)."""
    if sharded:
        raise NotImplementedError(
            _MULTI_GPU.format(what="a sharded checkpoint"))
    rank, _ = _world()
    _global_barrier()
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir) + 1
    if rank == 0:
        cur = _serial_dir(checkpoint_dir, serial)
        if os.path.isdir(cur):
            shutil.rmtree(cur)  # incomplete leftovers from a preempted run
        os.makedirs(cur, exist_ok=True)
        _io.save_persistables(executor, cur, main_program=main_program,
                              scope=scope)
        if trainer_args is not None:
            with open(os.path.join(cur, TRAINER_ARGS_FILE), "w") as f:
                json.dump(trainer_args, f)
        with open(os.path.join(cur, SUCCESS_MARKER), "w") as f:
            f.write("")
        # retention: keep the most recent max_num_checkpoints, and never
        # the serial just written
        serials = [s for s in _list_serials(checkpoint_dir) if s != serial]
        for old in serials[:-(max_num_checkpoints - 1) or None]:
            shutil.rmtree(_serial_dir(checkpoint_dir, old),
                          ignore_errors=True)
    _global_barrier()
    return serial


def load_checkpoint(executor: Executor, checkpoint_dir: str,
                    main_program: Program,
                    serial: Optional[int] = None,
                    scope: Optional[Scope] = None,
                    sharded: bool = False) -> Optional[dict]:
    """Restore persistables from the given (default: latest complete)
    serial onto the executor's device; returns the saved trainer args, {}
    when none were saved, or None if there is no checkpoint."""
    if sharded:
        raise NotImplementedError(
            _MULTI_GPU.format(what="a sharded checkpoint"))
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir)
    if serial < 0:
        return None
    cur = _serial_dir(checkpoint_dir, serial)
    _io.load_persistables(executor, cur, main_program=main_program,
                          scope=scope)
    args_path = os.path.join(cur, TRAINER_ARGS_FILE)
    if os.path.exists(args_path):
        with open(args_path) as f:
            return json.load(f)
    return {}


class Trainer:
    """≙ fluid.Trainer (reference trainer.py:169).

    train_func: () -> loss Variable (or [loss, metric, ...]); builds the
    forward program when called under the trainer's program guard.
    optimizer_func: () -> Optimizer. place: default CUDAPlace(0), which
    raises without a card; pass CPUPlace() to train on the CPU.
    """

    def __init__(self, train_func: Callable,
                 optimizer_func: Callable[[], "_optimizer_mod.Optimizer"],
                 place=None,
                 parallel: bool = False,
                 checkpoint_config: Optional[CheckpointConfig] = None,
                 mesh=None):
        self.checkpoint_cfg = checkpoint_config
        self.place = place
        self.scope = Scope()
        self.startup_program = Program()
        self.train_program = Program()
        self.stop_flag = False

        with program_guard(self.train_program, self.startup_program):
            outs = train_func()
            if isinstance(outs, (list, tuple)):
                self.loss = outs[0]
                self.metrics = list(outs)
            else:
                self.loss = outs
                self.metrics = [outs]
            # forward-only clone BEFORE optimizer ops are appended, so
            # test() cannot touch parameters (≙ main.clone(for_test=True))
            self.test_program = self.train_program.clone(for_test=True)
            opt = optimizer_func()
            enforce(isinstance(opt, _optimizer_mod.Optimizer),
                    "optimizer_func must return an Optimizer",
                    exc=InvalidArgumentError)
            opt.minimize(self.loss)

        self.exe = Executor(place)
        self.exe.run(self.startup_program, scope=self.scope)
        self._pe = None
        if parallel or mesh is not None:
            # the JAX package calls DeviceMesh.default_data_parallel(),
            # which its mesh module never defines (AttributeError); the
            # port takes the default dp mesh that call means (ROADMAP.md
            # §3, deliberate differences)
            from .parallel import ParallelExecutor, get_default_mesh
            self._pe = ParallelExecutor(
                use_cuda=self.exe.device.type == "cuda",
                loss_name=self.loss.name, mesh=mesh or get_default_mesh(),
                main_program=self.train_program, scope=self.scope)
        if self.checkpoint_cfg:
            args = load_checkpoint(self.exe,
                                   self.checkpoint_cfg.checkpoint_dir,
                                   self.train_program, scope=self.scope)
            if args:
                self.checkpoint_cfg.epoch_id = int(args.get("epoch_id", 0))
                self.checkpoint_cfg.step_id = int(args.get("step_id", 0))
                self.checkpoint_cfg.load_serial = \
                    get_latest_checkpoint_serial(
                        self.checkpoint_cfg.checkpoint_dir)

    def stop(self):
        """Ask train() to exit after the current step (callable from the
        event handler — ≙ trainer.stop)."""
        self.stop_flag = True

    def train(self, num_epochs: int, event_handler: Callable,
              reader: Callable, feed_order: Sequence[str]):
        """Run `num_epochs` passes over `reader` (a zero-arg callable
        yielding minibatches, lists of samples aligned with `feed_order`).
        Saved trainer args are the NEXT work item (resume_epoch,
        resume_step): a resumed run skips everything already trained —
        including the whole run when it had completed."""
        feeder = DataFeeder(feed_list=[
            self.train_program.global_block().var(n) for n in feed_order])
        start_epoch = (self.checkpoint_cfg.epoch_id
                       if self.checkpoint_cfg else 0)
        skip_steps = (self.checkpoint_cfg.step_id
                      if self.checkpoint_cfg else 0)
        tm = training_metrics()
        for epoch_id in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch_id))
            for step_id, batch in enumerate(reader()):
                if epoch_id == start_epoch and step_id < skip_steps:
                    continue  # already trained before preemption
                if self.stop_flag:
                    if self.checkpoint_cfg:
                        self._save_checkpoint(epoch_id, step_id)
                    return
                begin = BeginStepEvent(epoch_id, step_id)
                event_handler(begin)
                fetch = [m.name for m in self.metrics] \
                    if begin.fetch_metrics else []
                feed = feeder.feed(batch)
                t_step = _perf_counter()
                if self._pe is not None:
                    metrics = self._pe.run(feed=feed, fetch_list=fetch)
                else:
                    metrics = self.exe.run(self.train_program, feed=feed,
                                           fetch_list=fetch,
                                           scope=self.scope)
                tm["steps"].inc()
                tm["step_seconds"].observe(_perf_counter() - t_step)
                event_handler(EndStepEvent(epoch_id, step_id, metrics))
                if (self.checkpoint_cfg and
                        (step_id + 1) % self.checkpoint_cfg.step_interval
                        == 0):
                    self._save_checkpoint(epoch_id, step_id + 1)
            event_handler(EndEpochEvent(epoch_id))
            tm["epochs"].inc()
            if (self.checkpoint_cfg and
                    (epoch_id + 1) % self.checkpoint_cfg.epoch_interval == 0):
                self._save_checkpoint(epoch_id + 1, 0)
        if self.checkpoint_cfg:
            self._save_checkpoint(num_epochs, 0)

    def test(self, reader: Callable, feed_order: Sequence[str]):
        """Average the metric values over the reader, on the forward-only
        test program (no backward or optimizer ops, dropout at inference
        scaling): parameters are not touched."""
        feeder = DataFeeder(feed_list=[
            self.test_program.global_block().var(n) for n in feed_order])
        totals = None
        count = 0
        for batch in reader():
            feed = feeder.feed(batch)
            vals = self.exe.run(self.test_program, feed=feed,
                                fetch_list=[m.name for m in self.metrics],
                                scope=self.scope)
            vals = [np.mean(np.asarray(v)) for v in vals]
            totals = vals if totals is None else \
                [t + v for t, v in zip(totals, vals)]
            count += 1
        enforce(count > 0, "test reader yielded no batches",
                exc=InvalidArgumentError)
        return [t / count for t in totals]

    def save_params(self, param_path: str):
        _io.save_params(self.exe, param_path,
                        main_program=self.train_program, scope=self.scope)

    def save_inference_model(self, param_path: str,
                             feeded_var_names: Sequence[str],
                             target_vars: Sequence[Variable]):
        _io.save_inference_model(param_path, feeded_var_names, target_vars,
                                 executor=self.exe,
                                 main_program=self.train_program,
                                 scope=self.scope)

    def _save_checkpoint(self, resume_epoch: int, resume_step: int):
        save_checkpoint(
            self.exe, self.checkpoint_cfg.checkpoint_dir, self.train_program,
            trainer_args={"epoch_id": resume_epoch, "step_id": resume_step},
            max_num_checkpoints=self.checkpoint_cfg.max_num_checkpoints,
            scope=self.scope)
