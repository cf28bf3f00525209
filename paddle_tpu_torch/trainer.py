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
the same global batches. `CheckpointConfig(elastic=True)` snapshots the
complete training state through parallel/elastic.py (atomic two-phase
commit; `async_save` writes from pinned host memory off the step path)
and resumes from the latest committed snapshot at construction;
`sharded=True` writes per-rank shard files (sharded_checkpoint.py). The
`Supervisor` restarts a preempted or crashed training process (or a gang
of rank processes) with backoff.
"""

from __future__ import annotations

import json
import os
import shutil
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
    newest `max_num_checkpoints` kept.

    elastic=True routes through the atomic elastic runtime
    (parallel/elastic.py): two-phase-committed snapshots of the complete
    training state (parameters, split optimizer accumulators,
    error-feedback residuals, the seed stream's position, the parallel
    config), resumed exactly and across mesh changes. async_save moves
    the file writes off the step path (the step pays the copy's enqueue).
    sharded=True writes per-rank shard files (sharded_checkpoint.py)."""

    def __init__(self, checkpoint_dir: Optional[str] = None,
                 max_num_checkpoints: int = 3,
                 epoch_interval: int = 1,
                 step_interval: int = 10,
                 sharded: bool = False,
                 elastic: bool = False,
                 async_save: bool = False):
        self.checkpoint_dir = checkpoint_dir or \
            os.path.join(os.getcwd(), "checkpoint")
        enforce(epoch_interval >= 1 and step_interval >= 1,
                "checkpoint intervals must be >= 1",
                exc=InvalidArgumentError)
        enforce(not (async_save and not elastic),
                "async_save requires elastic=True (only the elastic "
                "runtime has the background commit protocol)",
                exc=InvalidArgumentError)
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = epoch_interval
        self.step_interval = step_interval
        self.sharded = sharded
        self.elastic = elastic
        self.async_save = async_save
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


def _writer_group(scope: Optional[Scope]):
    """(this rank writes?, process group of the save, in a world?, every
    rank saves?) for a checkpoint of `scope`: where a ParallelExecutor
    split the scope, its mesh (every rank of the mesh takes part in the
    save's gather, the first one writes); else the whole torch.distributed
    world (rank 0 alone saves), or this process alone."""
    import torch.distributed as dist
    from .framework.scope import global_scope
    from .parallel.parallel_executor import split_state
    reg = split_state(scope or global_scope())
    if reg:
        mesh = next(iter(reg.values()))[0]
        if mesh.joined:
            return mesh.rank == mesh.ranks[0], mesh.mesh_group, True, True
        return True, None, False, True
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank() == 0, None, True, False
    return True, None, False, False


def _global_barrier(group, joined: bool):
    """Block until every process of `group` (the world when None) reaches
    it; a no-op outside a world."""
    import torch.distributed as dist
    if joined:
        dist.barrier(group=group)


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

    In a torch.distributed world every process calls this at the same
    point. A var a ParallelExecutor split (ZeRO-1 accumulators, tp
    blocks) is written whole: every rank of its mesh gathers it and the
    mesh's first rank writes (sharded=True: every rank writes its own
    blocks, sharded_checkpoint.py). The phases are separated by barriers
    over the mesh (or the world): everyone sees the same directory state
    on entry, nobody writes into leftovers, and nobody returns before the
    marker exists."""
    writer, group, joined, gather = _writer_group(scope)
    _global_barrier(group, joined)
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir) + 1
    cur = _serial_dir(checkpoint_dir, serial)
    if writer:
        if os.path.isdir(cur):
            shutil.rmtree(cur)  # incomplete leftovers of a preempted run
        os.makedirs(cur, exist_ok=True)
    _global_barrier(group, joined)
    if writer or gather:
        _io.save_persistables(executor, cur, main_program=main_program,
                              scope=scope, sharded=sharded)
    _global_barrier(group, joined)
    if writer:
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
    _global_barrier(group, joined)
    return serial


def load_checkpoint(executor: Executor, checkpoint_dir: str,
                    main_program: Program,
                    serial: Optional[int] = None,
                    scope: Optional[Scope] = None,
                    sharded: bool = False,
                    shardings=None) -> Optional[dict]:
    """Restore persistables from the given (default: latest complete)
    serial onto the executor's device; returns the saved trainer args, {}
    when none were saved, or None if there is no checkpoint. Loaded into
    a ParallelExecutor's scope, a split var's whole value is cut back to
    this rank's block at the executor's next run (sharded=True reads only
    this rank's block). `shardings`: see io.load_persistables."""
    if serial is None:
        serial = get_latest_checkpoint_serial(checkpoint_dir)
    if serial < 0:
        return None
    cur = _serial_dir(checkpoint_dir, serial)
    _io.load_persistables(executor, cur, main_program=main_program,
                          scope=scope, sharded=sharded, shardings=shardings)
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
        if self.checkpoint_cfg and self.checkpoint_cfg.elastic:
            from .parallel import elastic as _elastic
            snap = _elastic.latest_snapshot(
                self.checkpoint_cfg.checkpoint_dir)
            if snap is not None:
                meta = _elastic.restore_train_state(
                    snap, program=self.train_program, scope=self.scope,
                    executor=self._train_executor())
                extra = meta.get("extra", {})
                self.checkpoint_cfg.epoch_id = int(extra.get("epoch_id", 0))
                self.checkpoint_cfg.step_id = int(extra.get("step_id", 0))
        elif self.checkpoint_cfg:
            args = load_checkpoint(self.exe,
                                   self.checkpoint_cfg.checkpoint_dir,
                                   self.train_program, scope=self.scope,
                                   sharded=self.checkpoint_cfg.sharded)
            if args:
                self.checkpoint_cfg.epoch_id = int(args.get("epoch_id", 0))
                self.checkpoint_cfg.step_id = int(args.get("step_id", 0))
                self.checkpoint_cfg.load_serial = \
                    get_latest_checkpoint_serial(
                        self.checkpoint_cfg.checkpoint_dir)

    def _train_executor(self):
        """The executor whose run counter drives the training seed stream
        — what an elastic snapshot records and restores."""
        return self._pe if self._pe is not None else self.exe

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
        from .observability import memory as _memory
        from .parallel import elastic as _elastic
        # the ptpu_memory_* / ptpu_mfu families exist from the start: a
        # scrape or crash dossier before the first step sees them (the
        # executor stamps their values per run)
        _memory.memory_metrics()
        feeder = DataFeeder(feed_list=[
            self.train_program.global_block().var(n) for n in feed_order])
        start_epoch = (self.checkpoint_cfg.epoch_id
                       if self.checkpoint_cfg else 0)
        skip_steps = (self.checkpoint_cfg.step_id
                      if self.checkpoint_cfg else 0)
        elastic = bool(self.checkpoint_cfg and self.checkpoint_cfg.elastic)
        tm = training_metrics()
        for epoch_id in range(start_epoch, num_epochs):
            event_handler(BeginEpochEvent(epoch_id))
            for step_id, batch in enumerate(reader()):
                if epoch_id == start_epoch and step_id < skip_steps:
                    continue  # already trained before preemption
                if self.stop_flag:
                    if self.checkpoint_cfg:
                        self._save_checkpoint(epoch_id, step_id)
                    if elastic:
                        # an async stop-snapshot commits before train()
                        # returns: a prompt exit must not kill the writer
                        _elastic.wait_for_pending()
                    return
                if elastic:
                    # the PTPU_FAULT_INJECT=crash_at_step preemption
                    # point, BEFORE the step: the snapshot interval
                    # decides how much work a preemption replays
                    _elastic.maybe_crash_at_step(
                        self._train_executor()._run_counter)
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
        if elastic:
            # no writer thread may still hold staged state at exit
            _elastic.wait_for_pending()

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
        if self.checkpoint_cfg.elastic:
            from .parallel import elastic as _elastic
            exe = self._train_executor()
            _elastic.save_train_state(
                self.checkpoint_cfg.checkpoint_dir,
                program=self.train_program, scope=self.scope, executor=exe,
                step=exe._run_counter,
                extra_meta={"epoch_id": resume_epoch,
                            "step_id": resume_step},
                max_snapshots=self.checkpoint_cfg.max_num_checkpoints,
                block=not self.checkpoint_cfg.async_save)
            return
        save_checkpoint(
            self.exe, self.checkpoint_cfg.checkpoint_dir, self.train_program,
            trainer_args={"epoch_id": resume_epoch, "step_id": resume_step},
            max_num_checkpoints=self.checkpoint_cfg.max_num_checkpoints,
            scope=self.scope, sharded=self.checkpoint_cfg.sharded)


class SupervisorExhaustedError(RuntimeError):
    """The Supervisor's restart budget ran out without a clean exit —
    the terminal crash-loop signal (raise_on_exhaust=True)."""

    def __init__(self, message: str, exit_code: int,
                 exit_codes: Sequence[int]):
        super().__init__(message)
        self.exit_code = exit_code
        self.exit_codes = list(exit_codes)


class Supervisor:
    """Retry/backoff supervisor for preemptible training processes.

    The process-level half of elastic recovery (≙ the reference's
    pserver/trainer restart story, checkpoint-mediated here): run the
    training command as a child, and when it dies of a crash/preemption
    (SIGKILL, OOM, nonzero exit), relaunch it after an exponential
    backoff — the restarted run resumes from the latest COMMITTED
    elastic snapshot (CheckpointConfig(elastic=True) or
    parallel.elastic.restore_train_state in the child). A clean exit 0
    ends supervision.

        Supervisor([sys.executable, "train.py"], max_restarts=20).run()

    Hardening knobs:

    - the restart budget is a HARD cap: when it runs out, run() logs a
      clear terminal crash-loop error and returns the last exit code —
      or raises SupervisorExhaustedError with raise_on_exhaust=True — so
      a persistently broken child fails loudly instead of looping under
      ever-longer backoffs;
    - `backoff_jitter` decorrelates a gang of supervisors restarting
      after a shared failure (thundering herd): each delay is scaled by
      a uniform factor in [1-j, 1+j];
    - `healthy_run_s` resets the backoff to its base after a child that
      ran at least that long: a crash every few hours is a preemption
      pattern and deserves fast restarts, not the accumulated backoff of
      a morning's crash loop.

    world_size > 1 supervises a GANG of rank processes: the same argv is
    launched once per rank with PTPU_WORLD_RANK / PTPU_WORLD_SIZE and the
    PADDLE_* role protocol that `distributed.parse_env` reads
    (PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_LOCAL_RANK, and a
    PADDLE_COORDINATOR_ENDPOINT on a free localhost port per incarnation
    unless the env names one), so the children join a real
    torch.distributed world with `distributed.init_parallel_env()`. Any
    rank dying kills the rest of the gang (SIGTERM, then SIGKILL after
    10 s) and the whole world restarts together — the restart
    granularity the chief-commits barrier assumes.

    `dossier_dir` arms the flight recorder across restarts
    (observability/flight_recorder.py): children inherit
    PTPU_DOSSIER_DIR (their barrier phase beacons and crash dossiers
    land there) plus PTPU_SUPERVISOR_RESTARTS (surfaced on /healthz),
    and after every incarnation that DIES the supervisor folds the
    beacons + dossiers into `post_mortem-<k>.json` — which rank died,
    in which barrier phase, with the per-rank straggler timeline —
    before restarting the gang. Paths collect in `self.post_mortems`.

    Fault injection (PTPU_FAULT_INJECT, parallel/elastic.py +
    parallel/process_world.py) makes the crash side testable: children
    that SIGKILL themselves mid-run, mid-save and mid-barrier.
    """

    def __init__(self, argv: Sequence[str],
                 max_restarts: int = 10,
                 backoff_s: float = 1.0,
                 backoff_factor: float = 2.0,
                 max_backoff_s: float = 60.0,
                 backoff_jitter: float = 0.0,
                 healthy_run_s: Optional[float] = None,
                 world_size: int = 1,
                 raise_on_exhaust: bool = False,
                 env: Optional[dict] = None,
                 dossier_dir: Optional[str] = None,
                 sleep_fn: Optional[Callable[[float], None]] = None,
                 rng=None):
        enforce(len(argv) >= 1, "Supervisor needs a command",
                exc=InvalidArgumentError)
        enforce(max_restarts >= 0 and backoff_s >= 0
                and backoff_factor >= 1.0,
                "Supervisor: max_restarts >= 0, backoff_s >= 0, "
                "backoff_factor >= 1 required", exc=InvalidArgumentError)
        enforce(0.0 <= backoff_jitter < 1.0,
                "Supervisor: backoff_jitter must be in [0, 1)",
                exc=InvalidArgumentError)
        enforce(world_size >= 1, "Supervisor: world_size must be >= 1",
                exc=InvalidArgumentError)
        enforce(healthy_run_s is None or healthy_run_s > 0,
                "Supervisor: healthy_run_s must be positive",
                exc=InvalidArgumentError)
        self.argv = list(argv)
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.backoff_factor = backoff_factor
        self.max_backoff_s = max_backoff_s
        self.backoff_jitter = backoff_jitter
        self.healthy_run_s = healthy_run_s
        self.world_size = world_size
        self.raise_on_exhaust = raise_on_exhaust
        self.env = env
        self.dossier_dir = dossier_dir
        if dossier_dir:
            os.makedirs(dossier_dir, exist_ok=True)
        self._sleep = sleep_fn or __import__("time").sleep
        self._rng = rng or __import__("random").Random()
        #: restarts performed by the last run()
        self.restarts = 0
        #: True when the last run() ended by exhausting the budget
        self.exhausted = False
        #: exit codes observed, in order (negative = killed by signal);
        #: for a gang, the FIRST nonzero code of each incarnation
        self.exit_codes: List[int] = []
        #: post_mortem-<k>.json paths written by the last run()
        self.post_mortems: List[str] = []

    def _child_env(self, rank: Optional[int] = None) -> dict:
        env = dict(self.env if self.env is not None else os.environ)
        if self.dossier_dir:
            env["PTPU_DOSSIER_DIR"] = self.dossier_dir
        env["PTPU_SUPERVISOR_RESTARTS"] = str(self.restarts)
        if rank is not None:
            env["PTPU_WORLD_RANK"] = str(rank)
            env["PTPU_WORLD_SIZE"] = str(self.world_size)
            env["PADDLE_TRAINER_ID"] = str(rank)
            env["PADDLE_TRAINERS_NUM"] = str(self.world_size)
            env["PADDLE_LOCAL_RANK"] = str(rank)
            if "PADDLE_COORDINATOR_ENDPOINT" not in env:
                env["PADDLE_COORDINATOR_ENDPOINT"] = self._endpoint
        return env

    def _write_post_mortem(self):
        """After an incarnation died: fold the dossier dir's beacons +
        dossiers into post_mortem-<incarnation>.json, then ARCHIVE them
        into an incarnation-<k>/ subdir — the next incarnation's
        beacons start from a clean top level, so a stale crash marker
        from a previous death can never win the next post-mortem's
        verdict (and the fold stays bounded on long-running jobs). The
        children are already dead here, so no writer holds the moved
        files open. Best-effort — a post-mortem failure must never
        break supervision itself."""
        if not self.dossier_dir:
            return
        from .core import flags
        from .observability import flight_recorder as _fr
        try:
            k = len(self.exit_codes)
            path = _fr.write_post_mortem(
                self.dossier_dir, incarnation=k,
                extra={"exit_code": self.exit_codes[-1],
                       "restarts": self.restarts,
                       "argv": self.argv})
            self.post_mortems.append(path)
            archive = os.path.join(self.dossier_dir, f"incarnation-{k}")
            os.makedirs(archive, exist_ok=True)
            for name in os.listdir(self.dossier_dir):
                if name.startswith((_fr.BEACON_PREFIX,
                                    _fr.DOSSIER_PREFIX)):
                    os.replace(os.path.join(self.dossier_dir, name),
                               os.path.join(archive, name))
            flags.vlog(0, "Supervisor: post-mortem %s", path)
        except Exception as e:  # noqa: BLE001 - best effort
            flags.vlog(0, "Supervisor: post-mortem failed: %s: %s",
                       type(e).__name__, e)

    def _launch_gang(self):
        """One incarnation: world_size children with rank identities in
        env. Returns the incarnation's exit code: 0 iff every rank
        exited 0; otherwise the first failing rank's code, after the
        rest of the gang was terminated (the barrier protocol assumes
        whole-world restarts)."""
        import subprocess
        if self.world_size == 1:
            return subprocess.run(self.argv,
                                  env=self._child_env()).returncode
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self._endpoint = f"127.0.0.1:{s.getsockname()[1]}"
        procs = []
        for r in range(self.world_size):
            procs.append(subprocess.Popen(self.argv,
                                          env=self._child_env(r)))
        import time as _time
        rc = 0
        kill_deadline = None
        live = set(range(self.world_size))
        while live:
            for r in sorted(live):
                code = procs[r].poll()
                if code is None:
                    continue
                live.discard(r)
                if code != 0 and rc == 0:
                    rc = code
                    # gang semantics: one death restarts the world
                    for r2 in sorted(live):
                        procs[r2].terminate()
                    kill_deadline = _time.monotonic() + 10.0
            if live and kill_deadline is not None \
                    and _time.monotonic() >= kill_deadline:
                # a rank ignoring SIGTERM (wedged in native code) must
                # not hang the supervisor — escalate to SIGKILL; the
                # barrier protocol is kill-safe by construction
                for r2 in sorted(live):
                    procs[r2].kill()
                kill_deadline = float("inf")
            if live:
                _time.sleep(0.05)
        if rc != 0:
            for p in procs:
                p.wait()
        return rc

    def run(self) -> int:
        """Supervise until the world exits 0 or the restart budget is
        spent. Returns the final exit code (0 on success; the child's
        last code — negative for a signal death — when the budget ran
        out; raises SupervisorExhaustedError instead when
        raise_on_exhaust=True)."""
        import time as _time

        from .core import flags
        self.restarts = 0
        self.exhausted = False
        self.exit_codes = []
        self.post_mortems = []
        delay = self.backoff_s
        while True:
            t0 = _time.monotonic()
            rc = self._launch_gang()
            ran_s = _time.monotonic() - t0
            self.exit_codes.append(rc)
            if rc == 0:
                return 0
            # the incarnation died: synthesize its post-mortem from the
            # flight-recorder beacons/dossiers BEFORE restarting (a
            # restarted gang appends new beacon lines)
            self._write_post_mortem()
            if self.restarts >= self.max_restarts:
                self.exhausted = True
                msg = (f"Supervisor: restart budget ({self.max_restarts})"
                       f" exhausted — the child is crash-looping, not "
                       f"being preempted (exit codes {self.exit_codes});"
                       f" last exit code {rc}. Fix the persistent "
                       f"failure; restarting further would only mask it")
                flags.vlog(0, "%s", msg)
                if self.raise_on_exhaust:
                    raise SupervisorExhaustedError(msg, rc,
                                                   self.exit_codes)
                return rc
            if (self.healthy_run_s is not None
                    and ran_s >= self.healthy_run_s):
                # a long healthy run before this death: preemption
                # pattern, not a crash loop — restart fast again
                delay = self.backoff_s
            flags.vlog(0, "Supervisor: child exited %d (%s) after %.1fs; "
                       "restart %d/%d after %.1fs backoff", rc,
                       "signal" if rc < 0 else "error", ran_s,
                       self.restarts + 1, self.max_restarts, delay)
            jitter = 1.0
            if self.backoff_jitter:
                jitter += self._rng.uniform(-self.backoff_jitter,
                                            self.backoff_jitter)
            if delay > 0:
                self._sleep(delay * jitter)
            delay = min(delay * self.backoff_factor, self.max_backoff_s)
            self.restarts += 1
