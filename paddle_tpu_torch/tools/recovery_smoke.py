"""Kill-the-process-mid-run recovery drill.

≙ tools/recovery_smoke.py, on the port's ranks. Orchestrates REAL process
deaths through the elastic fault-injection hook (PTPU_FAULT_INJECT,
parallel/elastic.py) and asserts recovery. A training child is a GANG of
dp rank processes started by `distributed.launch` (NCCL over the visible
cards, gloo under `--place cpu`), one world whose snapshots commit through
the chief-commits barrier over the world's store (`StoreWorld`); one
SIGKILLed rank brings the whole gang down with a nonzero exit, and
`trainer.Supervisor` relaunches the gang. The uninterrupted reference
run goes beside the phases' runs, which do not depend on it:

  phase A  supervised preemption: the gang SIGKILLs itself mid-run on its
           first attempt; the Supervisor relaunches it; the resumed run
           restores the latest committed snapshot and its per-step
           fixed-seed losses match the uninterrupted reference run
           bitwise (the snapshot carries the run counter).
  phase B  dp-world resize: crash a dp run, restart it with 2 x dp ranks;
           the resumed losses match the reference within ATOL_RESIZE.
  phase C  crash DURING a snapshot write (SIGKILL at byte 0 of the staged
           payload): the surviving directory is uncommitted, restore
           falls back to the previous committed snapshot, and the
           relaunched run still reproduces the reference exactly.

`--world N` runs the MULTI-RANK phases over a gang of N ranks:

  phase D  SIGKILL a NON-CHIEF rank mid-barrier (crash_rank:2@ack): the
           whole gang dies with nothing committed, the restart re-trains
           and commits through the full barrier, losses match the
           uninterrupted dp N reference bitwise.
  phase E  SIGKILL the CHIEF mid-COMMIT (crash_rank:0@commit: after the
           directory rename, before the COMMIT marker): the restart finds
           only an UNCOMMITTED snapshot dir, starts from the last
           committed one, and still reproduces the reference exactly;
           the uncommitted leftover stays on disk (lint_program
           --restore_dir exits 1 on it).

With fewer cards than ranks on `--place cuda` the drill raises, naming
both numbers; it never shrinks the world.

Child modes:
  --child          one training run of a gang of --dp ranks:
                   restore-if-possible, train to --steps, snapshot every
                   --snap_every, rank 0 appends per-step losses to --out
                   as JSON lines; --fault_once arms PTPU_FAULT_INJECT for
                   exactly ONE attempt (a sentinel file marks it)
  --atomic-child   no-mesh snapshot writer for the crash-mid-save
                   atomicity property: commit generation 0, then save
                   generation 1 (which PTPU_FAULT_INJECT may kill at any
                   byte offset)
  --world-atomic-child
                   multi-rank writer for the crash-anywhere property: a
                   simulated world of --world ranks in this process
                   (`ProcessWorld`) over a dp mesh of unjoined ranks,
                   dp-sharded + replicated state; commit generation 0
                   through the barrier, then save generation 1 under the
                   fault (crash_rank:<r>@<phase>[@<offset>])

    python -m paddle_tpu_torch.tools.recovery_smoke [--place cpu]
    python -m paddle_tpu_torch.tools.recovery_smoke --world 4 --place cpu
    python -m paddle_tpu_torch.tools.recovery_smoke --dp 1 --phases AC
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile

from . import add_place_arg

ATOL_RESIZE = 1e-5
STEPS = 8
SNAP_EVERY = 2
CRASH_STEP = 5
#: a gang's collective timeout (s); `launch` stops the gang after twice
#: this, well before a Supervisor gives up on it
GANG_TIMEOUT_S = 120.0

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODULE = "paddle_tpu_torch.tools.recovery_smoke"


# ---------------------------------------------------------------------------
# child: one (resumable) training run of a gang of ranks
# ---------------------------------------------------------------------------

def _build_model():
    """EXACTLY lint_program's `--model mnist --optimizer momentum`
    program, so the lint can check the restored program against the
    snapshots this child commits."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch import models
    loss = models.mnist.mlp()[0]
    ptt.optimizer.MomentumOptimizer(0.1, momentum=0.9).minimize(loss)
    return loss


def _feed_for_step(i):
    import numpy as np
    rng = np.random.RandomState(1000 + i)
    return {"img": rng.rand(8, 784).astype("float32"),
            "label": rng.randint(0, 10, (8, 1)).astype("int64")}


def train_rank(rank: int, nproc: int, cfg: dict):
    """One rank of the gang (`distributed.launch` calls it after joining
    the world): a dp mesh over every rank, ReduceScatter, the global
    batch fed on every rank."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.parallel import DeviceMesh, ParallelExecutor
    from paddle_tpu_torch.parallel import elastic
    from paddle_tpu_torch.parallel.strategy import (BuildStrategy,
                                                    ReduceStrategy)

    cuda = cfg["place"] == "cuda"
    place = (ptt.CUDAPlace(int(os.environ.get("PADDLE_LOCAL_RANK", 0)))
             if cuda else ptt.CPUPlace())
    with ptt.unique_name.guard():
        loss = _build_model()
    bst = BuildStrategy()
    bst.reduce_strategy = ReduceStrategy.ReduceScatter
    mesh = DeviceMesh(axes={"dp": nproc})
    pexe = ParallelExecutor(use_cuda=cuda, loss_name=loss.name,
                            build_strategy=bst, mesh=mesh)
    ptt.Executor(place).run(ptt.default_startup_program())
    start = 0
    if not cfg["fresh"]:
        meta = elastic.restore_train_state(cfg["root"], executor=pexe)
        start = int(meta["step"])
    out = open(cfg["out"], "a") if rank == 0 else None
    try:
        for i in range(start, cfg["steps"]):
            elastic.maybe_crash_at_step(i)
            val = float(pexe.run(feed=_feed_for_step(i),
                                 fetch_list=[loss])[0])
            if out is not None:
                out.write(json.dumps({"step": i, "loss": val}) + "\n")
                out.flush()
            if (i + 1) % cfg["snap_every"] == 0:
                path = elastic.save_train_state(
                    cfg["root"], executor=pexe, step=i + 1,
                    barrier_deadline_s=30)
                if path is None:
                    print(f"snapshot at step {i + 1} aborted at the "
                          f"barrier; continuing", file=sys.stderr)
    finally:
        if out is not None:
            out.close()


def _check_cards(dp: int, place: str):
    """A gang on the cards needs one card a rank: never a smaller world
    than asked for."""
    if place != "cuda":
        return
    import torch

    from ..core.enforce import InvalidArgumentError
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < dp:
        raise InvalidArgumentError(
            f"the drill asks for {dp} ranks, one card each, but {n} "
            f"card(s) are visible; pass --dp {n} (or --place cpu for a "
            f"gloo world)")


def run_child(args) -> int:
    from ..distributed import launch
    from ..distributed.spawn import WorldFailed
    from ..parallel import elastic

    dp = args.world or args.dp
    _check_cards(dp, args.place)
    # the ranks inherit this process's environment, PTPU_FAULT_INJECT
    # included (this process trains nothing, so it never fires here)
    env = dict(os.environ)
    fresh = elastic.latest_snapshot(args.root) is None
    if args.fault_if_fresh and fresh:
        # self-arming fault: only the FIRST attempt crashes, so one
        # Supervisor argv covers crash and recovery
        env["PTPU_FAULT_INJECT"] = args.fault_if_fresh
    if args.fault_once:
        # arm for exactly ONE attempt, committed-or-not (a barrier kill
        # commits nothing, so "fresh" would re-arm forever)
        sentinel = os.path.join(args.root, ".fault_armed")
        os.makedirs(args.root, exist_ok=True)
        if not os.path.exists(sentinel):
            with open(sentinel, "w") as f:
                f.write(args.fault_once)
            env["PTPU_FAULT_INJECT"] = args.fault_once
    cfg = {"root": os.path.abspath(args.root),
           "out": os.path.abspath(args.out), "steps": args.steps,
           "snap_every": args.snap_every, "fresh": fresh,
           "place": args.place}
    try:
        launch(f"{_MODULE}:train_rank", dp, args=[cfg], place=args.place,
               timeout_s=GANG_TIMEOUT_S, env=env)
    except WorldFailed as e:
        print(str(e)[-4000:], file=sys.stderr)
        if -signal.SIGKILL in [e.returncodes[r] for r in e.failed]:
            # a rank was killed: the gang dies the same death, so the
            # caller sees the kill as it would a one-process child's
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        return 1
    return 0


# ---------------------------------------------------------------------------
# child: mesh-free snapshot writer (atomicity property)
# ---------------------------------------------------------------------------

def _program_and_scope(arrays):
    import torch

    import paddle_tpu_torch as ptt
    prog, startup = ptt.Program(), ptt.Program()
    scope = ptt.Scope()
    with ptt.program_guard(prog, startup):
        for name, val in arrays.items():
            prog.global_block().create_var(
                name=name, shape=list(val.shape), dtype="float32",
                persistable=True)
            scope.set_var(name, torch.from_numpy(val.copy()))
    return prog, scope


def run_atomic_child(args) -> int:
    import numpy as np

    from ..parallel import elastic

    # the parent checks surviving state against this exact generation 0
    rng = np.random.RandomState(7)
    arrays0 = {f"w_{k}": rng.randn(16, 4).astype("f4") for k in range(3)}
    arrays1 = {k: v + 1.0 for k, v in arrays0.items()}

    def _save(arrays, step, fault_env=None):
        prog, scope = _program_and_scope(arrays)
        if fault_env is not None:
            os.environ["PTPU_FAULT_INJECT"] = fault_env
        elastic.save_train_state(args.root, program=prog, scope=scope,
                                 step=step)

    os.environ.pop("PTPU_FAULT_INJECT", None)
    _save(arrays0, step=0)                       # generation 0: committed
    _save(arrays1, step=1, fault_env=args.fault or "")  # gen 1: may die
    return 0


# ---------------------------------------------------------------------------
# child: multi-rank barrier writer (crash-anywhere property)
# ---------------------------------------------------------------------------

def world_atomic_arrays(generation: int):
    """The deterministic state both sides of the property agree on: one
    dp-sharded [8, 6] matrix (its rows spread over every rank, so EVERY
    rank stages real payload) plus one replicated [4, 4] matrix (written
    once, by the rank owning its first replica). Generation g adds g to
    every element."""
    import numpy as np
    rng = np.random.RandomState(11)
    return {"sharded_w": rng.randn(8, 6).astype("f4") + generation,
            "repl_w": rng.randn(4, 4).astype("f4") + generation}


class _MeshOnly:
    """An executor stand-in for a save: a dp mesh of unjoined ranks and
    its policy (dim 0 of `sharded_*` split over dp, the rest
    replicated)."""

    def __init__(self, n):
        from ..parallel import DeviceMesh
        self.mesh = DeviceMesh(ranks=range(n), axes={"dp": n})

    def state_sharding(self, program, name):
        return (self.mesh.sharding("dp", None) if name.startswith("sharded")
                else self.mesh.replicated())


def run_world_atomic_child(args) -> int:
    from ..observability import flight_recorder
    from ..parallel import elastic
    from ..parallel.process_world import ProcessWorld

    n = args.world
    world = ProcessWorld(n)
    exe = _MeshOnly(n)
    # every rank's barrier phase transitions beacon into <root>/dossiers
    # (PTPU_DOSSIER_DIR overrides), so a SIGKILL anywhere leaves a trail
    # naming the dead rank and phase
    flight_recorder.install(
        os.environ.get("PTPU_DOSSIER_DIR")
        or os.path.join(args.root, "dossiers"))

    def _save(generation, fault_env=None):
        prog, scope = _program_and_scope(world_atomic_arrays(generation))
        if fault_env is not None:
            os.environ["PTPU_FAULT_INJECT"] = fault_env
        return elastic.save_train_state(args.root, program=prog,
                                        scope=scope, executor=exe,
                                        step=generation, world=world,
                                        barrier_deadline_s=30)

    os.environ.pop("PTPU_FAULT_INJECT", None)
    p0 = _save(0)                                # generation 0: committed
    assert p0 is not None, "generation 0 barrier must commit"
    _save(1, fault_env=args.fault or "")         # gen 1: may die anywhere
    return 0


# ---------------------------------------------------------------------------
# orchestrator
# ---------------------------------------------------------------------------

def _child_env(fault=None):
    env = dict(os.environ)
    env.pop("PTPU_FAULT_INJECT", None)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                   if p])
    if fault:
        env["PTPU_FAULT_INJECT"] = fault
    return env


def _child_argv(args, root, out, dp, fault_if_fresh=None, fault_once=None,
                steps=None):
    argv = [sys.executable, "-m", _MODULE, "--child",
            "--root", root, "--out", out, "--dp", str(dp),
            "--steps", str(steps or args.steps),
            "--snap_every", str(args.snap_every), "--place", args.place]
    if fault_if_fresh:
        argv += ["--fault_if_fresh", fault_if_fresh]
    if fault_once:
        argv += ["--fault_once", fault_once]
    return argv


def _run(argv, fault=None) -> int:
    return subprocess.run(argv, env=_child_env(fault), cwd=_ROOT).returncode


class _Reference:
    """The uninterrupted run, started at once beside the phases (whose
    own runs do not depend on it) and read when a phase first compares
    with it."""

    def __init__(self, args, work, dp):
        self.root = os.path.join(work, "ref")
        self.out = os.path.join(work, "ref.jsonl")
        self.steps = args.steps
        self.proc = subprocess.Popen(
            _child_argv(args, self.root, self.out, dp), env=_child_env(),
            cwd=_ROOT)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def losses(self):
        rc = self.proc.wait()
        assert rc == 0, f"reference run failed rc={rc}"
        ref = _losses(self.out)
        assert sorted(ref) == list(range(self.steps)), ref
        return ref


def _losses(out_path):
    """last-write-wins per step: a resumed run re-appends its tail."""
    got = {}
    with open(out_path) as f:
        for line in f:
            row = json.loads(line)
            got[row["step"]] = row["loss"]
    return got


def _resume_step(out_path):
    """The step a resumed run restarted from: the first row of the log
    that does not follow the one before it (None: no resume)."""
    prev = None
    with open(out_path) as f:
        for line in f:
            step = json.loads(line)["step"]
            if prev is not None and step <= prev:
                return step
            prev = step
    return None


def _workdir(args, prefix):
    if args.keep_root:
        shutil.rmtree(args.keep_root, ignore_errors=True)
        os.makedirs(args.keep_root)
        return args.keep_root
    return tempfile.mkdtemp(prefix=prefix)


def orchestrate(args) -> dict:
    """Phases A-C (those `--phases` names) at `--dp` ranks; returns what
    they measured."""
    from ..parallel import elastic
    from ..trainer import Supervisor

    dp, steps = args.dp, args.steps
    _check_cards(dp, args.place)
    if "B" in args.phases:
        _check_cards(2 * dp, args.place)
    work = _workdir(args, "ptt_recovery_")
    report = {"dp": dp, "steps": steps}

    print(f"== reference run (uninterrupted, dp={dp}), beside the "
          f"phases ==")
    reference = _Reference(args, work, dp)
    try:
        if "A" in args.phases:
            print("== phase A: supervised SIGKILL mid-run, resume, exact "
                  "parity ==")
            root_a = os.path.join(work, "a")
            out_a = os.path.join(work, "a.jsonl")
            sup = Supervisor(
                _child_argv(args, root_a, out_a, dp,
                            fault_if_fresh=f"crash_at_step:{CRASH_STEP}"),
                max_restarts=2, backoff_s=0.2, env=_child_env())
            rc = sup.run()
            assert rc == 0, f"supervised run did not recover rc={rc}"
            assert sup.restarts >= 1 and sup.exit_codes[0] != 0, sup.exit_codes
            got, ref = _losses(out_a), reference.losses()
            deltas = [abs(got[i] - ref[i]) for i in range(steps)]
            assert max(deltas) == 0.0, \
                f"resumed losses not bitwise-equal to reference: {deltas}"
            report["A"] = {"restarts": sup.restarts,
                           "exit_codes": list(sup.exit_codes),
                           "resume_step": _resume_step(out_a)}
            print(f"   exact parity over {steps} steps after "
                  f"{sup.restarts} restart(s), exit codes {sup.exit_codes}")

        if "B" in args.phases:
            print(f"== phase B: SIGKILL mid-run, restart with dp resized "
                  f"{dp} -> {2 * dp} ==")
            root_b = os.path.join(work, "b")
            out_b = os.path.join(work, "b.jsonl")
            rc = _run(_child_argv(args, root_b, out_b, dp),
                      fault=f"crash_at_step:{CRASH_STEP}")
            assert rc != 0, "fault-injected run was supposed to die"
            rc = _run(_child_argv(args, root_b, out_b, 2 * dp))
            assert rc == 0, f"resized restart failed rc={rc}"
            got, ref = _losses(out_b), reference.losses()
            deltas = [abs(got[i] - ref[i]) for i in range(steps)]
            assert max(deltas) <= ATOL_RESIZE, \
                f"dp{2 * dp}-resumed losses off reference by {max(deltas)}"
            report["B"] = {"max_delta": max(deltas)}
            print(f"   dp{2 * dp} resume parity max |delta| = "
                  f"{max(deltas):.2e} (bar {ATOL_RESIZE})")

        if "C" in args.phases:
            print("== phase C: SIGKILL DURING a snapshot write ==")
            root_c = os.path.join(work, "c")
            out_c = os.path.join(work, "c.jsonl")
            # offset 0: die at the very first staged byte of the first
            # snapshot
            crash_rc = _run(_child_argv(args, root_c, out_c, dp),
                            fault="crash_mid_save:0")
            assert crash_rc != 0, "crash_mid_save run was supposed to die"
            assert elastic.latest_snapshot(root_c) is None, \
                "a snapshot interrupted at byte 0 must not be committed"
            # what the killed save left: a staging dir or an uncommitted
            # snapshot dir (kept aside under --keep_root for the lint)
            leftovers = sorted(
                os.path.join(root_c, n) for n in os.listdir(root_c)
                if n.startswith(elastic.STAGING_PREFIX)
                or (n.startswith(elastic.SNAPSHOT_PREFIX)
                    and not elastic.is_committed(os.path.join(root_c, n))))
            assert leftovers, "the killed save left nothing on disk"
            kept = None
            if args.keep_root:
                kept = os.path.join(work, "c-leftover")
                shutil.copytree(leftovers[0], kept)
            rc = _run(_child_argv(args, root_c, out_c, dp))
            assert rc == 0, f"restart after mid-save crash failed rc={rc}"
            got, ref = _losses(out_c), reference.losses()
            deltas = [abs(got[i] - ref[i]) for i in range(steps)]
            assert max(deltas) == 0.0, \
                f"post-mid-save-crash losses not exact: {deltas}"
            report["C"] = {"crash_rc": crash_rc, "leftovers": len(leftovers),
                           "leftover_kept": kept,
                           "resume_step": _resume_step(out_c)}
            print("   uncommitted snapshot skipped; restart exact")
    finally:
        reference.close()

    if args.keep_root:
        print(f"work dir kept at {work}")
    else:
        shutil.rmtree(work, ignore_errors=True)
    print("recovery smoke OK")
    return report


def orchestrate_world(args) -> dict:
    """The multi-rank phases D-E over a gang of `--world` ranks: real
    SIGKILLs of a non-chief rank mid-barrier and of the chief mid-COMMIT,
    a restart, fixed-seed loss parity with the uninterrupted run. Under
    --keep_root keeps root `d` (committed barrier snapshots) and `e`
    (also holding the chief-kill's UNCOMMITTED snapshot dir)."""
    from ..parallel import elastic
    n = dp = args.world
    _check_cards(n, args.place)
    steps = args.steps
    work = _workdir(args, "ptt_recovery_world_")
    report = {"world": n, "steps": steps}

    print(f"== world reference run (uninterrupted, dp={dp}, "
          f"{n}-rank barrier), beside the phases ==")
    reference = _Reference(args, work, dp)
    try:
        def reference_losses():
            ref = reference.losses()
            ref_snap = elastic.latest_snapshot(reference.root)
            assert ref_snap is not None, "reference run committed no snapshot"
            with open(os.path.join(ref_snap, elastic.COMMIT_MARKER)) as f:
                marker = json.load(f)
            assert marker["manifests"] == n, \
                f"barrier snapshot binds {marker['manifests']} manifests, " \
                f"expected {n}"
            return ref

        def _kill_phase(tag, fault, expect_uncommitted):
            """Warm a root up to a committed barrier snapshot (steps/2), run
            the full child armed with `fault` — it resumes and the named rank
            dies at the next barrier — then restart unfaulted and demand
            bitwise parity."""
            root = os.path.join(work, tag)
            out = os.path.join(work, f"{tag}.jsonl")
            half = steps // 2
            rc = _run(_child_argv(args, root, out, dp, steps=half))
            assert rc == 0, f"{tag}: warm-up run failed rc={rc}"
            warm = elastic.latest_snapshot(root)
            assert warm is not None and \
                elastic.read_meta(warm)["step"] == half
            rc = _run(_child_argv(args, root, out, dp, fault_once=fault))
            assert rc == -signal.SIGKILL, \
                f"{tag}: gang exited {rc}, expected SIGKILL ({fault})"
            # the kill happened strictly before a COMMIT marker: the warm-up
            # snapshot is still the latest committed one
            latest = elastic.latest_snapshot(root)
            assert latest is not None and \
                elastic.read_meta(latest)["step"] == half, \
                f"{tag}: a barrier killed pre-COMMIT must commit nothing new"
            uncommitted = [p for _, p in elastic.list_snapshots(
                root, committed_only=False) if not elastic.is_committed(p)]
            if expect_uncommitted:
                assert uncommitted, \
                    f"{tag}: chief killed between rename and COMMIT must " \
                    f"leave an uncommitted snapshot dir"
            rc = _run(_child_argv(args, root, out, dp))
            assert rc == 0, f"{tag}: restart failed rc={rc}"
            got, ref = _losses(out), reference_losses()
            deltas = [abs(got[i] - ref[i]) for i in range(steps)]
            assert max(deltas) == 0.0, \
                f"{tag}: resumed losses not bitwise-equal: {deltas}"
            elastic.validate_snapshot(elastic.latest_snapshot(root))
            return [p for _, p in elastic.list_snapshots(
                root, committed_only=False) if not elastic.is_committed(p)]

        if "D" in args.phases:
            print("== phase D: SIGKILL non-chief rank 2 mid-barrier "
                  "(crash_rank:2@ack), resume, exact parity ==")
            _kill_phase("d", f"crash_rank:{min(2, n - 1)}@ack",
                        expect_uncommitted=False)
            report["D"] = {"committed": os.path.join(work, "d")}
            print("   rank kill committed nothing; resumed run exact")

        if "E" in args.phases:
            print("== phase E: SIGKILL the CHIEF mid-COMMIT "
                  "(crash_rank:0@commit), resume, exact parity ==")
            still = _kill_phase("e", "crash_rank:0@commit",
                                expect_uncommitted=True)
            assert still, "the uncommitted leftover must stay on disk"
            report["E"] = {"uncommitted_dir": still[0]}
            print(f"   uncommitted leftover {still[0]} skipped; resume exact")
    finally:
        reference.close()

    if args.keep_root:
        print(f"work dir kept at {work}")
    else:
        shutil.rmtree(work, ignore_errors=True)
    print("world recovery smoke OK")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--child", action="store_true")
    p.add_argument("--atomic-child", action="store_true",
                   dest="atomic_child")
    p.add_argument("--world-atomic-child", action="store_true",
                   dest="world_atomic_child")
    p.add_argument("--root", default="")
    p.add_argument("--out", default="")
    p.add_argument("--dp", type=int, default=2,
                   help="ranks of a training gang (phase B restarts with "
                        "twice as many)")
    p.add_argument("--world", type=int, default=0,
                   help="run the multi-rank kill phases D-E over a gang "
                        "of this many ranks (a child: its gang size)")
    p.add_argument("--phases", default="",
                   help="the phases to run (default ABC, or DE with "
                        "--world)")
    p.add_argument("--steps", type=int, default=STEPS)
    p.add_argument("--snap_every", type=int, default=SNAP_EVERY)
    p.add_argument("--fault_if_fresh", default="")
    p.add_argument("--fault_once", default="",
                   help="arm PTPU_FAULT_INJECT for exactly one attempt "
                        "(sentinel-file tracked; works for faults that "
                        "commit nothing, unlike --fault_if_fresh)")
    p.add_argument("--fault", default="")
    p.add_argument("--keep_root", default="",
                   help="orchestrator work dir to keep")
    p.add_argument("--report", default="",
                   help="write what the phases measured as JSON here")
    add_place_arg(p)
    args = p.parse_args(argv)
    if args.child:
        return run_child(args)
    if args.atomic_child:
        return run_atomic_child(args)
    if args.world_atomic_child:
        args.world = args.world or 4
        return run_world_atomic_child(args)
    if args.world:
        args.phases = args.phases or "DE"
        report = orchestrate_world(args)
    else:
        args.phases = args.phases or "ABC"
        report = orchestrate(args)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
