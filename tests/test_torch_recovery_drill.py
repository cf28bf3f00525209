"""The port's recovery drill (`paddle_tpu_torch.tools.recovery_smoke`)
under real process deaths, over gloo with `--place cpu`.

- Phase A at dp 2: a gang of 2 rank processes SIGKILLs itself at step 5,
  the Supervisor relaunches it, and the resumed losses equal the
  uninterrupted gang's bitwise.
- Phase D over 4 ranks: rank 2 is SIGKILLed at the barrier's `ack`; the
  gang dies with -9 (never hangs), nothing new commits, and the restart's
  losses equal the uninterrupted run's bitwise. The kept root then lints
  clean under `lint_program --restore_dir` against the drill's program,
  and an uncommitted snapshot dir lints as `restore-uncommitted`.
- `--atomic-child` killed at one random byte offset of generation 1's
  staged payload leaves generation 0 committed and nothing half-written.
- `--world-atomic-child` (a simulated world of 4) with rank 2 SIGKILLed
  at `ack`: generation 0 stays the committed snapshot, 4 manifests.
- Fewer cards than ranks on `--place cuda`: the drill raises, naming
  both numbers.

The two orchestrations run at once, one launch each.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import EnforceError, InvalidArgumentError
from paddle_tpu_torch.parallel import elastic
from paddle_tpu_torch.tools import lint_program as tlint
from paddle_tpu_torch.tools import recovery_smoke as drill

from tests.port_env import port_jax_compile_cache  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(fault=None):
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    env.pop("PTPU_FAULT_INJECT", None)
    if fault:
        env["PTPU_FAULT_INJECT"] = fault
    return env


def _drill(*argv):
    return [sys.executable, "-m", "paddle_tpu_torch.tools.recovery_smoke",
            "--place", "cpu", *argv]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Phase A at dp 2 and phase D over 4 ranks, started together."""
    base = tmp_path_factory.mktemp("drill")
    jobs = {
        "A": _drill("--dp", "2", "--phases", "A", "--keep_root",
                    str(base / "a"), "--report", str(base / "a.json")),
        "D": _drill("--world", "4", "--phases", "D", "--keep_root",
                    str(base / "d"), "--report", str(base / "d.json")),
    }
    procs = {k: subprocess.Popen(v, cwd=str(base), env=_env(),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, v in jobs.items()}
    out = {}
    for k, p in procs.items():
        log, _ = p.communicate(timeout=600)
        report = base / f"{k.lower()}.json"
        out[k] = (p.returncode, log, json.loads(report.read_text())
                  if report.exists() else None)
    out["base"] = base
    return out


def test_phase_a_resumes_bitwise_at_dp2(runs):
    rc, log, report = runs["A"]
    assert rc == 0, log[-4000:]
    assert "exact parity over 8 steps" in log
    a = report["A"]
    assert a["restarts"] == 1 and a["exit_codes"] == [-9, 0]
    # crash at step 5, snapshots every 2: the gang resumed from step 4
    assert a["resume_step"] == 4
    with open(runs["base"] / "a" / "a.jsonl") as f:
        steps = [json.loads(ln)["step"] for ln in f]
    assert steps == [0, 1, 2, 3, 4, 4, 5, 6, 7]


def test_phase_d_rank_kill_commits_nothing_and_resumes_bitwise(runs):
    rc, log, report = runs["D"]
    assert rc == 0, log[-4000:]
    assert "fault injection: SIGKILL at rank 2 phase ack" in log
    assert "resumed run exact" in log
    root = str(runs["base"] / "d" / "d")
    snaps = elastic.list_snapshots(root, committed_only=False)
    assert all(elastic.is_committed(p) for _, p in snaps)
    latest = elastic.latest_snapshot(root)
    assert elastic.read_meta(latest)["step"] == drill.STEPS
    with open(os.path.join(latest, elastic.COMMIT_MARKER)) as f:
        assert json.load(f)["manifests"] == 4


def _lint_restore(restore_dir):
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    args = argparse.Namespace(
        tp=0, dp=0, pipeline_stages=0, num_microbatches=4,
        memory_plan=False, offload=False, serving=False, strategy="",
        restore_dir=restore_dir, batch_size=8, optimizer="momentum",
        comm_bucket_bytes=1 << 20, json=True, max_shard_rows=24,
        max_diags=40, allow_gate_rejects=False)
    return tlint.lint_one("mnist", tlint._builders()["mnist"], args)


def test_lint_restore_dir_on_the_drills_snapshots(runs, tmp_path):
    root = str(runs["base"] / "d" / "d")
    row = _lint_restore(root)
    assert row["errors"] == 0, row["diagnostics"]
    # the same snapshot without its COMMIT marker: uncommitted
    bad = tmp_path / "snapshot-00000099"
    shutil.copytree(elastic.latest_snapshot(root), bad)
    os.remove(bad / elastic.COMMIT_MARKER)
    row = _lint_restore(str(bad))
    assert row["errors"] == 1
    assert row["diagnostics"][0]["code"] == "restore-uncommitted"


def test_atomic_child_killed_at_a_random_offset(tmp_path):
    ref = str(tmp_path / "ref")
    assert drill.main(["--atomic-child", "--root", ref]) == 0
    marker = json.load(open(os.path.join(elastic.latest_snapshot(ref),
                                         elastic.COMMIT_MARKER)))
    total = sum(e["size"] for e in marker["files"].values())
    off = int(np.random.RandomState(20261018).randint(1, total))
    root = str(tmp_path / "crash")
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.recovery_smoke",
         "--atomic-child", "--root", root, "--fault",
         f"crash_mid_save:{off}"], cwd=str(tmp_path), env=_env(),
        timeout=120).returncode
    assert rc == -9
    for _, path in elastic.list_snapshots(root, committed_only=False):
        if not elastic.is_committed(path):
            with pytest.raises(EnforceError):
                elastic.validate_snapshot(path)
    assert {elastic.read_meta(p)["step"]
            for _, p in elastic.list_snapshots(root)} == {0}
    from paddle_tpu_torch.sharded_checkpoint import ShardedCheckpoint
    rng = np.random.RandomState(7)
    want = {f"w_{k}": rng.randn(16, 4).astype("f4") for k in range(3)}
    ckpt = ShardedCheckpoint(elastic.latest_snapshot(root))
    try:
        for name, val in want.items():
            np.testing.assert_array_equal(ckpt.read(name).numpy(), val)
    finally:
        ckpt.close()


def test_fewer_cards_than_ranks_raises_naming_both(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(InvalidArgumentError,
                       match=r"asks for 2 ranks.*but 1 card"):
        drill.main(["--dp", "2", "--phases", "A"])


def test_world_atomic_arrays_equal_the_jax_tools():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_jax_recovery_smoke", os.path.join(ROOT, "tools",
                                            "recovery_smoke.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    for g in (0, 1):
        want, got = jmod.world_atomic_arrays(g), drill.world_atomic_arrays(g)
        assert sorted(want) == sorted(got)
        for n in want:
            np.testing.assert_array_equal(got[n], want[n])
    assert (drill.STEPS, drill.SNAP_EVERY, drill.CRASH_STEP) == \
        (jmod.STEPS, jmod.SNAP_EVERY, jmod.CRASH_STEP)


def test_world_atomic_child_killed_mid_barrier(tmp_path):
    """A rank of the simulated 4-rank world SIGKILLed at `ack` of
    generation 1: generation 0, committed through the barrier with 4
    manifests, is the latest; its arrays are the shared ones."""
    root = str(tmp_path / "w")
    rc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.tools.recovery_smoke",
         "--world-atomic-child", "--world", "4", "--root", root, "--fault",
         "crash_rank:2@ack"], cwd=str(tmp_path), env=_env(),
        timeout=120).returncode
    assert rc == -9
    latest = elastic.latest_snapshot(root)
    assert elastic.read_meta(latest)["step"] == 0
    with open(os.path.join(latest, elastic.COMMIT_MARKER)) as f:
        assert json.load(f)["manifests"] == 4
    from paddle_tpu_torch.sharded_checkpoint import ShardedCheckpoint
    ckpt = ShardedCheckpoint(latest)
    try:
        for name, val in drill.world_atomic_arrays(0).items():
            np.testing.assert_array_equal(ckpt.read(name).numpy(), val)
    finally:
        ckpt.close()
    beacons = os.listdir(os.path.join(root, "dossiers"))
    assert any(n.startswith("flight-") for n in beacons), beacons
