"""Spawn a world of local processes (≙ paddle.distributed.launch, for a
function rather than a script: a script runs under `torchrun`).

`launch(target, nproc, ...)` starts one process per rank with the
PADDLE_* protocol set (PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM,
PADDLE_LOCAL_RANK); each joins the world over a file store and calls
`function(rank, world_size, *args)` for a target named
"path/to/file.py:function" or "package.module:function". It waits for
every rank, stops them all when one fails or the time limit passes, and
raises naming the ranks that failed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence


def _wait_all(procs, timeout_s: float, logs):
    deadline = time.time() + timeout_s
    failed = []
    while True:
        codes = [p.poll() for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad or all(c is not None for c in codes) or \
                time.time() > deadline:
            break
        time.sleep(0.05)
    timed_out = any(p.poll() is None for p in procs)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = []
        for r in failed:
            if logs[r] is not None:
                logs[r].seek(0)
                tails.append(f"--- rank {r} ---\n"
                             + logs[r].read().decode(errors="replace")[-4000:])
        what = "timed out" if timed_out else "failed"
        raise RuntimeError(f"ranks {failed} {what}\n" + "\n".join(tails))


def launch(target: str, nproc: int, args: Sequence = (), *,
           place: str = "cuda", timeout_s: float = 300.0,
           store_dir: Optional[str] = None, env: Optional[dict] = None,
           log_dir: Optional[str] = None):
    """Run `target` ("file.py:fn" or "module:fn") in `nproc` processes
    joined in one world (NCCL for place "cuda", one card per rank; gloo
    for "cpu"), each as fn(rank, nproc, *args); `args` must be JSON. The
    world's collectives time out after `timeout_s` (the group's timeout),
    and the whole launch is stopped after 2 x `timeout_s`. `log_dir`
    keeps each rank's output as rank<r>.log there."""
    from ..core.enforce import InvalidArgumentError
    if place not in ("cuda", "cpu"):
        raise InvalidArgumentError(f"unknown place {place!r}: launch takes "
                                   f"'cuda' or 'cpu'")
    store_dir = store_dir or tempfile.mkdtemp(prefix="ptt_world_")
    store = os.path.join(store_dir, "store")
    spec = json.dumps({"target": target, "args": list(args),
                       "place": place, "store": store,
                       "timeout_s": timeout_s})
    procs, logs = [], []
    for r in range(nproc):
        e = dict(os.environ if env is None else env)
        e.update({"PADDLE_TRAINER_ID": str(r),
                  "PADDLE_TRAINERS_NUM": str(nproc),
                  "PADDLE_LOCAL_RANK": str(r)})
        log = (open(os.path.join(log_dir, f"rank{r}.log"), "w+b")
               if log_dir else tempfile.TemporaryFile())
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed",
             "--worker", spec], env=e, stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))))
    try:
        _wait_all(procs, 2 * timeout_s, logs)
    finally:
        for log in logs:
            log.close()


def _resolve(target: str):
    path, fn = target.rsplit(":", 1)
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            "_ptt_launch_target", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path)
    return getattr(mod, fn)


def _worker(spec_json: str):
    from ..core.places import CPUPlace, CUDAPlace
    from .env import destroy_parallel_env, init_parallel_env, parse_env
    spec = json.loads(spec_json)
    env = parse_env()
    place = (CPUPlace() if spec["place"] == "cpu"
             else CUDAPlace(int(os.environ.get("PADDLE_LOCAL_RANK", 0))))
    init_parallel_env(env, timeout_s=int(spec["timeout_s"]), place=place,
                      store_path=spec["store"])
    try:
        _resolve(spec["target"])(env.trainer_id, env.num_trainers,
                                 *spec["args"])
    finally:
        destroy_parallel_env()


def main(argv=None):
    """The rank processes' entry: `python -m paddle_tpu_torch.distributed
    --worker <spec>`."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] != ["--worker"]:
        raise SystemExit("usage: python -m paddle_tpu_torch.distributed "
                         "--worker <spec> (started by launch(); run a "
                         "script on several cards with torchrun)")
    _worker(argv[1])
