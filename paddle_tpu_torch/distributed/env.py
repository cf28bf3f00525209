"""Distributed role configuration and the process-group bootstrap.

≙ paddle_tpu/distributed/env.py (itself ≙ the reference's PADDLE_* role
protocol, trainer.py:324, and the gen_nccl_id bootstrap,
gen_nccl_id_op.cc:24). The JAX package joins a jax.distributed world
against a coordinator; the port joins a torch.distributed one: one
process per rank, each driving its own card (`CUDAPlace(local_rank)`) on
NCCL, or a world of CPU processes on gloo. The PADDLE_* names are read as
the JAX package reads them; `torchrun`'s RANK / WORLD_SIZE / LOCAL_RANK /
MASTER_ADDR / MASTER_PORT are read when no PADDLE_* world is set.

`init_parallel_env` never falls back: a CUDA place joins NCCL or raises,
and a rank that cannot reach its peers fails after `timeout_s` instead of
hanging.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional

TRAINER = "TRAINER"
PSERVER = "PSERVER"


@dataclass
class DistributedEnv:
    """Parsed role config (≙ the PADDLE_* env protocol)."""
    training_role: str = TRAINER
    trainer_id: int = 0
    num_trainers: int = 1
    coordinator: Optional[str] = None      # host:port of rank 0's store
    pserver_endpoints: tuple = ()
    current_endpoint: Optional[str] = None

    @property
    def is_chief(self) -> bool:
        return self.trainer_id == 0


def parse_env(environ=None) -> DistributedEnv:
    """Read the reference's env-var protocol (trainer.py:324 names kept,
    PADDLE_COORDINATOR_ENDPOINT added), or torchrun's when no PADDLE_*
    world size is set."""
    e = environ if environ is not None else os.environ
    n = e.get("PADDLE_TRAINERS_NUM", e.get("PADDLE_TRAINERS"))
    rank = e.get("PADDLE_TRAINER_ID")
    coordinator = e.get("PADDLE_COORDINATOR_ENDPOINT") or None
    if n is None and "WORLD_SIZE" in e:
        n, rank = e["WORLD_SIZE"], e.get("RANK", "0")
        if coordinator is None and e.get("MASTER_ADDR"):
            coordinator = f"{e['MASTER_ADDR']}:{e.get('MASTER_PORT', '29500')}"
    return DistributedEnv(
        training_role=e.get("PADDLE_TRAINING_ROLE", TRAINER).upper(),
        trainer_id=int(rank or "0"),
        num_trainers=int(n or "1"),
        coordinator=coordinator,
        pserver_endpoints=tuple(
            p for p in e.get("PADDLE_PSERVER_IPS", "").split(",") if p),
        current_endpoint=e.get("PADDLE_CURRENT_ENDPOINT") or None,
    )


def local_rank(environ=None) -> int:
    """This process's card: LOCAL_RANK (torchrun) or PADDLE_LOCAL_RANK,
    else the env's rank modulo the visible cards (one host), else 0."""
    e = environ if environ is not None else os.environ
    for key in ("LOCAL_RANK", "PADDLE_LOCAL_RANK"):
        if key in e:
            return int(e[key])
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return parse_env(e).trainer_id % n if n else 0


def init_parallel_env(env: Optional[DistributedEnv] = None,
                      timeout_s: int = 300, place=None,
                      store_path: Optional[str] = None) -> DistributedEnv:
    """Join the world (≙ the gen_nccl_id bootstrap).

    `place` picks the backend: a CUDA place (the default) joins NCCL on
    `CUDAPlace(local_rank)`, `CPUPlace()` joins gloo. The rendezvous is a
    TCP store at the coordinator (`PADDLE_COORDINATOR_ENDPOINT`, or
    torchrun's MASTER_ADDR:MASTER_PORT), or a file store at `store_path`
    (the tests' worlds). A world of one with no coordinator and no store
    joins nothing, so the same script runs on one card unchanged; pass a
    store to join a world of one (its collectives then run on NCCL).
    Joining twice is a no-op."""
    import torch
    import torch.distributed as dist
    env = env or parse_env()
    if dist.is_initialized():
        return env
    if env.num_trainers <= 1 and not env.coordinator and not store_path:
        return env
    from ..core.enforce import InvalidArgumentError, UnavailableError
    from ..core.places import CUDAPlace
    place = place if place is not None else CUDAPlace(local_rank())
    if place.kind == "cuda":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise UnavailableError(
                "init_parallel_env on a CUDA place needs NCCL and a visible "
                "card; pass place=CPUPlace() for a gloo world of CPU "
                "processes")
        torch.cuda.set_device(place.device_id)
        backend = "nccl"
    elif place.kind == "cpu":
        backend = "gloo"
    else:
        raise InvalidArgumentError(f"unknown place {place!r}")
    if store_path:
        init_method = f"file://{store_path}"
    elif env.coordinator:
        init_method = f"tcp://{env.coordinator}"
    else:
        raise InvalidArgumentError(
            f"a world of {env.num_trainers} needs a rendezvous: set "
            f"PADDLE_COORDINATOR_ENDPOINT (or torchrun's MASTER_ADDR / "
            f"MASTER_PORT) or pass store_path")
    kw = {}
    import inspect
    if backend == "nccl" and "device_id" in inspect.signature(
            dist.init_process_group).parameters:
        # bind the communicator to this rank's card at once (torch >= 2.3)
        kw["device_id"] = torch.device("cuda", place.device_id)
    dist.init_process_group(
        backend, init_method=init_method, rank=env.trainer_id,
        world_size=env.num_trainers,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return env


def global_rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def destroy_parallel_env():
    """Leave the world (≙ jax.distributed.shutdown): the process groups
    are destroyed, so the process can exit without waiting on peers."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
