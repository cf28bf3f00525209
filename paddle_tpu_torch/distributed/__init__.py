"""Distributed job layer: the role protocol and the process-group
bootstrap (≙ paddle_tpu/distributed).

Ported: `DistributedEnv`, `parse_env`, `init_parallel_env` (a
torch.distributed world: NCCL on cards, gloo on the CPU), `global_rank`,
`world_size`, and `launch` (spawn.py: a function in a world of local
processes; a script runs on several cards under `torchrun`). The
fault-tolerant task master (`Master`, `MasterClient`, `Task`) and
elasticity (`ElasticTrainer`, `FailureDetector`, `PreemptionGuard`)
wait: ROADMAP.md §1 item 4 (elasticity and sharded checkpoints); each
raises naming it.
"""

from .env import (DistributedEnv, PSERVER, TRAINER,  # noqa: F401
                  destroy_parallel_env, global_rank, init_parallel_env,
                  local_rank, parse_env, world_size)
from .spawn import launch  # noqa: F401

_ELASTIC = ("{name} is not ported: ROADMAP.md §1 item 4 (elasticity and "
            "sharded checkpoints)")


def _waiting(name):
    class _Waiting:
        def __init__(self, *a, **k):
            raise NotImplementedError(_ELASTIC.format(name=name))
    _Waiting.__name__ = _Waiting.__qualname__ = name
    _Waiting.__doc__ = _ELASTIC.format(name=name)
    return _Waiting


Master = _waiting("Master")
MasterClient = _waiting("MasterClient")
Task = _waiting("Task")
ElasticTrainer = _waiting("ElasticTrainer")
FailureDetector = _waiting("FailureDetector")
PreemptionGuard = _waiting("PreemptionGuard")
