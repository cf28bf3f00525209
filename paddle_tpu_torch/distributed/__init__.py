"""Distributed job layer: the role protocol and the process-group
bootstrap (≙ paddle_tpu/distributed).

Ported: `DistributedEnv`, `parse_env`, `init_parallel_env` (a
torch.distributed world: NCCL on cards, gloo on the CPU), `global_rank`,
`world_size`, `launch` (spawn.py: a function in a world of local
processes; a script runs on several cards under `torchrun`), the
fault-tolerant task master (`Master`, `MasterClient`, `Task`, over
XML-RPC on localhost) and checkpoint-restart elasticity
(`ElasticTrainer`, `FailureDetector`, `PreemptionGuard`).
"""

from .env import (DistributedEnv, PSERVER, TRAINER,  # noqa: F401
                  destroy_parallel_env, global_rank, init_parallel_env,
                  local_rank, parse_env, world_size)
from .spawn import launch  # noqa: F401

from .elastic import ElasticTrainer, FailureDetector, PreemptionGuard  # noqa: F401,E501
from .master import Master, MasterClient, Task  # noqa: F401
