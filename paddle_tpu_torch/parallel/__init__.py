"""Parallelism over a torch.distributed world (≙ paddle_tpu/parallel).

The JAX package compiles one SPMD program over a device mesh; the port
runs one process per rank (`distributed.init_parallel_env`), each on its
own card, with the collectives torch.distributed calls among the ranks of
a mesh axis: NCCL on the cards, gloo on the CPU.

Ported: the mesh (`mesh.py`), the strategies, the collectives with their
quantized forms (`collective.py`), the tp collective ops
(`tensor_parallel.py`), the explicit gradient pipeline (`grad_comm.py`),
the pipeline schedule engine (`pipeline.py`), `annotate_tp`, sharded
embeddings, ring attention over the flash kernels, and `ParallelExecutor`
(AllReduce, Reduce / ZeRO-1, ReduceScatter and the quantized wires,
padded batches, tp, pipeline stages, the auto-parallel planner). Like the
JAX package, importing this package registers its ops. Waiting (ROADMAP.md
§1 item 4): elasticity and sharded checkpoints (`elastic`, `reshard`,
`process_world`).
"""

from .mesh import (DeviceMesh, Placement, get_default_mesh,  # noqa: F401
                   make_mesh, set_default_mesh)
from .strategy import BuildStrategy, ExecutionStrategy, ReduceStrategy  # noqa: F401
from .parallel_executor import ParallelExecutor  # noqa: F401
from . import collective  # noqa: F401
from . import grad_comm  # noqa: F401
from . import tensor_parallel  # noqa: F401
from . import pipeline  # noqa: F401
from . import ring_attention  # noqa: F401
from . import sharded_embedding  # noqa: F401
from . import auto_shard  # noqa: F401
from .auto_shard import annotate_tp  # noqa: F401

_ELASTIC = ("{name} is not ported: ROADMAP.md §1 item 4 (elasticity and "
            "sharded checkpoints)")


def _waiting(name):
    def fn(*a, **k):
        raise NotImplementedError(_ELASTIC.format(name=name))
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = _ELASTIC.format(name=name)
    return fn


latest_snapshot = _waiting("latest_snapshot")
restore_train_state = _waiting("restore_train_state")
save_train_state = _waiting("save_train_state")
