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
padded batches, the global batch's semantics for every op, tp, sequence
parallelism over the ring, pipeline stages, the optimizer state
offloaded to pinned host memory, the memory plan on the rewritten
program, the auto-parallel planner), and
elastic training: atomic snapshots with async saves and restore across
mesh changes (`elastic`), the resize planner (`reshard`) and the
simulated process world of the multi-writer barrier (`process_world`).
Like the JAX package, importing this package registers its ops.
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

from . import elastic  # noqa: F401
from . import process_world  # noqa: F401
from . import reshard  # noqa: F401
from .elastic import (latest_snapshot, restore_train_state,  # noqa: F401
                      save_train_state)
from .process_world import ProcessWorld  # noqa: F401
