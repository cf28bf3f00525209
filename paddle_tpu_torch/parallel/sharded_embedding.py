"""Sharded embedding tables (vocab / expert partitioning).

≙ paddle_tpu/parallel/sharded_embedding.py (≙ the reference's distributed
lookup table: prefetch_op.cc, lookup_sparse_table_op.cc,
distribute_transpiler.py:212). The table lives row-split over a mesh axis;
each rank gathers the ids that fall in its row range, zeroes the rest, and
the partial rows are summed over the axis group. The backward through the
local gather is a scatter-add onto the rank's own rows: the gradient never
materializes the full table.
"""

from __future__ import annotations

from ..core.enforce import InvalidArgumentError, enforce
from .mesh import MODEL_AXIS, DeviceMesh, Placement
from .tensor_parallel import psum_once


def sharded_embedding_lookup(mesh: DeviceMesh, table, ids,
                             axis_name: str = MODEL_AXIS):
    """table: the [V, D] table (every rank reads only its row block of it,
    `embedding_table_sharding`); ids: global int ids [...]. Returns
    [..., D], the full lookup, on every rank of the axis. Differentiable in
    `table`: a rank's gradient holds its own rows (the ranks' gradients
    sum to the dense one), and the output's cotangent passes the
    all-reduce unscaled, as the JAX package's replicated output does."""
    n = mesh.axis_size(axis_name)
    v = table.shape[0]
    enforce(v % n == 0, f"vocab {v} not divisible by shard count {n}",
            exc=InvalidArgumentError)
    rows_per = v // n
    with mesh:
        idx = mesh.axis_index(axis_name)
        block = table.narrow(0, idx * rows_per, rows_per)
        local = ids.long() - idx * rows_per
        in_range = (local >= 0) & (local < rows_per)
        vals = block[local.clamp(0, rows_per - 1)]
        vals = vals * in_range.unsqueeze(-1).to(vals.dtype)
        return psum_once(vals, axis_name)


def embedding_table_sharding(mesh: DeviceMesh,
                             axis_name: str = MODEL_AXIS) -> Placement:
    """The placement that keeps a [V, D] table row-split over
    `axis_name` (`mesh.local_slice(table, placement)` cuts a rank's
    block)."""
    return mesh.sharding(axis_name, None)
