"""Mesh-to-mesh resharding planner for elastic restore.

≙ paddle_tpu/parallel/reshard.py. `restore_train_state` re-lays
checkpointed state across a mesh change (dp2×tp2 → dp4, dp2×pp2 →
dp2×tp2, ...): each rank reads only the chunks of the old coverage its
new block intersects (sharded_checkpoint.read_slice). This module makes
that re-layout an inspectable PLAN — the checkpoint-mediated form of
"Memory-efficient array redistribution through portable collective
communication": the transition as a collective sequence instead of full
arrays round-tripping through host memory.

Per variable the planner derives:

- the OLD shard coverage from the snapshot's chunk grid (distinct chunk
  starts per dim); `train_meta.json` `placements` adds the axis names;
- the NEW placement from the target executor's policy
  (`ParallelExecutor.state_sharding`, a `Placement` over its mesh);
- a **read plan**: which chunks the new placement reads, with the
  intersection byte counts (over the distinct new blocks, and per rank:
  `ReshardPlan.rank_read_bytes`) — what read_slice copies;
- the **equivalent on-hardware redistribution schedule** in the
  redistribution algebra

      refine     old factor divides the new one: dynamic-slice, 0 wire
      all-gather an incompatible dim un-shards over its old group
                 (ring accounting, framework/costs.py), then slices

  validated against `framework.costs.reshard_wire_bytes`: the closed
  form and the step-priced schedule must agree exactly.

Error-feedback residuals are not part of the per-variable schedule:
their resize re-packs through the gradient space
(`elastic._remap_error_feedback`); the plan lists them with their sizes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..framework import costs as _costs


@dataclass
class ReshardStep:
    """One schedule entry for one variable."""
    var: str
    kind: str            # "all-gather" | "refine-slice" | "identity"
    dim: int             # tensor dim the step acts on (-1 for identity)
    group: int           # collective group size (1 for local steps)
    out_bytes: int       # per-device OUTPUT bytes of the collective
    wire_bytes: float    # per-device interconnect bytes (ring model)
    axes: Tuple[str, ...] = ()   # mesh axis names involved, for display

    def __str__(self):
        ax = "/".join(self.axes) or "-"
        return (f"{self.var}: {self.kind} dim={self.dim} group="
                f"{self.group} axes={ax} out={self.out_bytes}B "
                f"wire={self.wire_bytes:.0f}B")


@dataclass
class VariablePlan:
    var: str
    shape: Tuple[int, ...]
    nbytes: int
    old_factors: Tuple[int, ...]
    new_factors: Tuple[int, ...]
    steps: List[ReshardStep] = field(default_factory=list)
    #: chunk keys ((file, key, intersect_bytes)) the new placement reads
    reads: List[Tuple[str, str, int]] = field(default_factory=list)
    #: rank -> bytes its own new block reads
    rank_reads: Dict[int, int] = field(default_factory=dict)

    @property
    def wire_bytes(self) -> float:
        return sum(s.wire_bytes for s in self.steps)

    @property
    def read_bytes(self) -> int:
        return sum(b for _, _, b in self.reads)


@dataclass
class ReshardPlan:
    old_world: Dict[str, int]
    new_world: Dict[str, int]
    variables: Dict[str, VariablePlan] = field(default_factory=dict)
    ef_vars: Dict[str, int] = field(default_factory=dict)  # name -> bytes

    @property
    def wire_bytes(self) -> float:
        return sum(v.wire_bytes for v in self.variables.values())

    @property
    def read_bytes(self) -> int:
        return sum(v.read_bytes for v in self.variables.values())

    def rank_read_bytes(self, rank: int) -> int:
        """Bytes `rank`'s new blocks read from the snapshot's chunks."""
        return sum(v.rank_reads.get(rank, 0)
                   for v in self.variables.values())

    def moved_vars(self) -> List[str]:
        """Variables whose re-layout puts bytes on the wire."""
        return sorted(n for n, v in self.variables.items()
                      if v.wire_bytes > 0)

    def summary(self) -> Dict[str, Any]:
        kinds: Dict[str, int] = {}
        for v in self.variables.values():
            for s in v.steps:
                kinds[s.kind] = kinds.get(s.kind, 0) + 1
        return {
            "old_world": dict(self.old_world),
            "new_world": dict(self.new_world),
            "n_vars": len(self.variables),
            "n_moved": len(self.moved_vars()),
            "wire_bytes": self.wire_bytes,
            "read_bytes": self.read_bytes,
            "steps": kinds,
            "ef_vars": dict(self.ef_vars),
        }


def _coverage_factors(entry: Dict, shape: Sequence[int]) -> Tuple[int, ...]:
    """Old shard factors per dim from the chunk grid: the number of
    distinct chunk start offsets along each dim. A replicated save has
    one chunk covering the whole array (all factors 1); a dp4-sharded
    dim 0 has 4 distinct starts."""
    rank = len(shape)
    if rank == 0:
        return ()
    starts = [set() for _ in range(rank)]
    for c in entry["chunks"]:
        cs = c["start"] or [0] * rank
        for d in range(rank):
            starts[d].add(int(cs[d]))
    return tuple(max(1, len(s)) for s in starts)


def _spec_factors(spec, mesh_axes: Dict[str, int],
                  rank: int) -> Tuple[Tuple[int, ...],
                                      Tuple[Tuple[str, ...], ...]]:
    """New shard factors (and the axis names behind them) per dim from a
    PartitionSpec-style entry list."""
    factors, names = [], []
    entries = list(spec or ())
    entries += [None] * (rank - len(entries))
    for s in entries[:rank]:
        if s is None:
            factors.append(1)
            names.append(())
            continue
        axes = tuple(s) if isinstance(s, (tuple, list)) else (s,)
        f = 1
        for a in axes:
            f *= int(mesh_axes.get(a, 1))
        factors.append(f)
        names.append(axes)
    return tuple(factors), tuple(names)


def schedule_steps(var: str, shape: Sequence[int], itemsize: int,
                   old_factors: Sequence[int],
                   new_factors: Sequence[int],
                   old_axes: Sequence[Tuple[str, ...]] = (),
                   new_axes: Sequence[Tuple[str, ...]] = ()
                   ) -> List[ReshardStep]:
    """The canonical redistribution schedule for one variable, in the
    same algebra `costs.reshard_wire_bytes` prices:

    phase 1 — every dim whose new factor is a multiple of its current
    one refines by dynamic-slice (0 wire); phase 2 — each remaining
    incompatible dim all-gathers over its old group (output bytes
    computed at the CURRENT factors of the other dims — refinement
    first makes the gathers cheaper, the memory-efficient ordering),
    then slices to the new factor."""
    shape = tuple(int(d) for d in shape)
    nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize \
        if shape else itemsize
    rank = len(shape)
    cur = list(old_factors) + [1] * (rank - len(old_factors))
    new = list(new_factors) + [1] * (rank - len(new_factors))
    for d in range(rank):
        enforce(shape[d] % max(cur[d], 1) == 0
                and shape[d] % max(new[d], 1) == 0,
                f"{var!r} dim {d} ({shape[d]}) does not divide by its "
                f"shard factors (old {cur[d]}, new {new[d]})",
                exc=InvalidArgumentError)
    steps: List[ReshardStep] = []

    def _ax(axes_list, d):
        return tuple(axes_list[d]) if d < len(axes_list) else ()

    # phase 1: refinement slices (and identity detection)
    for d in range(rank):
        if new[d] == cur[d]:
            continue
        if new[d] % cur[d] == 0:
            cur[d] = new[d]
            steps.append(ReshardStep(var, "refine-slice", d, 1, 0, 0.0,
                                     _ax(new_axes, d)))
    # phase 2: incompatible dims gather over the old group, then slice
    for d in range(rank):
        if cur[d] == new[d]:
            continue
        others = 1
        for d2 in range(rank):
            if d2 != d:
                others *= cur[d2]
        out = nbytes // others
        g = cur[d]
        wire = _costs.collective_wire_bytes("all-gather", out, g)
        steps.append(ReshardStep(var, "all-gather", d, g, out, wire,
                                 _ax(old_axes, d)))
        cur[d] = 1
        if new[d] > 1:
            steps.append(ReshardStep(var, "refine-slice", d, 1, 0, 0.0,
                                     _ax(new_axes, d)))
            cur[d] = new[d]
    if not steps:
        steps.append(ReshardStep(var, "identity", -1, 1, 0, 0.0))
    return steps


def _blocks(mesh, placement, shape) -> Dict[int, Tuple[Tuple[int, int], ...]]:
    """rank -> its block of the new placement, as ((start, stop), ...)."""
    from ..sharded_checkpoint import block_of
    out = {}
    for r in mesh.ranks:
        start, block, _ = block_of(mesh, placement, r, shape)
        out[r] = tuple((a, a + n) for a, n in zip(start, block))
    return out


def _intersections(entry: Dict, rank: int, sl, itemsize: int
                   ) -> Dict[Tuple[str, str], int]:
    reads: Dict[Tuple[str, str], int] = {}
    for c in entry["chunks"]:
        cs = c["start"] or [0] * rank
        ce = [s + d for s, d in zip(cs, c["shape"])]
        inter = 1
        for (a, b), s, e in zip(sl, cs, ce):
            lo, hi = max(a, s), min(b, e)
            if lo >= hi:
                inter = 0
                break
            inter *= hi - lo
        if inter:
            key = (c["file"], c["key"])
            reads[key] = reads.get(key, 0) + inter * itemsize
    return reads


def _chunk_reads(entry: Dict, shape: Sequence[int], itemsize: int,
                 placement, mesh) -> Tuple[List[Tuple[str, str, int]],
                                           Dict[int, int]]:
    """Which chunks (and how many intersecting bytes) the NEW placement
    reads — the union over its distinct blocks (replicated ranks share
    one) — and the bytes each rank's own block reads: exactly what
    read_slice copies."""
    rank = len(shape)
    if rank == 0 or placement is None or mesh is None:
        whole = [(c["file"], c["key"],
                  int(np.prod(c["shape"], dtype=np.int64)) * itemsize
                  if c["shape"] else itemsize)
                 for c in entry["chunks"]]
        total = sum(b for _, _, b in whole)
        return whole, {r: total for r in (mesh.ranks if mesh else [0])}
    blocks = _blocks(mesh, placement, shape)
    reads: Dict[Tuple[str, str], int] = {}
    for sl in set(blocks.values()):
        for key, b in _intersections(entry, rank, sl, itemsize).items():
            reads[key] = reads.get(key, 0) + b
    per_rank = {r: sum(_intersections(entry, rank, sl, itemsize).values())
                for r, sl in blocks.items()}
    return [(f, k, b) for (f, k), b in sorted(reads.items())], per_rank


def plan_restore(ckpt, meta: Dict, prepared, executor,
                 names: Optional[Sequence[str]] = None) -> ReshardPlan:
    """Build the full mesh-resize plan for restoring checkpoint `ckpt`
    (a sharded_checkpoint.ShardedCheckpoint) with metadata `meta` onto
    `executor` running `prepared` (the REWRITTEN program view). `names`
    defaults to every saved variable the program declares. Pure
    bookkeeping: no collective, no file read."""
    from ..io import _is_persistable, _select_vars

    mesh = getattr(executor, "mesh", None)
    new_world = dict(getattr(mesh, "axes", {}) or {})
    plan = ReshardPlan(old_world=dict(meta.get("world", {}) or {}),
                       new_world=new_world)
    placements = meta.get("placements") or {}
    ef_vars = {t["var"] for t in (meta.get("ef_layout") or {})
               .get("transfers", ())}
    saved = ckpt.vars
    declared = {v.name for v in _select_vars(prepared, _is_persistable)}
    for name in (names if names is not None else sorted(saved)):
        entry = saved.get(name)
        if entry is None:
            continue
        if name in ef_vars:
            shape = entry["shape"]
            nbytes = int(np.prod(shape, dtype=np.int64)) * 4 \
                if shape else 4
            plan.ef_vars[name] = nbytes
            continue
        if names is None and name not in declared:
            continue  # stale state of another config (old EF vars etc.)
        shape = tuple(int(d) for d in entry["shape"])
        itemsize = torch.empty((), dtype=getattr(
            torch, entry["dtype"])).element_size()
        old_factors = _coverage_factors(entry, shape)
        old_spec = placements.get(name)
        old_axes = tuple(tuple(s) if s else () for s in (old_spec or ()))
        placement = (executor.state_sharding(prepared, name)
                     if hasattr(executor, "state_sharding") else None)
        new_factors, new_axes = _spec_factors(tuple(placement or ()),
                                              new_world, len(shape))
        nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize \
            if shape else itemsize
        vp = VariablePlan(name, shape, nbytes, old_factors, new_factors)
        vp.steps = schedule_steps(name, shape, itemsize, old_factors,
                                  new_factors, old_axes, new_axes)
        vp.reads, vp.rank_reads = _chunk_reads(entry, shape, itemsize,
                                               placement, mesh)
        plan.variables[name] = vp
    return plan


def validate_schedule(plan: ReshardPlan) -> List[str]:
    """Cross-check every variable's step-priced schedule against the
    closed-form `costs.reshard_wire_bytes` prediction. Returns a list of
    mismatch strings (empty = the schedule balances exactly)."""
    problems = []
    for name, vp in plan.variables.items():
        want = _costs.reshard_wire_bytes(vp.nbytes, vp.old_factors,
                                         vp.new_factors)
        got = vp.wire_bytes
        if got != want:
            problems.append(f"{name}: schedule prices {got} wire bytes, "
                            f"costs.reshard_wire_bytes predicts {want}")
    return problems
