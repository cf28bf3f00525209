"""Static memory planner: liveness-driven op scheduling, interference-graph
buffer coloring, and the remat-vs-stash search.

≙ paddle_tpu/framework/memory_plan.py, the same decisions over the same
Program IR, priced with the port's cost model (framework/costs.py: the
H100's constants and the eager step's host cost, so `search_remat` may
choose other segments than the JAX package does; with the JAX package's
constants and rule set, the planned program's `to_json` is the JAX
package's). What realizes each decision on the card:

- the schedule is the planned block's op order, which `build_plan` runs;
- the slot table (`Variable.buffer_slot`) is realized by the executor's
  release of each transient at its last use (framework/executor.py
  `_release_schedule`, in every plan, planned or not): once a slot's earlier
  var is dropped, PyTorch's caching allocator hands its block to the next
  var of the slot's shape class. XLA's buffer assignment plays that part
  in the JAX package;
- `remat_segments` / `remat_policy` run in `lowering.run_vjp_region` as
  torch.utils.checkpoint segments (selective for `dots_saveable`). Eager
  torch always re-runs them, so `search_remat` prices a recomputed op at
  no less than its host lowering (`costs.op_step_cost`) and holds every
  candidate to the time budget (`RECOMPUTE_ALWAYS_RUNS`); with the JAX
  package's constants, `H100_HOST_OP_S` 0 and that rule off, the plan is
  the JAX package's;
- a pipeline region keeps its op order (the region pins its stages'
  index lists) and gets the per-STAGE remat-vs-stash curve against the
  1F1B stash census (`_pp_stage_decisions`): the engine already runs the
  recompute point (each stage's backward replays its forward from the
  stashed boundary input), so a "keep" verdict is advisory, as in the
  JAX package. So is the stash-to-host candidate.
  ParallelExecutor(BuildStrategy(memory_plan=True)) runs this pass over
  the program as rewritten (tp, dp-comm and pipeline passes first).

It stands on the dataflow analysis (whole-program lifetimes with the
backward-region rule, the interference graph, and the always-on
`buffer-reuse-race`/`buffer-war-race` detectors that make liveness-driven
reuse *verifiable*) and the measured memory census
(`Executor.memory_census()` + the ledger accounting identity that proves
where every byte went). Three cooperating passes over a CLONE of the
program, applied by `memory_plan_pass` (and therefore under the pass
sanitizer, so every apply is proven race- and invariant-free):

1. **Liveness-minimizing scheduling** (`schedule_block`): reorder block
   0's ops within the def-use partial order — greedy list scheduling that
   prefers the ready op freeing the most transient bytes — to shrink the
   static peak-live estimate. The backward-region rule is respected (a
   forward-segment value stays live until its region executes, so moving
   segment ops never "frees" them early); collectives, RNG ops, and
   control-flow binders keep their relative order (the r13
   `collective-order` contract and the seed stream depend on it). Kept
   only when the predicted peak actually improves.

2. **Interference-graph buffer coloring** (`color_buffer_slots`):
   transient vars of one shape class (same resolved shape + dtype) whose
   live intervals are disjoint get one shared `Variable.buffer_slot` id —
   the plan the r13 detectors verify on every sanitized apply (two
   interfering vars in one slot = `buffer-reuse-race` BY NAME). The
   executor's release at last use realizes the sharing (above); the slot
   table is the named prediction of the bytes it gives back.

3. **Remat-vs-stash search** (`search_remat`): Checkmate-style
   segmentation of the `vjp_region` forward — candidate (segment-count,
   checkpoint-policy) plans are priced with the ONE analytic cost model
   (`costs.op_cost_flops_bytes` roofline for the recompute seconds,
   declared-shape liveness for the stash bytes freed), and the best
   predicted peak whose recompute fits the step-time budget wins. The
   chosen plan is EXECUTABLE: `remat_segments` makes
   `lowering.run_vjp_region` run the forward as a chain of per-segment
   checkpointed functions, so the backward recomputes one segment's
   activations at a time instead of stashing all of them.

`plan_report()` emits the whole decision record: the slot table, the
predicted peak before/after, and the remat decision; chip_smoke.py phase
41 prints the measured peaks beside it. Kill switch: PTPU_MEMORY_PLAN=0
(in the executor's plan-cache key).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.dtypes import dtype_name
from ..core.enforce import InvalidArgumentError, enforce
from . import dataflow as _dataflow
from .program import Program
from .registry import lookup_effect_rule

__all__ = [
    "MemoryPlanPass", "color_buffer_slots", "plan_program", "plan_report",
    "schedule_block", "search_remat",
]

#: op types whose outputs a `dots_saveable` checkpoint policy keeps
#: stashed (MXU results — expensive to recompute); everything else is
#: recomputed from the segment boundary during the backward
_DOT_OPS = frozenset({"mul", "matmul", "conv2d", "conv3d",
                      "conv2d_transpose", "conv3d_transpose",
                      "depthwise_conv2d", "dynamic_lstm", "fused_lstm",
                      "dynamic_gru", "fused_gru", "lookup_table"})

#: remat candidates: (segment count, jax.checkpoint policy name or None
#: for full recompute). Segment counts are capped by the region length.
_REMAT_CANDIDATES: Tuple[Tuple[int, Optional[str]], ...] = (
    (2, None), (3, None), (4, None), (6, None), (8, None),
    (2, "dots_saveable"), (4, "dots_saveable"), (8, "dots_saveable"),
)

#: the CSE-able execution mode's candidates: with prevent_cse=False XLA
#: may fold any recompute that would cost wall-clock back into the
#: forward, so the plan is a liveness HINT more than a recompute
#: mandate — measured returns decay past a handful of segments (the
#: boundary overhead and partial CSE eat them; BENCH_MEMPLAN_r18.json
#: carries the curve), so the shallow cuts are the honest candidate set
_REMAT_CANDIDATES_CSEABLE: Tuple[Tuple[int, Optional[str]], ...] = (
    (2, None), (3, None), (4, None),
)

#: torch.utils.checkpoint re-runs a segment's forward whatever
#: `prevent_cse` says: no compiler folds the recompute back into the
#: forward as XLA may under prevent_cse=False. So every remat candidate
#: is held to the time budget, priced at `costs.op_step_cost`. False
#: gives the JAX package's rule (only prevent_cse=True candidates are
#: held), for a comparison under its constants.
RECOMPUTE_ALWAYS_RUNS = True


# the ONE declared-shape pricing rule, shared with peak_live_bytes
_var_bytes = _dataflow.declared_var_bytes


def _transient(block, name: str) -> bool:
    v = block.vars.get(name)
    return v is not None and not v.persistable and not v.is_data


# ---------------------------------------------------------------------------
# 1. liveness-minimizing scheduling
# ---------------------------------------------------------------------------


def _ordered_chain_member(block, op) -> bool:
    """Ops whose RELATIVE order the scheduler must not change: collectives
    (the r13 collective-order contract — a reordered pp_send/dp_grad_comm
    is a static deadlock on some shard), RNG draws (the seed stream folds
    per execution order), control-flow / TensorArray binders (their
    sub-block environment is stateful), and region ops themselves."""
    from .analysis import _SUB_KEYS, INFER_WAIVED
    if op.type in INFER_WAIVED or op.type in _dataflow.REGION_OPS:
        return True
    if any(k in op.attrs for k in _SUB_KEYS):
        return True
    rule = lookup_effect_rule(op.type)
    if rule is None:
        return False
    eff = _dataflow.op_effects(op)
    return bool(eff.collective_axes or eff.rng)


def _constraint_graph(block):
    """(succ, pred) adjacency over op indices: RAW/WAR/WAW name
    dependencies, the ordered-chain edges, and the region containment
    edges (every forward-segment op precedes its region op; segment ops
    keep their relative order — the region runner replays them in index
    order)."""
    n = len(block.ops)
    succ: List[Set[int]] = [set() for _ in range(n)]
    pred: List[Set[int]] = [set() for _ in range(n)]

    def edge(a: int, b: int):
        if a != b and b not in succ[a]:
            succ[a].add(b)
            pred[b].add(a)

    last_writer: Dict[str, int] = {}
    readers_since: Dict[str, List[int]] = {}
    chain_prev = None
    for i, op in enumerate(block.ops):
        for nm in op.input_names():
            if nm in last_writer:
                edge(last_writer[nm], i)
            readers_since.setdefault(nm, []).append(i)
        for nm in op.output_names():
            if nm in last_writer:
                edge(last_writer[nm], i)          # WAW: writer order
            for r in readers_since.get(nm, ()):
                edge(r, i)                        # WAR: readers first
            last_writer[nm] = i
            readers_since[nm] = []
        if _ordered_chain_member(block, op):
            if chain_prev is not None:
                edge(chain_prev, i)
            chain_prev = i
    for ridx, op in enumerate(block.ops):
        if op.type not in _dataflow.REGION_OPS:
            continue
        seg = [i for i in op.attrs.get("fwd_ops", ())
               if isinstance(i, (int, np.integer)) and 0 <= i < n]
        for a, b in zip(seg, seg[1:]):
            edge(a, b)                            # keep segment order
        for i in seg:
            edge(i, ridx)                         # segment before region
    return succ, pred


def schedule_block(block, nominal_batch: int = 8) -> Optional[List[int]]:
    """A liveness-minimizing valid topological order of `block`'s ops
    (old indices in new execution order), or None when the block is not
    schedulable (a pipeline region pins its stage index lists to the
    partitioner's order). Greedy list scheduling: among ready ops, pick
    the one with the best freed-minus-allocated transient bytes; ties
    break on the original index, so an already-optimal program comes
    back unchanged."""
    n = len(block.ops)
    if n <= 2 or any(op.type == "pp_pipeline_region" for op in block.ops):
        return None
    succ, pred = _constraint_graph(block)

    # remaining-reader counts, with every region op counted as a reader
    # of everything its forward segment touches (the backward-region
    # rule: those values are backward inputs, so scheduling can never
    # free them before the region)
    remaining: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for nm in op.input_names():
            remaining[nm] = remaining.get(nm, 0) + 1
        if op.type in _dataflow.REGION_OPS:
            for j in op.attrs.get("fwd_ops", ()):
                if isinstance(j, (int, np.integer)) and 0 <= j < n:
                    fop = block.ops[j]
                    for nm in set(fop.output_names() + fop.input_names()):
                        remaining[nm] = remaining.get(nm, 0) + 1

    sizes = {nm: (_var_bytes(block, nm, nominal_batch)
                  if _transient(block, nm) else 0)
             for op in block.ops
             for nm in op.input_names() + op.output_names()}

    def score(i: int) -> Tuple[int, int]:
        op = block.ops[i]
        alloc = sum(sizes.get(nm, 0) for nm in set(op.output_names()))
        freed = sum(sizes.get(nm, 0) for nm in set(op.input_names())
                    if remaining.get(nm, 0) == 1)
        return (alloc - freed, i)

    indeg = [len(p) for p in pred]
    ready = sorted(i for i in range(n) if indeg[i] == 0)
    order: List[int] = []
    while ready:
        i = min(ready, key=score)
        ready.remove(i)
        order.append(i)
        op = block.ops[i]
        for nm in op.input_names():
            if nm in remaining:
                remaining[nm] -= 1
        if op.type in _dataflow.REGION_OPS:
            for j in op.attrs.get("fwd_ops", ()):
                if isinstance(j, (int, np.integer)) and 0 <= j < n:
                    fop = block.ops[j]
                    for nm in set(fop.output_names() + fop.input_names()):
                        if nm in remaining:
                            remaining[nm] -= 1
        for j in succ[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
    enforce(len(order) == n,
            f"memory_plan scheduler produced a partial order "
            f"({len(order)}/{n} ops) — cyclic constraint graph?",
            exc=InvalidArgumentError)
    return order if order != list(range(n)) else None


def _apply_order(block, order: List[int]):
    """Reorder block.ops to `order` (old indices in new positions) and
    remap every region op's recorded fwd_ops indices."""
    remap = {old: new for new, old in enumerate(order)}
    block.ops = [block.ops[i] for i in order]
    for op in block.ops:
        if op.type in _dataflow.REGION_OPS:
            op.attrs["fwd_ops"] = sorted(
                remap[i] for i in op.attrs.get("fwd_ops", ())
                if isinstance(i, (int, np.integer)) and i in remap)
    block.program._bump()


# ---------------------------------------------------------------------------
# 2. interference-graph buffer coloring
# ---------------------------------------------------------------------------


def color_buffer_slots(block, protected: Sequence[str] = (),
                       nominal_batch: int = 8) -> List[Dict]:
    """Assign shared `Variable.buffer_slot` ids to compatible transient
    vars: one shape class (resolved shape + dtype), strictly disjoint
    live intervals (greedy interval coloring). Only colors with >= 2
    members are materialized — a slot table row per shared buffer, each
    one a named prediction of bytes XLA's assignment gives back. The r13
    `buffer-reuse-race` detector is the soundness proof: the pass
    sanitizer re-verifies the whole program after the pass, so a
    mis-colored pair fails the apply BY NAME instead of racing at
    runtime."""
    lifetimes = _dataflow.var_lifetimes(block)
    writers: Dict[str, int] = {}
    for op in block.ops:
        for nm in op.output_names():
            writers[nm] = writers.get(nm, 0) + 1
    skip = set(protected)
    classes: Dict[Tuple, List[Tuple[int, int, str]]] = {}
    for name, (s, e) in lifetimes.items():
        v = block.vars.get(name)
        if (v is None or v.persistable or v.is_data or v.shape is None
                or name in skip or writers.get(name, 0) != 1
                or getattr(v, "buffer_slot", None) is not None):
            continue
        key = (tuple(v.shape), dtype_name(v.dtype))
        classes.setdefault(key, []).append((s, e, name))

    table: List[Dict] = []
    for key, items in sorted(classes.items(), key=lambda kv: repr(kv[0])):
        if len(items) < 2:
            continue
        items.sort()
        colors: List[Dict] = []     # {end, members}
        for s, e, name in items:
            placed = None
            for c in colors:
                if c["end"] < s:     # STRICT: the detector's WAR boundary
                    placed = c       # case (write at the last read) needs
                    break            # a serializing copy we don't emit
            if placed is None:
                placed = {"end": e, "members": []}
                colors.append(placed)
            placed["end"] = e
            placed["members"].append(name)
        shape, dtype = key
        for k, c in enumerate(colors):
            if len(c["members"]) < 2:
                continue
            # block-scoped id: an identical shape class in two blocks must
            # NOT form one cross-block slot group (the r18 cross-binder
            # detector rightly flags a sub-block var sharing a slot with
            # a parent var live across its binder)
            slot = (f"b{block.idx}:{dtype}:"
                    + "x".join(str(d) for d in shape) + f"#{k}")
            for name in c["members"]:
                block.vars[name].buffer_slot = slot
            table.append({
                "slot": slot,
                "block": block.idx,
                "vars": list(c["members"]),
                "bytes": _var_bytes(block, c["members"][0], nominal_batch),
                "reuses": len(c["members"]) - 1,
            })
    if table:
        block.program._bump()
    return table


# ---------------------------------------------------------------------------
# 3. remat-vs-stash search
# ---------------------------------------------------------------------------


def _region_live_out(block, ridx: int, seg: Sequence[int],
                     protected: Set[str]) -> Set[str]:
    """Names the region must keep publishing: read by any op outside the
    consumed forward segment at/after the region's execution point,
    persistable values written inside the segment (moving BN stats), and
    the caller's protected set (fetch targets the planner can see).
    The sibling of transpiler.memory_optimization._liveness_after_region
    — run-time fetch names are ADDED by the region runner, so a fetch the
    planner never saw still comes out of its segment."""
    consumed = set(seg)
    live: Set[str] = set(protected)
    for j, op in enumerate(block.ops):
        if j == ridx or j in consumed:
            continue
        if j > min(seg):
            live |= set(op.input_names())
    for j in seg:
        for name in block.ops[j].output_names():
            v = block.vars.get(name)
            if v is not None and getattr(v, "persistable", False):
                live.add(name)
    return live


def _candidate_cuts(costs: List[float], k: int) -> List[Tuple[int, int]]:
    from .passes import _balanced_partition
    return _balanced_partition(costs, k)


def search_remat(block, region_op, *, nominal_batch: int = 8,
                 protected: Sequence[str] = (),
                 time_budget_s: Optional[float] = None,
                 time_budget_frac: float = 0.02,
                 prevent_cse: bool = False,
                 stash_to_host: bool = False) -> Dict:
    """Search the remat-vs-stash curve of ONE vjp_region and apply the
    winner. Candidates: `_REMAT_CANDIDATES` (segment count x checkpoint
    policy) plus "stash" (no remat — keep every activation, the status
    quo). Each candidate is priced with the analytic model:

      stash_freed  declared-shape bytes of segment-internal values that
                   stop being carried to the backward (non-boundary,
                   non-published; under `dots_saveable` the MXU outputs
                   stay stashed and only the cheap-to-recompute rest is
                   freed)
      extra_s      seconds of the recomputed forward ops at
                   `costs.op_step_cost` (the roofline, never less than
                   one eager lowering's host time; full segment for the
                   default policy, the non-dot subset under
                   `dots_saveable`)

    With `stash_to_host` a THIRD candidate class competes (
    BuildStrategy.memory_plan_stash_to_host): keep every activation but
    park the stash in the pinned host pool (framework/offload.py),
    priced on the PCIe roofline (`costs.H100_PCIE_BPS`) — freed bytes are
    the whole stash minus a two-deep resident window (the in-flight d2h
    at the forward edge plus the h2d restore beside its backward
    consumer), and the round-trip must hide inside ~3x the forward's
    roofline (forward + ~2x backward = the overlap window). Unlike the
    CSE-able recompute bound, the PCIe transfer is real wire, so the
    window ALWAYS gates this candidate.

    The best stash_freed whose extra_s fits the budget wins; the budget
    is `time_budget_s` when the caller measured a real step and
    `time_budget_frac` x the program's step otherwise: its roofline,
    and no less than one host lowering an op. Every candidate is held to it (`RECOMPUTE_ALWAYS_RUNS`). Returns
    the decision record (chosen plan + every candidate's prediction);
    sets `remat_segments`/`remat_policy`/`live_out` on the region op when
    a remat plan wins, `stash_to_host`/`live_out` when the host stash
    wins (ADVISORY on this backend: jit consumes the whole stash at
    dispatch, so the streamed per-value round-trip is priced and
    recorded — the same discipline as the planner's pp stage decisions —
    while the TPU lowering through the shared transfer stream remains
    ROADMAP item 5(a); the record says so via `executed`)."""
    from .costs import op_cost_flops_bytes, op_step_cost, op_time_cost
    from .lowering import remat_boundaries

    ridx = block.ops.index(region_op)
    seg = [i for i in region_op.attrs.get("fwd_ops", ())
           if isinstance(i, (int, np.integer)) and 0 <= i < len(block.ops)]
    record: Dict = {"region": ridx, "chosen": "stash", "segments": 0,
                    "policy": None, "stash_freed_bytes": 0,
                    "extra_seconds_bound": 0.0, "candidates": []}
    if len(seg) < 4:
        record["skipped"] = "region too short to segment"
        return record
    if any(block.ops[i].type == "lookup_table"
           and block.ops[i].attrs.get("is_sparse") for i in seg):
        record["skipped"] = ("sparse embedding lookups need the "
                            "un-segmented trace (selected-rows grads)")
        return record
    coll = sorted({block.ops[i].type for i in seg
                   if _dataflow.op_effects(block.ops[i]).collective_axes})
    if coll:
        # recomputing a checkpointed segment re-issues every collective
        # inside it (a tp_allreduce replayed in the backward is real
        # extra wire the compute-only cost model cannot price) —
        # measured on the tp2 bench cell as a net regression, so
        # collective-bearing forwards keep the stash
        record["skipped"] = (f"forward segment issues collectives "
                             f"({coll[:4]}): recompute would re-issue "
                             f"them on the wire")
        return record

    live_out = _region_live_out(block, ridx, seg, set(protected))
    live_out.add(region_op.attrs["loss"])
    out_need = (live_out & {n for i in seg
                            for n in block.ops[i].output_names()}) \
        | {region_op.attrs["loss"]}

    # the cuts balance the segments' device work (the roofline, as in the
    # JAX package); what a recompute costs the step is priced at
    # `op_step_cost`
    fb = [op_cost_flops_bytes(block.ops[i], block, nominal_batch)
          for i in seg]
    roof_costs = [op_time_cost(*x) for x in fb]
    op_costs = [op_step_cost(*x) for x in fb]
    total_s = sum(op_costs)
    if time_budget_s is None:
        # step reference: forward + backward + update at the roofline,
        # and no less than the host's lowering of each op (the eager
        # step's floor; 0 with the JAX package's pricing). Callers that
        # measured a step pass it.
        from .costs import H100_HOST_OP_S, program_flops_bytes
        fb = program_flops_bytes(block.program, nominal_batch)
        step_s = max(fb["roofline_s"], fb["n_ops"] * H100_HOST_OP_S)
        time_budget_s = time_budget_frac * max(step_s, 1e-12)
    record["time_budget_s"] = time_budget_s

    # the stash the un-segmented region carries to the backward: every
    # transient the segment produces and does not publish
    stash_vars = [
        (nm, _var_bytes(block, nm, nominal_batch))
        for i in seg for nm in set(block.ops[i].output_names())
        if _transient(block, nm) and nm not in out_need]
    stash_total = sum(b for _, b in stash_vars)
    cost_at = {i: c for i, c in zip(seg, op_costs)}

    best = None
    candidates = (_REMAT_CANDIDATES if prevent_cse
                  else _REMAT_CANDIDATES_CSEABLE)
    record["prevent_cse"] = bool(prevent_cse)
    for k, policy in candidates:
        if k > len(seg):
            continue
        bounds = _candidate_cuts(roof_costs, k)
        seg_lists = [seg[a:b] for a, b in bounds]
        boundaries = remat_boundaries(
            [[block.ops[i] for i in lst] for lst in seg_lists], out_need)
        carried = set().union(*[set(b) for b in boundaries])
        freed = 0
        extra = 0.0
        internal = []               # per-segment recompute working set
        for lst in seg_lists:
            seg_internal = 0
            for i in lst:
                op = block.ops[i]
                if policy == "dots_saveable" and op.type in _DOT_OPS:
                    continue        # stays stashed, never recomputed
                extra += cost_at[i]
                for nm in set(op.output_names()):
                    if nm in carried or not _transient(block, nm):
                        continue
                    nb = _var_bytes(block, nm, nominal_batch)
                    freed += nb
                    seg_internal += nb
            internal.append(seg_internal)
        # predicted stash after segmentation: what stays carried to the
        # backward (stash_total minus the freed internals — boundary
        # values stay counted once, inside stash_total) plus the LARGEST
        # segment's internals twice over, for its recompute + backward
        # window (value + cotangent)
        predicted_stash = (stash_total - freed) \
            + 2 * max(internal, default=0)
        # the recompute always runs here (RECOMPUTE_ALWAYS_RUNS), so the
        # budget gates every candidate; under the JAX package's rule
        # prevent_cse=False makes it advisory (XLA folds back whatever
        # would cost wall-clock) and the budget never rejects
        cand = {"segments": k, "policy": policy,
                "stash_freed_bytes": int(freed),
                "predicted_stash_bytes": int(predicted_stash),
                "extra_seconds_bound": float(extra),
                "boundary_vars": [len(b) for b in boundaries],
                "fits_budget": (extra <= time_budget_s
                                if prevent_cse or RECOMPUTE_ALWAYS_RUNS
                                else True)}
        record["candidates"].append(cand)
        if cand["fits_budget"] and predicted_stash < stash_total and (
                best is None
                or predicted_stash < best["predicted_stash_bytes"]):
            best = dict(cand, seg_lists=seg_lists)
    if stash_to_host and stash_total > 0:
        from .costs import H100_PCIE_BPS
        biggest = max((b for _, b in stash_vars), default=0)
        resident = min(stash_total, 2 * biggest)
        transfer_s = 2.0 * stash_total / H100_PCIE_BPS
        window = 3.0 * total_s
        cand = {"segments": 0, "policy": "stash_to_host",
                "stash_freed_bytes": int(stash_total - resident),
                "predicted_stash_bytes": int(resident),
                "extra_seconds_bound": float(max(0.0,
                                                 transfer_s - window)),
                "pcie_transfer_s": float(transfer_s),
                "overlap_window_s": float(window),
                "fits_budget": transfer_s <= window}
        record["candidates"].append(cand)
        if cand["fits_budget"] and resident < stash_total and (
                best is None
                or resident < best["predicted_stash_bytes"]):
            best = dict(cand, seg_lists=None)
    record["stash_bytes_unsegmented"] = int(stash_total)
    if best is None or best["stash_freed_bytes"] <= 0:
        return record

    if best["policy"] == "stash_to_host":
        region_op.attrs["stash_to_host"] = True
        region_op.attrs["live_out"] = sorted(live_out)
        block.program._bump()
        record.update(chosen="stash_to_host", segments=0,
                      policy="stash_to_host",
                      stash_freed_bytes=best["stash_freed_bytes"],
                      predicted_stash_bytes=best["predicted_stash_bytes"],
                      extra_seconds_bound=best["extra_seconds_bound"],
                      executed="advisory")
        return record

    region_op.attrs["remat_segments"] = [list(lst)
                                         for lst in best["seg_lists"]]
    if best["policy"]:
        region_op.attrs["remat_policy"] = best["policy"]
    else:
        region_op.attrs.pop("remat_policy", None)
    region_op.attrs["remat_prevent_cse"] = bool(prevent_cse)
    region_op.attrs["live_out"] = sorted(live_out)
    block.program._bump()
    record.update(chosen="remat", segments=best["segments"],
                  policy=best["policy"],
                  stash_freed_bytes=best["stash_freed_bytes"],
                  predicted_stash_bytes=best["predicted_stash_bytes"],
                  extra_seconds_bound=best["extra_seconds_bound"])
    return record


def _pp_stage_decisions(program, region_op, *, nominal_batch: int = 8,
                        time_budget_s: Optional[float] = None,
                        time_budget_frac: float = 0.02) -> List[Dict]:
    """The per-STAGE remat-vs-stash curve of a pipeline region. The 1F1B
    engine already executes the "recompute" point (stage-granular
    checkpointing: the backward replays the stage forward from the
    stashed boundary input — parallel/pipeline.py run_pp_region); this
    search prices the alternative per stage: KEEPING the stage's
    activations for every in-flight microbatch costs
    act_stash_depth x stage activation bytes, recomputing costs
    M x stage-forward roofline seconds per step. The report names the
    winner at the budget; a "keep" verdict is advisory (the engine's
    executed point stays recompute — flagged so the gap is explicit).
    Priced on the card's constants, a replayed op at no less than one
    eager lowering (`costs.op_step_cost`), as `search_remat` prices
    recompute."""
    from ..parallel.pipeline import schedule_census
    from .costs import op_cost_flops_bytes, op_step_cost, \
        program_flops_bytes

    block = program.global_block()
    m = int(region_op.attrs["num_microbatches"])
    k = int(region_op.attrs["num_stages"])
    sched = schedule_census(region_op.attrs["schedule"], m, k)
    if time_budget_s is None:
        step_s = program_flops_bytes(program, nominal_batch)["roofline_s"]
        time_budget_s = time_budget_frac * max(step_s, 1e-12)
    mb_rows = max(1, nominal_batch // m)
    decisions = []
    for si, idxs in enumerate(region_op.attrs["stages"]):
        ops = [block.ops[i] for i in idxs if isinstance(i, (int,
                                                           np.integer))]
        fwd_s = sum(op_step_cost(*op_cost_flops_bytes(op, block, mb_rows))
                    for op in ops)
        act_bytes = sum(_var_bytes(block, nm, mb_rows)
                        for op in ops for nm in set(op.output_names())
                        if _transient(block, nm))
        depth = int(sched["peak_stash_per_stage"][si]) or 1
        recompute_s = fwd_s * m      # one replay per microbatch backward
        keep_bytes = act_bytes * depth
        chosen = "recompute" if recompute_s <= time_budget_s or \
            keep_bytes == 0 else "keep"
        decisions.append({
            "stage": si, "executed": "recompute", "chosen": chosen,
            "advisory": chosen != "recompute",
            "keep_stash_bytes": int(keep_bytes),
            "recompute_extra_seconds": float(recompute_s),
            "stash_depth": depth,
        })
    return decisions


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

#: program markers the planner's clone must carry forward — the executor's
#: placement/gate logic and the cost models read them off the FINAL program
_RIDE_MARKERS = ("_dp_comm_applied", "_pp_applied", "_pp_hidden",
                 "_pp_microbatches", "_pp_stages")


def plan_program(program: Program, *, protected: Sequence[str] = (),
                 nominal_batch: int = 8,
                 time_budget_s: Optional[float] = None,
                 time_budget_frac: float = 0.02,
                 schedule: bool = True, color: bool = True,
                 remat: bool = True,
                 remat_prevent_cse: bool = False,
                 stash_to_host: bool = False) -> Program:
    """Apply the full static memory plan to a CLONE of `program` (the
    caller's program is never mutated): scheduling, coloring, and the
    remat-vs-stash search, in that order. Idempotent (`
    _memory_plan_applied` marker); the decision record lands on the
    planned program as `_memory_plan_report` (see `plan_report`)."""
    if getattr(program, "_memory_plan_applied", False):
        return program
    from .analysis import peak_live_bytes
    out = program.clone()
    for marker in _RIDE_MARKERS:
        if hasattr(program, marker):
            setattr(out, marker, getattr(program, marker))
    block = out.global_block()
    before = peak_live_bytes(out, nominal_batch=nominal_batch)
    report: Dict = {
        "nominal_batch": nominal_batch,
        "predicted_peak_before": int(before["peak_transient_bytes"]),
        "schedule": {"reordered": False, "moved_ops": 0},
        "slots": [], "remat": None, "pp_stages": None,
    }

    if schedule:
        order = schedule_block(block, nominal_batch=nominal_batch)
        if order is not None:
            trial = peak_live_bytes  # evaluated on the mutated clone
            _apply_order(block, order)
            after_sched = trial(out, nominal_batch=nominal_batch)
            if after_sched["peak_transient_bytes"] \
                    < before["peak_transient_bytes"]:
                report["schedule"] = {
                    "reordered": True,
                    "moved_ops": sum(1 for new, old in enumerate(order)
                                     if new != old),
                    "predicted_peak": int(
                        after_sched["peak_transient_bytes"]),
                }
            else:
                # scheduling must never regress the estimate: restore
                inverse = [0] * len(order)
                for new, old in enumerate(order):
                    inverse[old] = new
                _apply_order(block, inverse)

    remat_records: List[Dict] = []
    if remat:
        for op in list(block.ops):
            if op.type == "vjp_region":
                remat_records.append(search_remat(
                    block, op, nominal_batch=nominal_batch,
                    protected=protected, time_budget_s=time_budget_s,
                    time_budget_frac=time_budget_frac,
                    prevent_cse=remat_prevent_cse,
                    stash_to_host=stash_to_host))
            elif op.type == "pp_pipeline_region":
                # exactly one per block (the partition pass enforces it)
                report["pp_stages"] = _pp_stage_decisions(
                    out, op, nominal_batch=nominal_batch,
                    time_budget_s=time_budget_s,
                    time_budget_frac=time_budget_frac)
        # the common single-region shape stays flat; multi-loss programs
        # (two vjp_regions over one trunk) report every region's decision
        report["remat"] = (remat_records[0] if len(remat_records) == 1
                          else None)
        if len(remat_records) > 1:
            report["remat_regions"] = remat_records

    if color:
        for b in out.blocks:
            report["slots"] += color_buffer_slots(
                b, protected=protected, nominal_batch=nominal_batch)

    after = peak_live_bytes(out, nominal_batch=nominal_batch)
    remat_saved = sum(
        max(0, rm.get("stash_bytes_unsegmented", 0)
            - rm.get("predicted_stash_bytes", 0))
        for rm in remat_records if rm.get("chosen") == "remat")
    # a winning stash-to-host decision is ADVISORY on this backend (see
    # search_remat): its freed bytes ride in a NAMED key instead of the
    # executed predicted_peak_after, so the prediction never claims a
    # reduction the runtime does not deliver
    host_stash_freed = sum(
        rm.get("stash_freed_bytes", 0) for rm in remat_records
        if rm.get("chosen") == "stash_to_host")
    if host_stash_freed:
        report["stash_to_host_freed_bytes"] = int(host_stash_freed)
    # slots are deliberately NOT subtracted here: coloring only pairs
    # strictly-disjoint lifetimes, which the max-live walk already never
    # counts together — the slot table names bytes XLA's assignment can
    # alias, not a further cut to this estimate
    report["predicted_peak_after"] = max(
        0, int(after["peak_transient_bytes"]) - remat_saved)
    report["predicted_reduction_bytes"] = (
        report["predicted_peak_before"] - report["predicted_peak_after"])
    report["n_slots"] = len(report["slots"])
    report["shared_vars"] = sum(len(r["vars"]) for r in report["slots"])
    out._memory_plan_applied = True
    out._memory_plan_report = report
    out._bump()
    return out


def plan_report(program: Program) -> Dict:
    """The decision record of a planned program: slot table, predicted
    peak before/after, remat-vs-stash choice (and the rejected
    candidates, each with its predicted bytes/seconds), per-stage
    pipeline decisions. Raises on an unplanned program — run
    memory_plan_pass (or plan_program) first."""
    enforce(getattr(program, "_memory_plan_applied", False),
            "plan_report: program carries no memory plan — apply "
            "memory_plan_pass first", exc=InvalidArgumentError)
    return dict(program._memory_plan_report)


from .passes import Pass, register_pass  # noqa: E402


@register_pass("memory_plan_pass")
class MemoryPlanPass(Pass):
    """The registered form of `plan_program` — running it through
    Pass.__call__ puts every apply under the pass sanitizer, so the r13
    buffer-reuse/WAR detectors re-verify the colored program and any
    violation is attributed to this pass BY NAME. attrs: protected
    (names the plan must keep addressable — fetch targets), nominal_batch,
    time_budget_s / time_budget_frac (the remat search's step-time
    budget), schedule / color / remat (per-pass toggles, default on)."""

    allowed_attrs = ("protected", "nominal_batch", "time_budget_s",
                     "time_budget_frac", "schedule", "color", "remat",
                     "remat_prevent_cse", "stash_to_host")

    def apply(self, program, scope=None):
        return plan_program(
            program,
            protected=self.attrs.get("protected", ()),
            nominal_batch=int(self.attrs.get("nominal_batch", 8)),
            time_budget_s=self.attrs.get("time_budget_s"),
            time_budget_frac=float(self.attrs.get("time_budget_frac",
                                                  0.02)),
            schedule=bool(self.attrs.get("schedule", True)),
            color=bool(self.attrs.get("color", True)),
            remat=bool(self.attrs.get("remat", True)),
            remat_prevent_cse=bool(self.attrs.get("remat_prevent_cse",
                                                  False)),
            stash_to_host=bool(self.attrs.get("stash_to_host", False)))
