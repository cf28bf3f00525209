"""Auto-parallel planner: cost-model-guided search over the dp x pp x tp
strategy space.

≙ paddle_tpu/framework/auto_parallel.py, whose logic is jax-free and is
kept here as is: it ENUMERATES the joint space (mesh factorization x
reduce mode x quantized wire x bucket size x pipeline schedule /
microbatches x memory plan), PRUNES infeasible points with
`costs.strategy_is_feasible` (the executor / pass gates run statically,
named rejection reasons), SCORES survivors with `costs.predict`
scalarized by `costs.predicted_step_seconds` under a per-device memory
budget (`costs.predicted_device_bytes`), and REFINES the frontier with
simulated annealing over the discrete knobs (the TVM-style
cost-model-guided loop, PAPERS.md).

The prices are the port's: the card's constants (`costs.H100_*`), so the
budget defaults to one H100's 80 GB and the wire divides through NVLink's
rate. With the JAX package's constants set on `costs` the planner
chooses the JAX package's point (tests/test_torch_auto_parallel.py).

`ParallelExecutor` plans behind `BuildStrategy.auto_parallel` (kill switch
PTPU_AUTO_PARALLEL=0): on the first prepare it adopts the chosen strategy
(memory plans included: the executor plans the rewritten program) AND
the mesh factorization of its ranks. An elastic restore onto another
world re-plans through `replan_on_restore`, priced against the one-time
reshard.

The search is DETERMINISTIC for a fixed seed (the annealer is the only
stochastic part and draws from `random.Random(seed)`). An optional
measured refinement (`measure_fn` / `measure_k`) re-ranks the top of the
predicted frontier by real step time.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core.enforce import InvalidArgumentError, enforce
from . import costs as _costs

_DEFAULT_BUCKET = 4 << 20


# ---------------------------------------------------------------------------
# the strategy point: one candidate assignment of every searched knob
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class StrategyPoint:
    """One point of the joint strategy space. Frozen + ordered so points
    are hashable cache keys and ties sort deterministically."""
    dp: int = 1
    pp: int = 1
    tp: int = 1
    microbatches: int = 1
    schedule: str = "1f1b"
    reduce: str = "allreduce"        # allreduce | reduce | reduce_scatter
    quant: str = ""                  # '' | int8 | bf16
    bucket_bytes: int = _DEFAULT_BUCKET
    memory_plan: bool = False
    # host-offload tier (framework/offload.py): '' = device-resident,
    # 'optimizer' = ZeRO-offload the accumulator shards to the pinned
    # host pool between steps. Priced by costs.predict's `offload`
    # section — predicted_step_seconds charges the unhidden PCIe
    # residual, so a point whose round-trip cannot overlap loses here
    # instead of at runtime. Numerics-preserving (the round-trip is
    # bitwise), so executor adoption inherits rather than searches it.
    offload: str = ""                # '' | optimizer

    @property
    def explicit(self) -> bool:
        return self.reduce == "reduce_scatter" or bool(self.quant)

    def canonical(self) -> "StrategyPoint":
        """Zero out knobs that do not change the executed program, so
        equivalent points dedupe to ONE evaluation: microbatches and
        schedule without a pipeline, quant/bucket outside the explicit
        comm path, and the reduce mode on a 1-device data axis (the
        Reduce heuristic and the explicit pipeline are both no-ops
        there — except under tp, whose rewrite runs only in the manual
        modes)."""
        p = self
        if p.pp < 2:
            p = dataclasses.replace(p, microbatches=1, schedule="1f1b")
        if not p.explicit:
            p = dataclasses.replace(p, quant="",
                                    bucket_bytes=_DEFAULT_BUCKET)
        if p.quant and p.reduce == "reduce":
            # under a quantized wire the pipeline is explicit either
            # way and shard_update is keyed on ReduceScatter alone, so
            # reduce+quant executes IDENTICALLY to allreduce+quant
            p = dataclasses.replace(p, reduce="allreduce")
        if p.dp == 1 and p.tp == 1 and p.reduce != "allreduce" \
                and not p.quant:
            p = dataclasses.replace(p, reduce="allreduce",
                                    bucket_bytes=_DEFAULT_BUCKET)
        return p

    def mesh_axes(self) -> Dict[str, int]:
        axes = {"dp": self.dp}
        if self.pp > 1:
            axes["pp"] = self.pp
        if self.tp > 1:
            axes["tp"] = self.tp
        return axes

    def to_build_strategy(self, base=None):
        """The executable BuildStrategy for this point: the searched
        knobs overwrite `base` (a BuildStrategy or None), every
        un-searched field (error feedback, quant block, memory-plan
        budgets, auto_parallel itself) is inherited."""
        from ..parallel.strategy import BuildStrategy, ReduceStrategy
        base = base or BuildStrategy()
        reduce_enum = {"allreduce": ReduceStrategy.AllReduce,
                       "reduce": ReduceStrategy.Reduce,
                       "reduce_scatter": ReduceStrategy.ReduceScatter
                       }[self.reduce]
        return dataclasses.replace(
            base,
            reduce_strategy=reduce_enum,
            quant_comm=self.quant,
            comm_bucket_bytes=int(self.bucket_bytes),
            pipeline_stages=self.pp if self.pp >= 2 else 0,
            num_microbatches=(self.microbatches if self.pp >= 2 else
                              base.num_microbatches),
            pipeline_schedule=self.schedule,
            memory_plan=self.memory_plan,
            offload_optimizer_state=(self.offload == "optimizer"),
        )

    def census_exact(self) -> bool:
        """Whether this point's wire model is structurally EXACT against
        the measured census: the explicit pipeline and plain allreduce
        are; the `reduce` (ZeRO-1) mode's all-gathers are only
        approximately modeled (`spmd_zero1_wire_bytes`)."""
        return self.reduce != "reduce"

    def family(self) -> Tuple:
        """The coarse identity of a point — mesh factorization + comm
        mode. Measured refinement samples the best-predicted point of
        each family so a frontier dominated by near-identical variants
        (bucket sizes, microbatch counts) still measures genuinely
        different strategies."""
        return (self.dp, self.pp, self.tp, self.reduce, self.quant)

    def describe(self) -> str:
        parts = [f"dp{self.dp}"]
        if self.pp > 1:
            parts.append(f"pp{self.pp}({self.schedule},m{self.microbatches})")
        if self.tp > 1:
            parts.append(f"tp{self.tp}")
        parts.append({"allreduce": "ar", "reduce": "zero1",
                      "reduce_scatter": "rs"}[self.reduce])
        if self.quant:
            parts.append(self.quant)
        if self.explicit and self.bucket_bytes != _DEFAULT_BUCKET:
            parts.append(f"b{self.bucket_bytes >> 20}MiB")
        if self.memory_plan:
            parts.append("memplan")
        if self.offload:
            parts.append(f"offl-{self.offload[:3]}")
        return "x".join(parts[:1]) + "-" + "-".join(parts[1:])


@dataclass
class SearchSpace:
    """The discrete option sets the planner enumerates/anneals over.
    The defaults cover every knob the executor exposes; a consumer can
    pin any of them (replan_on_restore pins quant to the saved wire
    dtype so residual error-feedback state stays transferable)."""
    reduce_modes: Tuple[str, ...] = ("allreduce", "reduce",
                                     "reduce_scatter")
    # bf16 wire is not in the default space (the JAX package's choice,
    # kept so both packages search the same space). Pass
    # quant_modes=("", "int8", "bf16") to search it.
    quant_modes: Tuple[str, ...] = ("", "int8")
    schedules: Tuple[str, ...] = ("1f1b", "gpipe")
    microbatches: Tuple[int, ...] = (2, 4, 8)
    bucket_bytes: Tuple[int, ...] = (1 << 20, _DEFAULT_BUCKET, 16 << 20)
    memory_plan: Tuple[bool, ...] = (False, True)
    # '' only by default: offloading optimizer state is a capacity lever
    # the operator pulls (pass offload_modes=("", "optimizer") to search
    # it); the annealer reaches it in one move once it is in the space.
    offload_modes: Tuple[str, ...] = ("",)
    max_pp: int = 8
    max_tp: int = 8


def numerics_preserving_space(strategy_base=None) -> SearchSpace:
    """The search space the EXECUTOR adoption and the elastic re-plan
    use: every knob except the quantized wire dtype, which stays pinned
    to the user's own setting. int8/bf16 gradient compression changes
    the training math (r08 committed the convergence deltas: int8+EF
    max |Δloss| ~0.03), so the planner never flips it on implicitly —
    it remains a searched knob on the tooling surfaces (bench_plan,
    lint --strategy) where the operator asked for the full space."""
    quant = getattr(strategy_base, "quant_comm", "") or ""
    # offload is numerics-preserving but stays PINNED to the user's own
    # setting here too: it is a capacity/latency trade the operator
    # chose, not a knob adoption should silently flip either way
    offload = "optimizer" if getattr(strategy_base,
                                     "offload_optimizer_state", False) \
        else ""
    return SearchSpace(quant_modes=(quant,), offload_modes=(offload,))


def mesh_factorizations(n_devices: int, *, max_pp: int = 8,
                        max_tp: int = 8) -> List[Tuple[int, int, int]]:
    """Every (dp, pp, tp) with dp*pp*tp == n_devices within the pp/tp
    caps, dp-major order (the all-dp point first)."""
    out = []
    for pp in range(1, min(n_devices, max_pp) + 1):
        if n_devices % pp:
            continue
        rest = n_devices // pp
        for tp in range(1, min(rest, max_tp) + 1):
            if rest % tp:
                continue
            out.append((rest // tp, pp, tp))
    return sorted(out, key=lambda f: (-f[0], f[1], f[2]))


# ---------------------------------------------------------------------------
# evaluation: feasibility -> predict -> scalarize, memoized per point
# ---------------------------------------------------------------------------


class _Evaluator:
    """Memoized point evaluation over ONE (program, batch, budget). The
    rewritten programs strategy_is_feasible produces are cached inside
    each row; predict() runs once per canonical point."""

    def __init__(self, program, nominal_batch, hbm_bytes, strategy_base):
        self.program = program
        self.nominal_batch = int(nominal_batch)
        self.hbm_bytes = int(hbm_bytes)
        self.strategy_base = strategy_base
        self.rows: Dict[StrategyPoint, Dict] = {}
        self.rejections: Counter = Counter()

    def evaluate(self, point: StrategyPoint) -> Dict:
        point = point.canonical()
        row = self.rows.get(point)
        if row is not None:
            return row
        strategy = point.to_build_strategy(self.strategy_base)
        axes = point.mesh_axes()
        feas = _costs.strategy_is_feasible(
            self.program, strategy, mesh_axes=axes,
            nominal_batch=self.nominal_batch)
        row = {"point": point, "feasible": feas.ok,
               "reasons": feas.reasons, "strategy": strategy}
        if feas.ok:
            report = _costs.predict(feas.program, strategy,
                                    dp=point.dp, tp=point.tp,
                                    nominal_batch=self.nominal_batch)
            breakdown = _costs.predicted_step_seconds(
                report, mesh_axes=axes, strategy=strategy)
            dev_bytes = _costs.predicted_device_bytes(report)
            row.update({"report": report, "breakdown": breakdown,
                        "predicted_s": breakdown["total_s"],
                        "device_bytes": dev_bytes})
            if dev_bytes > self.hbm_bytes:
                row["feasible"] = False
                row["reasons"] = [{
                    "code": "hbm-budget",
                    "message": (f"predicted per-device footprint "
                                f"{dev_bytes} exceeds the HBM budget "
                                f"{self.hbm_bytes}")}]
            elif point.tp > 1 and not report.get("tp_comm"):
                # the executor WOULD run this (a tp axis nothing shards
                # over is just replication), but a planner that "wins"
                # by idling devices has found a loophole, not a
                # strategy — planner policy, distinct from the
                # executor-gate reasons strategy_is_feasible names
                row["feasible"] = False
                row["reasons"] = [{
                    "code": "tp-unsharded",
                    "message": (f"tp={point.tp} but the rewrite shards "
                                f"nothing over it (no tp_comm model): "
                                f"the axis would run replicated, "
                                f"wasting its devices")}]
        if not row["feasible"]:
            for r in row["reasons"]:
                self.rejections[r["code"]] += 1
        self.rows[point] = row
        return row

    def feasible_rows(self) -> List[Dict]:
        rows = [r for r in self.rows.values() if r["feasible"]]
        # deterministic total order: predicted seconds first, an
        # unplanned point beats a planned one at equal time (the plan
        # costs a rewrite and buys nothing the budget needed), smaller
        # footprint next, the point's own field order last
        return sorted(rows, key=lambda r: (r["predicted_s"],
                                           r["point"].memory_plan,
                                           r["device_bytes"],
                                           r["point"]))


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------


@dataclass
class PlanResult:
    point: StrategyPoint
    strategy: Any
    mesh_axes: Dict[str, int]
    predicted: Dict
    predicted_step_s: float
    breakdown: Dict
    device_bytes: int
    ranking: List[Dict]
    rejections: Dict[str, int]
    n_enumerated: int
    n_feasible: int
    n_annealed: int
    search_s: float
    seed: int
    nominal_batch: int
    measured: bool = False
    measured_step_s: Optional[float] = None

    def rank_of(self, point: StrategyPoint) -> Optional[int]:
        """1-based rank of a point in the predicted frontier (None when
        the point was not evaluated feasible)."""
        point = point.canonical()
        for i, row in enumerate(self.ranking):
            if row["point"] == point:
                return i + 1
        return None

    def summary(self) -> Dict:
        return {
            "chosen": self.point.describe(),
            "mesh_axes": dict(self.mesh_axes),
            "predicted_step_ms": round(self.predicted_step_s * 1e3, 6),
            "breakdown_us": {k: round(v * 1e6, 3)
                             for k, v in self.breakdown.items()
                             if k.endswith("_s")},
            "device_bytes": int(self.device_bytes),
            "n_enumerated": self.n_enumerated,
            "n_feasible": self.n_feasible,
            "n_annealed": self.n_annealed,
            "rejections": dict(self.rejections),
            "search_s": round(self.search_s, 3),
            "seed": self.seed,
            "nominal_batch": self.nominal_batch,
            "measured": self.measured,
            "measured_step_ms": (round(self.measured_step_s * 1e3, 3)
                                 if self.measured_step_s is not None
                                 else None),
            "frontier": [{"point": r["point"].describe(),
                          "predicted_ms":
                              round(r["predicted_s"] * 1e3, 6),
                          **({"measured_ms":
                              round(r["measured_s"] * 1e3, 3)}
                             if r.get("measured_s") is not None else {})}
                         for r in self.ranking[:8]],
        }


def _coarse_points(factors, space: SearchSpace, nominal_batch: int
                   ) -> List[StrategyPoint]:
    """The enumeration grid the annealer refines from: every mesh
    factorization x reduce/quant mode, pipelined points at each
    admissible microbatch count under the default schedule/bucket.
    Deliberately coarse — gpipe, bucket sizes, bf16 wire and the memory
    plan are one annealing move away from any of these."""
    points = []
    # the space's quant set VERBATIM: a numerics-preserving space pins
    # it to the user's wire dtype, and the grid must neither drop the
    # pin nor smuggle unquantized points back in
    quants = list(space.quant_modes) or [""]
    for dp, pp, tp in factors:
        combos = [(mode, q) for mode in space.reduce_modes
                  for q in quants]
        if tp > 1:
            # the tp rewrite runs only under the manual (explicit-comm)
            # modes; SPMD tp is unmodeled, so the planner does not
            # enumerate it
            combos = [c for c in combos if c[0] == "reduce_scatter"
                      or c[1]]
            if not combos:
                continue
        mbs = [1]
        if pp >= 2:
            mbs = [m for m in space.microbatches
                   if nominal_batch % max(dp * m, 1) == 0] or \
                  [max(space.microbatches)]
        for reduce, quant in combos:
            for m in mbs:
                points.append(StrategyPoint(
                    dp=dp, pp=pp, tp=tp, microbatches=m,
                    schedule=space.schedules[0], reduce=reduce,
                    quant=quant,
                    offload=(space.offload_modes or ("",))[0],
                    ).canonical())
    # dedupe preserving order
    seen, out = set(), []
    for p in points:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def _neighbors(point: StrategyPoint, factors, space: SearchSpace
               ) -> List[StrategyPoint]:
    """Every single-knob mutation of `point` inside the space — the
    annealer's move set. Deterministically ordered."""
    out = []
    # re-factor the mesh: any other factorization keeping total devices
    for dp, pp, tp in factors:
        if (dp, pp, tp) != (point.dp, point.pp, point.tp):
            out.append(dataclasses.replace(point, dp=dp, pp=pp, tp=tp))
    if point.pp >= 2:
        for s in space.schedules:
            if s != point.schedule:
                out.append(dataclasses.replace(point, schedule=s))
        for m in space.microbatches:
            if m != point.microbatches:
                out.append(dataclasses.replace(point, microbatches=m))
    for mode in space.reduce_modes:
        if mode != point.reduce:
            out.append(dataclasses.replace(point, reduce=mode))
    if point.explicit:
        for q in space.quant_modes:
            if q != point.quant:
                out.append(dataclasses.replace(point, quant=q))
        for b in space.bucket_bytes:
            if b != point.bucket_bytes:
                out.append(dataclasses.replace(point, bucket_bytes=b))
    for mp in space.memory_plan:
        if mp != point.memory_plan:
            out.append(dataclasses.replace(point, memory_plan=mp))
    for om in space.offload_modes:
        if om != point.offload:
            out.append(dataclasses.replace(point, offload=om))
    return [p.canonical() for p in out]


def plan(program, mesh_shape, *, nominal_batch: int = 8,
         strategy_base=None,
         hbm_bytes: Optional[int] = None,
         space: Optional[SearchSpace] = None,
         anneal_iters: int = 64,
         seed: int = 0,
         measure_fn: Optional[Callable] = None,
         measure_k: int = 0,
         measure_band: float = 0.10,
         speculative: Optional[Dict] = None) -> PlanResult:
    """Choose a BuildStrategy + mesh factorization for `program`.

    `mesh_shape`: an int device count (the planner owns the
    factorization) or a {"dp":, "pp":, "tp":} dict pinning the mesh (the
    planner then searches only the non-mesh knobs). `strategy_base`
    supplies every un-searched BuildStrategy field. `measure_fn(row) ->
    seconds` with `measure_k > 0` re-ranks the top of the predicted
    frontier by measurement (TVM-style; `row` is a frontier entry whose
    "strategy"/"point" fields describe the candidate).

    `speculative` describes a speculative-decoding serving deployment
    ({"gamma":, "acceptance":, ...} — `costs.speculative_expectation`'s
    signature); the expectation is attached to the chosen report's
    `speculative` section. An `acceptance` callable is evaluated HERE —
    the hook that feeds a live engine's measured acceptance rate into
    the plan, the same measured-refinement idea as measure_fn.

    `hbm_bytes` defaults to `costs.H100_HBM_BYTES`, read at the call.

    Returns a PlanResult; raises InvalidArgumentError naming the tallied
    rejection reasons when NO point of the space is feasible."""
    import math
    import random

    if hbm_bytes is None:
        hbm_bytes = _costs.H100_HBM_BYTES

    from ..observability import tracing as _tracing

    t0 = time.perf_counter()
    space = space or SearchSpace()
    if isinstance(mesh_shape, dict):
        axes = dict(mesh_shape)
        factors = [(int(axes.get("dp", 1)), int(axes.get("pp", 1)),
                    int(axes.get("tp", 1)))]
    else:
        n = int(mesh_shape)
        enforce(n >= 1, f"plan() needs a positive device count, got {n}",
                exc=InvalidArgumentError)
        factors = mesh_factorizations(n, max_pp=space.max_pp,
                                      max_tp=space.max_tp)

    n_devices = factors[0][0] * factors[0][1] * factors[0][2]
    ev = _Evaluator(program, nominal_batch, hbm_bytes, strategy_base)
    with _tracing.span("pass", "auto_parallel/plan",
                       devices=n_devices, seed=seed) as sp:
        for p in _coarse_points(factors, space, nominal_batch):
            ev.evaluate(p)
        frontier = ev.feasible_rows()
        enforce(frontier,
                f"auto_parallel.plan: no feasible strategy in the "
                f"search space for this program/mesh — rejections: "
                f"{dict(ev.rejections)}", exc=InvalidArgumentError)

        # simulated-annealing refinement over the discrete knobs:
        # Metropolis on predicted step seconds, geometric temperature
        # decay, deterministic for a fixed seed
        rng = random.Random(seed)
        current = frontier[0]
        n_annealed = 0
        t_scale = max(current["predicted_s"], 1e-9)
        # every evaluation lands in the evaluator's memo, so the
        # post-loop feasible_rows() re-sort IS the best-seen tracking
        for i in range(max(anneal_iters, 0)):
            temp = 0.35 * t_scale * (0.92 ** i)
            moves = _neighbors(current["point"], factors, space)
            cand = ev.evaluate(rng.choice(moves))
            n_annealed += 1
            if not cand["feasible"]:
                continue
            delta = cand["predicted_s"] - current["predicted_s"]
            if delta <= 0 or rng.random() < math.exp(
                    -delta / max(temp, 1e-12)):
                current = cand

        ranking = ev.feasible_rows()
        chosen = ranking[0]
        measured = False
        measured_s = None
        if measure_fn is not None and measure_k > 0:
            # measure the best-predicted representative of the top
            # `measure_k` strategy FAMILIES (mesh x comm mode), not the
            # raw top-k rows — the predicted frontier often packs many
            # near-identical variants of one family
            top, seen_families = [], set()
            for row in ranking:
                fam = row["point"].family()
                if fam in seen_families:
                    continue
                seen_families.add(fam)
                top.append(row)
                if len(top) >= measure_k:
                    break
            for row in top:
                row["measured_s"] = float(measure_fn(row))
            # within the measurement noise band of the fastest point,
            # prefer a strategy whose wire model is census-EXACT (the
            # `reduce` mode is only approximately priced):
            # no measured evidence separates them, and the exact one is
            # the auditable choice
            fastest = min(r["measured_s"] for r in top)
            eligible = [r for r in top
                        if r["measured_s"] <= fastest * (1 + measure_band)]
            exact = [r for r in eligible if r["point"].census_exact()]
            chosen = min(exact or eligible,
                         key=lambda r: (r["measured_s"],
                                        r["predicted_s"],
                                        r["point"]))
            measured = True
            measured_s = chosen["measured_s"]
        sp.attrs["chosen"] = chosen["point"].describe()
        sp.attrs["n_points"] = len(ev.rows)
        if speculative is not None:
            chosen["report"]["speculative"] = \
                _costs.speculative_expectation(**speculative)

    result = PlanResult(
        point=chosen["point"],
        strategy=chosen["strategy"],
        mesh_axes=chosen["point"].mesh_axes(),
        predicted=chosen["report"],
        predicted_step_s=chosen["predicted_s"],
        breakdown=chosen["breakdown"],
        device_bytes=chosen["device_bytes"],
        ranking=[{k: r[k] for k in ("point", "predicted_s",
                                    "device_bytes", "breakdown",
                                    "strategy")}
                 | ({"measured_s": r["measured_s"]}
                    if r.get("measured_s") is not None else {})
                 for r in ranking],
        rejections=dict(ev.rejections),
        n_enumerated=len(ev.rows),
        n_feasible=len(ranking),
        n_annealed=n_annealed,
        search_s=time.perf_counter() - t0,
        seed=seed,
        nominal_batch=int(nominal_batch),
        measured=measured,
        measured_step_s=measured_s,
    )
    return result


# ---------------------------------------------------------------------------
# re-plan on elastic resize
# ---------------------------------------------------------------------------


def _adopt_mesh(executor, axes: Dict[str, int]):
    """Put `executor` on a mesh of its ranks factored as `axes` (cached per
    factorization: a new mesh makes process groups, a collective every
    rank of the world enters)."""
    from ..parallel.mesh import DeviceMesh
    if dict(axes) == dict(executor.mesh.axes):
        return
    meshes = getattr(executor, "_auto_meshes", None)
    if meshes is None:
        meshes = executor._auto_meshes = {}
    key = tuple(sorted(axes.items()))
    mesh = meshes.get(key)
    if mesh is None:
        mesh = meshes[key] = DeviceMesh(list(executor.mesh.ranks),
                                        dict(axes))
    executor.mesh = mesh
    executor._dp = mesh.axis_size("dp")
    executor._pp_transport = None


def replan_on_restore(executor, program, scope, meta, snapshot_dir, *,
                      seed: int = 0,
                      nominal_batch: Optional[int] = None,
                      amortize_horizon: float = 10_000.0) -> Dict:
    """Price keeping the restored strategy against re-planning for the
    NEW world, adopt the winner onto `executor`, and return the decision
    record (restore_train_state's meta["replan"]).

    Pricing: predicted step seconds of each side
    (`costs.predicted_step_seconds`) PLUS each side's one-time restore
    redistribution — `reshard.plan_restore`'s schedule, whose wire bytes
    balance exactly against `costs.reshard_wire_bytes`. The re-plan is
    adopted only when the kept strategy is infeasible on the new world,
    or its per-step gain pays back any extra one-time reshard wire (at
    `costs.H100_NVLINK_BPS`) within `amortize_horizon` steps (the
    break-even rides the record as `amortize_steps`). A "keep" leaves the
    executor as it was. The search pins the quantized wire to the
    executor's config so error-feedback layouts stay transferable.
    Deterministic for a fixed `seed`. Every rank of the executor's world
    calls it (a chosen mesh makes process groups)."""
    from ..parallel import reshard as _reshard
    from ..sharded_checkpoint import ShardedCheckpoint

    t0 = time.perf_counter()
    n_ranks = executor.mesh.num_devices
    base = executor.build_strategy
    batch = int(nominal_batch or max(
        (s[0] for s in (getattr(executor, "_feed_shapes", None) or {})
         .values() if len(s) >= 1), default=8))
    ckpt = ShardedCheckpoint(snapshot_dir)

    def _reshard_wire(prepared) -> Optional[float]:
        try:
            rp = _reshard.plan_restore(ckpt, meta, prepared, executor)
            return float(rp.wire_bytes)
        except Exception:
            return None

    # pricing must not trigger the executor's own prepare-time planner:
    # prepare_program below would otherwise adopt a plan mid-pricing
    executor._auto_plan_suspended = True
    kept_mesh = executor.mesh
    try:
        kept_axes = dict(executor.mesh.axes)
        kept_feas = _costs.strategy_is_feasible(
            program, base, mesh_axes=kept_axes, nominal_batch=batch)
        kept = {"axes": kept_axes, "feasible": kept_feas.ok,
                "reasons": kept_feas.reason_codes(),
                "predicted_step_s": None, "reshard_wire_bytes": None}
        if kept_feas.ok:
            report = _costs.predict(kept_feas.program, base,
                                    dp=kept_axes.get("dp", 1),
                                    tp=kept_axes.get("tp", 1),
                                    nominal_batch=batch)
            kept["predicted_step_s"] = _costs.predicted_step_seconds(
                report, mesh_axes=kept_axes, strategy=base)["total_s"]
            kept["reshard_wire_bytes"] = _reshard_wire(
                executor.prepare_program(program, scope))

        # the RE-PLANNED side: a full search over the new world, quant
        # pinned; its reshard price needs the executor on the chosen
        # config for a moment (reverted below when "keep" wins)
        result = plan(program, n_ranks, nominal_batch=batch,
                      strategy_base=base,
                      space=numerics_preserving_space(base), seed=seed)
        executor.build_strategy = result.strategy
        _adopt_mesh(executor, result.mesh_axes)
        new_wire = _reshard_wire(executor.prepare_program(program, scope))

        kept_s = kept["predicted_step_s"]
        gain = (kept_s - result.predicted_step_s) \
            if kept_s is not None else float("inf")
        amortize_steps = None
        if (new_wire is not None
                and kept["reshard_wire_bytes"] is not None):
            extra_s = max(0.0, new_wire - kept["reshard_wire_bytes"]) \
                / _costs.H100_NVLINK_BPS
            if gain > 0:
                amortize_steps = extra_s / gain
        replanned = (not kept_feas.ok) or (
            gain > 1e-12 and (amortize_steps is None
                              or amortize_steps <= amortize_horizon))
        if not replanned:
            executor.build_strategy = base
            executor.mesh = kept_mesh
            executor._dp = kept_mesh.axis_size("dp")
            executor._pp_transport = None
    finally:
        executor._auto_plan_suspended = False

    summary = {
        "replanned": bool(replanned),
        "kept": {**kept, "strategy": _describe_strategy(base, kept_axes)},
        "chosen": {"point": result.point.describe(),
                   "axes": dict(result.mesh_axes),
                   "predicted_step_s": result.predicted_step_s,
                   "reshard_wire_bytes": new_wire},
        "gain_s_per_step": (None if kept_s is None
                            else kept_s - result.predicted_step_s),
        "amortize_steps": amortize_steps,
        "amortize_horizon": amortize_horizon,
        "plan": result.summary(),
    }
    # the decision above IS this (program, world)'s auto-plan for any
    # batch: the executor's prepare-time planner neither re-searches nor
    # overrides a deliberate "keep" (ParallelExecutor._maybe_auto_plan)
    if hasattr(executor, "_maybe_auto_plan"):
        done = getattr(executor, "_auto_plan_keys", None)
        if done is None:
            done = executor._auto_plan_keys = set()
        done.add((id(program), program._version,
                  executor.mesh.num_devices, None))
        executor._auto_plan = result if replanned else None
        if not getattr(executor, "_auto_orig", None):
            executor._auto_orig = (base, kept_mesh)
        executor._auto_adopted = bool(replanned)
    summary["search_s"] = round(time.perf_counter() - t0, 3)
    return summary


def _describe_strategy(strategy, axes: Dict[str, int]) -> str:
    """A StrategyPoint-shaped description of an arbitrary BuildStrategy
    on a mesh — so kept-vs-chosen reads uniformly in the replan record."""
    from ..parallel.strategy import ReduceStrategy
    reduce = {ReduceStrategy.AllReduce: "allreduce",
              ReduceStrategy.Reduce: "reduce",
              ReduceStrategy.ReduceScatter: "reduce_scatter"}[
        strategy.reduce_strategy]
    return StrategyPoint(
        dp=int(axes.get("dp", 1)), pp=int(axes.get("pp", 1)),
        tp=int(axes.get("tp", 1)),
        microbatches=int(strategy.num_microbatches or 1),
        schedule=strategy.pipeline_schedule,
        reduce=reduce, quant=strategy.quant_comm or "",
        bucket_bytes=int(strategy.comm_bucket_bytes),
        memory_plan=bool(strategy.memory_plan),
        offload=("optimizer" if getattr(strategy, "offload_optimizer_state",
                                        False) else "")
        ).canonical().describe()
