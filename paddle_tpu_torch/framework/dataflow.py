"""≙ paddle_tpu/framework/dataflow.py, line for line (pure Python over the
Program IR); a var's bytes are its declared dtype's width, as there.

Dataflow analysis over the Program IR.

The machinery layer under the whole-program SPMD detectors in
`framework/analysis.py` — and the liveness/interference foundation the
memory planner (framework/memory_plan.py) schedules against. Four pieces:

1. **Effect sets** (`op_effects`): per-op read/write/in-place buffer
   effects plus the semantics the slot lists cannot express — which mesh
   axes the op communicates over (`collective_axes`), whether a collective
   makes its outputs axis-consistent (`resolves_axes`) or deliberately
   axis-varying (`shards_axes`), and whether the op draws per-step
   randomness (`rng`). Rules register per-op via
   `registry.register_effects` — the same side-table contract as
   `register_infer_spec`/`register_shard_spec`, one layer up.

2. **Def-use chains** (`def_use_chains`) and **variable lifetimes /
   interference** (`var_lifetimes`, `interference_graph`): a transient var
   is live from its first writer to its last reader; backward regions
   (`vjp_region`/`pp_pipeline_region`) re-run their forward segment under
   autograd, so every value the segment touches stays live until the region
   executes. Two vars interfere when their live intervals overlap — the
   exact relation a liveness-driven buffer-reuse plan must respect.

3. **A generic forward taint/lattice engine** (`propagate`, `Taint`):
   walks blocks in op order propagating per-var taint sets; the default
   transfer is the union of input taints filtered through the op's effect
   set (collectives that `resolves_axes` drop those axes' taints,
   `shards_axes` ops add fresh shard taints), with per-analysis seed and
   transfer hooks for everything else.

4. **The three whole-program detectors** (`dataflow_checks`), folded into
   `analysis.verify_program` and therefore into the always-on pass
   sanitizer (≙ the role the reference's multi_devices_check_pass + the
   HLO verifier play between passes):
   - SPMD collective consistency / static deadlock (`collective-*`),
   - replica divergence (`replica-divergence`) — GSPMD-style "diverges
     over axis X" propagation from RNG ops and shard-local partials into
     replication-requiring sinks,
   - buffer-reuse / WAR race checks (`buffer-*`) over the interference
     graph — the safety gate that makes liveness-driven buffer reuse
     plannable.

docs/static_analysis.md carries the diagnostic catalog and the effect-set
registration guide.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, FrozenSet, List, Optional, Set,
                    Tuple)

from .analysis import _SUB_KEYS, Diagnostic, op_loc
from .program import Block, Operator, Program
from .registry import lookup_effect_rule

__all__ = [
    "CACHE_WRITE_OPS", "DefUse", "Effects", "Taint",
    "cache_write_aliasing", "dataflow_checks", "def_use_chains",
    "divergence_taints", "interference_graph", "op_effects", "propagate",
    "var_lifetimes",
]

# Backward regions: engine-interpreted ops that re-run a recorded forward
# segment under autograd (framework/lowering.py REGION_RUNNERS).
REGION_OPS = ("vjp_region", "pp_pipeline_region")

# Canonical mesh-axis constants (parallel/mesh.py DATA_AXIS/MODEL_AXIS/
# PIPELINE_AXIS — duplicated literals because framework/ must not import
# parallel/; tests/test_dataflow.py pins the two in sync).
DP_AXIS, TP_AXIS, PP_AXIS = "dp", "tp", "pp"


# ---------------------------------------------------------------------------
# effect sets
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Effects:
    """What one op does to buffers and mesh axes.

    reads/writes: var names, derived from the op's input/output slots.
    inplace: (read_name, write_name) aliased-buffer pairs — same-name
        read+write (ordered in-place updates like increment(in_place=True))
        plus any pairs a registered rule adds.
    collective_axes: mesh axes the op communicates over. A collective both
        ORDERS execution across the shards of those axes (all shards must
        reach it, in the same sequence — else static deadlock) and makes
        its outputs a function of every shard's inputs.
    resolves_axes: axes whose divergence the outputs no longer carry (a
        psum/all-gather result is identical on every shard of that axis,
        whatever went in).
    shards_axes: axes over which the outputs deliberately VARY per shard
        (a slice of a replicated value, a local shard of an update).
    rng: the op draws per-step randomness. The manual-mode executor
        decorrelates seeds across dp shards (tp shards share the seed —
        parallel_executor r11), so rng outputs diverge over dp.
    """

    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    inplace: Tuple[Tuple[str, str], ...] = ()
    collective_axes: Tuple[str, ...] = ()
    resolves_axes: Tuple[str, ...] = ()
    shards_axes: Tuple[str, ...] = ()
    rng: bool = False


def op_effects(op: Operator) -> Effects:
    """The effect set of one op: slot-derived reads/writes refined by the
    registered effect rule (registry.register_effects), pure compute when
    none is registered."""
    reads = tuple(op.input_names())
    writes = tuple(op.output_names())
    rset = set(reads)
    inplace = tuple((n, n) for n in writes if n in rset)
    rule = lookup_effect_rule(op.type)
    if rule is None:
        return Effects(reads=reads, writes=writes, inplace=inplace)
    extra = rule(op) or {}
    return Effects(
        reads=reads, writes=writes,
        inplace=inplace + tuple(tuple(p) for p in extra.get("inplace", ())),
        collective_axes=tuple(a for a in extra.get("collective_axes", ())
                              if a),
        resolves_axes=tuple(extra.get("resolves_axes", ())),
        shards_axes=tuple(extra.get("shards_axes", ())),
        rng=bool(extra.get("rng", False)))


# ---------------------------------------------------------------------------
# def-use chains + lifetimes + interference
# ---------------------------------------------------------------------------


@dataclass
class DefUse:
    """Per-block def-use chains: var name -> op indices. `producers` lists
    every writer in op order (more than one only for sanctioned rebinding
    — pp_recv, in-place updates); `consumers` lists every reader."""

    block_idx: int
    producers: Dict[str, List[int]]
    consumers: Dict[str, List[int]]

    def uses_after(self, name: str, idx: int) -> List[int]:
        return [i for i in self.consumers.get(name, ()) if i > idx]


def def_use_chains(block: Block) -> DefUse:
    du = DefUse(block_idx=block.idx, producers={}, consumers={})
    for idx, op in enumerate(block.ops):
        for name in op.input_names():
            du.consumers.setdefault(name, []).append(idx)
        for name in op.output_names():
            du.producers.setdefault(name, []).append(idx)
    return du


def var_lifetimes(block: Block,
                  include_regions: bool = True) -> Dict[str, Tuple[int, int]]:
    """[first_write, last_read] op-index interval per var written in this
    block. With `include_regions` (the default), every value the forward
    segment of a `vjp_region`/`pp_pipeline_region` reads or produces stays
    live until the region op executes — the backward re-runs that segment
    under autograd, so its activations are backward inputs even though no
    op list names them (this is what the r10 census under-counted by
    freeing activations at their last FORWARD reader)."""
    first_w: Dict[str, int] = {}
    last_r: Dict[str, int] = {}
    for idx, op in enumerate(block.ops):
        for name in op.output_names():
            first_w.setdefault(name, idx)
            last_r[name] = max(last_r.get(name, idx), idx)
        for name in op.input_names():
            last_r[name] = idx
        if include_regions and op.type in REGION_OPS:
            for i in op.attrs.get("fwd_ops", ()):
                if not isinstance(i, int) or not 0 <= i < len(block.ops):
                    continue        # attr-schema reports the bad index
                fop = block.ops[i]
                for name in fop.output_names() + fop.input_names():
                    last_r[name] = max(last_r.get(name, idx), idx)
    return {name: (w, last_r.get(name, w)) for name, w in first_w.items()}


def declared_var_bytes(block: Block, name: str,
                       nominal_batch: int = 8) -> int:
    """Declared-shape bytes of one var (-1 dims priced at
    `nominal_batch`) — the ONE pricing rule the lifetime walks
    (analysis.peak_live_bytes) and the memory planner
    (framework/memory_plan.py) share, so slot-table and stash estimates
    can never drift from the peak estimate they are compared against.
    0 for undeclared/shapeless names."""
    from ..core.dtypes import convert_dtype
    v = block.vars.get(name)
    if v is None or v.shape is None:
        return 0
    numel = 1
    for d in v.shape:
        numel *= (nominal_batch if d == -1 else int(d))
    return numel * convert_dtype(v.dtype).itemsize


def interference_graph(block: Block,
                       lifetimes: Optional[Dict[str, Tuple[int, int]]] = None
                       ) -> Dict[str, Set[str]]:
    """Adjacency over TRANSIENT vars whose live intervals overlap — two
    interfering vars can never share a buffer. Feeds and persistables are
    excluded (they are live for the whole program; reusing them is never
    plannable). The memory planner's coloring input."""
    if lifetimes is None:
        lifetimes = var_lifetimes(block)

    def _transient(name):
        v = block.vars.get(name)
        return v is not None and not v.persistable and not v.is_data

    iv = sorted(((s, e, n) for n, (s, e) in lifetimes.items()
                 if _transient(n)), key=lambda t: (t[0], t[1]))
    graph: Dict[str, Set[str]] = {n: set() for _, _, n in iv}
    active: List[Tuple[int, str]] = []      # (end, name)
    for start, end, name in iv:
        active = [(e, n) for e, n in active if e >= start]
        for _, other in active:
            graph[other].add(name)
            graph[name].add(other)
        active.append((end, name))
    return graph


# ---------------------------------------------------------------------------
# generic forward taint propagation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Taint:
    """One divergence fact: the value may differ across the shards of
    `axis`. kind: "rng" (decorrelated randomness), "grad" (shard-local
    gradient partial awaiting reduction), "shard" (deliberately per-shard
    slice/partial). `src` carries op_loc provenance — it rides into the
    diagnostic message, so every report names the op that introduced the
    divergence."""

    axis: str
    kind: str
    src: str = ""

    def __str__(self):
        return f"{self.kind} over {self.axis!r}" + \
            (f" from {self.src}" if self.src else "")


TaintEnv = Dict[Tuple[int, str], FrozenSet[Taint]]

# hooks: var_seeds(block, name, var) -> iterable of Taint (applied to every
# declared var before the block's ops run); op_seeds(block, idx, op,
# effects) -> {out_name: taints} merged into the op's outputs; transfer(
# block, idx, op, effects, in_taints_by_name) -> {out_name: taints} or None
# to use the default effect-driven rule.
VarSeedFn = Callable[[Block, str, Any], Any]
OpSeedFn = Callable[[Block, int, Operator, Effects], Optional[Dict]]
TransferFn = Callable[[Block, int, Operator, Effects, Dict], Optional[Dict]]


def propagate(program: Program,
              var_seeds: Optional[VarSeedFn] = None,
              op_seeds: Optional[OpSeedFn] = None,
              transfer: Optional[TransferFn] = None) -> TaintEnv:
    """Forward taint propagation over every block in op order.

    Default transfer: each output gets the union of all input taints,
    minus the axes the op `resolves_axes` (psum/all-gather results are
    axis-consistent whatever went in), plus a fresh shard taint per
    `shards_axes` axis. Parent-block taints are visible to sub-blocks
    (conservative: the whole parent env, not just the prefix before the
    binder). Returns {(block idx, var name) -> frozenset of Taint}."""
    env: TaintEnv = {}

    def lookup(block: Block, name: str) -> FrozenSet[Taint]:
        b = block
        while b is not None:
            key = (b.idx, name)
            if key in env:
                return env[key]
            if name in b.vars:
                return frozenset()
            b = b.parent
        return frozenset()

    for block in program.blocks:
        if var_seeds is not None:
            for name, v in block.vars.items():
                ts = var_seeds(block, name, v)
                if ts:
                    env[(block.idx, name)] = (
                        env.get((block.idx, name), frozenset())
                        | frozenset(ts))
        for idx, op in enumerate(block.ops):
            eff = op_effects(op)
            ins = {n: lookup(block, n) for n in eff.reads}
            outs = transfer(block, idx, op, eff, ins) \
                if transfer is not None else None
            if outs is None:
                u: FrozenSet[Taint] = frozenset()
                for ts in ins.values():
                    u = u | ts
                if eff.resolves_axes:
                    u = frozenset(t for t in u
                                  if t.axis not in eff.resolves_axes)
                if eff.shards_axes:
                    u = u | frozenset(
                        Taint(a, "shard", op_loc(block, idx, op))
                        for a in eff.shards_axes)
                outs = {n: u for n in eff.writes}
            if op_seeds is not None:
                for n, ts in (op_seeds(block, idx, op, eff) or {}).items():
                    outs[n] = frozenset(outs.get(n, frozenset())) \
                        | frozenset(ts)
            for n, ts in outs.items():
                env[(block.idx, n)] = frozenset(ts)
    return env


# ---------------------------------------------------------------------------
# the replica-divergence lattice instantiation
# ---------------------------------------------------------------------------


def _dp_active(program: Program) -> bool:
    """dp divergence exists only in the EXPLICIT per-shard execution mode
    (manual shard_map with decorrelated seeds and raw local gradients) —
    marked by a spliced dp_grad_comm. Default SPMD mode has one logical
    program whose collectives XLA owns: nothing to taint."""
    return any(op.type == "dp_grad_comm"
               for b in program.blocks for op in b.ops)


def _tp_active(program: Program) -> bool:
    """tp divergence exists once tp_shard_pass made the sharding
    executable (tp collectives spliced, vars marked tp_spec)."""
    if getattr(program, "_tp_applied", False):
        return True
    return any(op.type.startswith("tp_")
               for b in program.blocks for op in b.ops)


def divergence_taints(program: Program) -> TaintEnv:
    """'Diverges over axis X' facts for every var (GSPMD-style spec
    propagation restricted to the consistency lattice). Sources: RNG ops
    (dp-decorrelated seeds), backward-region raw gradients (shard-local
    partials before dp_grad_comm), tp-sharded params and tp_split /
    dp_shard_slice outputs. Collectives clear their axis per the effect
    table; dp_grad_comm clears dp on bucket outputs and re-marks sharded
    outputs as deliberate dp shards."""
    dp_on = _dp_active(program)
    tp_on = _tp_active(program)
    if not dp_on and not tp_on:
        return {}

    def var_seeds(block, name, v):
        ts = []
        if tp_on and getattr(v, "tp_spec", None):
            ts.append(Taint(TP_AXIS, "shard", f"tp-sharded var {name!r}"))
        if dp_on and (getattr(v, "dp_shard_update", False)
                      or getattr(v, "dp_replica_state", False)):
            ts.append(Taint(DP_AXIS, "shard", f"dp-sharded state {name!r}"))
        return ts

    def op_seeds(block, idx, op, eff):
        # the rng effect rule already accounts for fixed seeds and
        # inference-mode dropout (ops/random_ops.py)
        if eff.rng and dp_on:
            t = Taint(DP_AXIS, "rng", op_loc(block, idx, op))
            return {n: (t,) for n in eff.writes}
        return None

    def transfer(block, idx, op, eff, ins):
        loc = op_loc(block, idx, op)
        if op.type in REGION_OPS:
            # Grads are gradients of the LOCAL mean loss: dp partials in
            # explicit mode unless the region pmeans them itself
            # (reduce_dp). Over tp the f/g custom VJPs (tensor_parallel.py)
            # guarantee replicated-param cotangents are psum'd; gradients
            # of tp-sharded params stay tp-local like their params.
            reduce_dp = bool(op.attrs.get("reduce_dp", False))
            outs = {}
            targets = list(op.attrs.get("targets", ()))
            for g, t in zip(op.outputs.get("Grads", ()), targets):
                ts = set()
                if dp_on and not reduce_dp:
                    ts.add(Taint(DP_AXIS, "grad", loc))
                if tp_on and block.has_var(t) \
                        and getattr(block.var(t), "tp_spec", None):
                    ts.add(Taint(TP_AXIS, "shard", loc))
                outs[g] = ts
            for lg in op.outputs.get("LossGrad", ()):
                outs[lg] = set()           # the replicated 1.0 seed
            return outs
        if op.type == "dp_grad_comm":
            xs = list(op.inputs.get("X", ()))
            kinds = list(op.attrs.get("kinds", ()))
            outs = {}
            for i, on in enumerate(op.outputs.get("Out", ())):
                tin = ins.get(xs[i], frozenset()) if i < len(xs) \
                    else frozenset()
                keep = {t for t in tin if t.axis != DP_AXIS}
                if i < len(kinds) and kinds[i] == "sharded":
                    keep.add(Taint(DP_AXIS, "shard", loc))
                outs[on] = keep
            for en in op.outputs.get("ErrOut", ()):
                outs[en] = {Taint(DP_AXIS, "shard", loc)}
            return outs
        return None

    return propagate(program, var_seeds=var_seeds, op_seeds=op_seeds,
                     transfer=transfer)


def _lookup_taints(env: TaintEnv, block: Block,
                   name: str) -> FrozenSet[Taint]:
    b = block
    while b is not None:
        key = (b.idx, name)
        if key in env:
            return env[key]
        if name in b.vars:
            return frozenset()
        b = b.parent
    return frozenset()


# ---------------------------------------------------------------------------
# detector 1: SPMD collective consistency / static deadlock
# ---------------------------------------------------------------------------

# op family -> the one mesh axis its collectives may ride. tp_* ops carry
# Megatron f/g semantics over the model axis, dp_* ops the r08 gradient
# pipeline over the data axis; an axis-swapped attr would psum across the
# WRONG shards — numerically silent corruption (or, shard counts differing,
# a hang). dp_shard_slice performs no comm but derives its slice index from
# the axis, so a mismatch mis-places the ZeRO shard the same way.
_CANONICAL_AXIS = {
    "tp_allreduce": TP_AXIS, "tp_ident": TP_AXIS, "tp_split": TP_AXIS,
    "tp_allgather": TP_AXIS, "tp_vocab_lookup": TP_AXIS,
    "dp_grad_comm": DP_AXIS, "dp_shard_slice": DP_AXIS,
    "dp_shard_all_gather": DP_AXIS,
}


def _check_collective_axes(program, diags):
    for block in program.blocks:
        for idx, op in enumerate(block.ops):
            want = _CANONICAL_AXIS.get(op.type)
            if want is None:
                if op.type == "pp_pipeline_region" and \
                        op.attrs.get("axis") not in (PP_AXIS,):
                    diags.append(Diagnostic(
                        "collective-axis-mismatch", op_loc(block, idx, op),
                        f"pipeline region must run over axis "
                        f"{PP_AXIS!r}, got {op.attrs.get('axis')!r}"))
                continue
            got = op.attrs.get("axis")
            if got != want:
                diags.append(Diagnostic(
                    "collective-axis-mismatch", op_loc(block, idx, op),
                    f"{op.type} must ride mesh axis {want!r}, got "
                    f"{got!r}: shards of {want!r} would wait on a "
                    f"collective the program issues over {got!r}"))


def _check_pp_stage_order(program, diags):
    """Stage-partition placement of the pipeline boundary collectives: the
    schedule executes stage k's op list on pp shard k, so cut c's pp_send
    must belong to stage c and its pp_recv to stage c+1, and within a
    stage the recv (binding the stage's inputs) must precede the send
    (emitting its outputs). A boundary op assigned to the wrong stage —
    or re-ordered within its stage — means some pp shard never issues the
    transfer its peer is blocked on: a static deadlock. (Global
    send/recv PAIRING is pp-unmatched-boundary's job; this check is about
    WHERE in the partition the pair sits.)"""
    for block in program.blocks:
        for ridx, rop in enumerate(block.ops):
            if rop.type != "pp_pipeline_region":
                continue
            stages = rop.attrs.get("stages") or []
            loc = op_loc(block, ridx, rop)
            stage_of = {}
            for k, idxs in enumerate(stages):
                for i in idxs:
                    if isinstance(i, int):
                        stage_of[i] = k
            sends = {}
            recvs = {}
            for i, op in enumerate(block.ops):
                if op.type == "pp_send":
                    sends[op.attrs.get("cut")] = i
                elif op.type == "pp_recv":
                    recvs[op.attrs.get("cut")] = i
            for cut, si in sorted(sends.items(), key=lambda kv: repr(kv[0])):
                if si not in stage_of:
                    diags.append(Diagnostic(
                        "collective-order", op_loc(block, si, block.ops[si]),
                        f"pp_send for cut {cut} is not in any stage of the "
                        f"pipeline region at {loc}: no pp shard ever "
                        f"issues it — static deadlock"))
                elif stage_of[si] != cut:
                    diags.append(Diagnostic(
                        "collective-order", op_loc(block, si, block.ops[si]),
                        f"pp_send for cut {cut} assigned to stage "
                        f"{stage_of[si]} (must be stage {cut}): stage "
                        f"{cut + 1}'s pp_recv waits on a send its peer "
                        f"stage never issues — static deadlock"))
            for cut, ri in sorted(recvs.items(), key=lambda kv: repr(kv[0])):
                if ri not in stage_of:
                    diags.append(Diagnostic(
                        "collective-order", op_loc(block, ri, block.ops[ri]),
                        f"pp_recv for cut {cut} is not in any stage of the "
                        f"pipeline region at {loc}: no pp shard ever "
                        f"issues it — static deadlock"))
                elif stage_of[ri] != cut + 1:
                    diags.append(Diagnostic(
                        "collective-order", op_loc(block, ri, block.ops[ri]),
                        f"pp_recv for cut {cut} assigned to stage "
                        f"{stage_of[ri]} (must be stage {cut + 1}): the "
                        f"consuming stage never receives its boundary "
                        f"activation — static deadlock"))
            # within one stage: every recv (cut k-1) precedes every send
            # (cut k) in the stage's own execution order
            for k, idxs in enumerate(stages):
                pos = {i: p for p, i in enumerate(idxs)
                       if isinstance(i, int)}
                r = [pos[i] for c, i in recvs.items()
                     if stage_of.get(i) == k and i in pos]
                s = [pos[i] for c, i in sends.items()
                     if stage_of.get(i) == k and i in pos]
                if r and s and max(r) > min(s):
                    i = idxs[min(s)]
                    diags.append(Diagnostic(
                        "collective-order", op_loc(block, i, block.ops[i]),
                        f"stage {k} issues its pp_send before its pp_recv: "
                        f"the send's inputs depend on the boundary "
                        f"activation the stage has not received — "
                        f"static deadlock"))


def _sub_block_map(program) -> Dict[int, Tuple[Block, int, Operator]]:
    """sub-block idx -> (binder block, binder op idx, binder op)."""
    out = {}
    for block in program.blocks:
        for idx, op in enumerate(block.ops):
            for key in _SUB_KEYS:
                v = op.attrs.get(key)
                if isinstance(v, int) and not isinstance(v, bool):
                    subs = [v]
                elif isinstance(v, (list, tuple)):
                    subs = [x for x in v if isinstance(x, int)]
                else:
                    subs = []
                for si in subs:
                    if 0 < si < len(program.blocks):
                        out.setdefault(si, (block, idx, op))
    return out


def _binder_condition_names(bop) -> List[str]:
    """The names the binder BRANCHES on — not its captures/carries, which
    legitimately hold shard-varying state (a ZeRO accumulator captured
    into a branch body is fine; a divergent CONDITION is the deadlock).
    cond_block/lazy_cond use the Cond slot, switch_case Conds, while
    names its condition inside Carry via the cond_name attr; static_rnn
    has no condition (its trip count is shape-static, shard-invariant)."""
    conds = list(bop.inputs.get("Cond", ())) \
        + list(bop.inputs.get("Conds", ()))
    cn = bop.attrs.get("cond_name")
    if cn:
        conds.append(cn)
    return conds


def _check_divergent_control(program, env, diags):
    """A collective under control flow entered per a shard-divergent
    condition: shards of the collective's axis disagree on taking the
    branch (or on the trip count), so some issue the collective and some
    never do — the canonical SPMD deadlock. The binder chain is walked
    transitively: a collective in a nested block deadlocks on ANY
    divergent condition above it."""
    binders = _sub_block_map(program)
    for block in program.blocks:
        if block.idx == 0:
            continue
        for idx, op in enumerate(block.ops):
            eff = op_effects(op)
            if not eff.collective_axes:
                continue
            si = block.idx
            seen = set()
            while si in binders and si not in seen:
                seen.add(si)
                bblock, bidx, bop = binders[si]
                for cond in _binder_condition_names(bop):
                    bad = [t for t in _lookup_taints(env, bblock, cond)
                           if t.axis in eff.collective_axes]
                    if bad:
                        diags.append(Diagnostic(
                            "collective-divergent-control",
                            op_loc(block, idx, op),
                            f"collective over axis "
                            f"{bad[0].axis!r} executes under "
                            f"{bop.type!r} (block {bblock.idx} "
                            f"op#{bidx}) whose condition {cond!r} "
                            f"diverges ({bad[0]}): shards disagree on "
                            f"entering the branch — static deadlock"))
                si = bblock.idx
    return diags


# ---------------------------------------------------------------------------
# detector 2: replica divergence into replication-requiring sinks
# ---------------------------------------------------------------------------

# the r08 ZeRO-1 rewrite's name suffixes (parallel/grad_comm.py
# SHARD_SUFFIX) — duplicated literal for the same layering reason as the
# axis names; test_dataflow.py pins them in sync
_DP_SHARD_SUFFIX = "@DP_SHARD"


def _check_tp_partials(program, diags):
    """A raw tp partial sum (the `@TPPART` output tp_shard_pass renames a
    contraction over a tp-sharded dim to — framework/sharding.py
    TP_PART_SUFFIX) is correct exactly once through `tp_allreduce`
    (psum_once, the Megatron g operator). Any other consumer reads a
    shard-local partial as if it were the replicated value — the
    silent-corruption half of the replica-divergence bug class (a later
    psum on some OTHER path would launder the divergence without fixing
    the number, so this must be caught at the consuming op, not at a
    sink). The same contract dp-comm-bypass enforces for `@COMM`
    gradients, one axis over."""
    # ≙ framework/sharding.py's TP_PART_SUFFIX (kept here so the dataflow
    # layer does not import the sharding module)
    TP_PART_SUFFIX = "@TPPART"
    for block in program.blocks:
        for idx, op in enumerate(block.ops):
            if op.type == "tp_allreduce" or op.type in REGION_OPS:
                continue
            bad = sorted(n for n in set(op.input_names())
                         if n.endswith(TP_PART_SUFFIX))
            if bad:
                diags.append(Diagnostic(
                    "replica-divergence", op_loc(block, idx, op),
                    f"reads raw tp partial sum(s) {bad[:4]} — a "
                    f"{TP_PART_SUFFIX} value is a shard-local partial "
                    f"awaiting its one tp_allreduce; consuming it "
                    f"anywhere else silently treats a partial as the "
                    f"replicated value"))


def _check_replica_divergence(program, env, diags):
    """Parameter updates must consume replica-consistent values: every
    optimizer input carrying a divergence taint — other than the
    sanctioned ZeRO-1 dp shards on a sharded-update op and tp-local
    gradients of a tp-sharded param — reports, with the source op in the
    message. The region loss must additionally be tp-consistent (tp
    shards see the SAME batch; a tp-divergent loss means a missing
    tp collective — the executor's scalar pmean over dp is a mean over
    DIFFERENT batch slices, sanctioned; over tp it would silently
    average a partial). Raw `@TPPART` partials get the stricter
    consumed-exactly-by-tp_allreduce contract (`_check_tp_partials`)."""
    _check_tp_partials(program, diags)
    for block in program.blocks:
        for idx, op in enumerate(block.ops):
            if op.type in REGION_OPS:
                loss = op.attrs.get("loss")
                if loss:
                    bad = sorted((t for t in _lookup_taints(env, block, loss)
                                  if t.axis == TP_AXIS), key=str)
                    if bad:
                        diags.append(Diagnostic(
                            "replica-divergence", op_loc(block, idx, op),
                            f"loss {loss!r} diverges over {TP_AXIS!r} "
                            f"({bad[0]}): tp shards compute identical "
                            f"data, so a tp-divergent loss means a "
                            f"missing tp collective on its path"))
                continue
            if op.attrs.get("op_role") != "optimize":
                continue
            eff = op_effects(op)
            if eff.collective_axes or eff.resolves_axes or eff.shards_axes:
                continue        # the comm/placement ops of the update path
            params = list(op.inputs.get("Param", ()))
            sharded_update = any(n.endswith(_DP_SHARD_SUFFIX)
                                 for n in params)
            base = [n[:-len(_DP_SHARD_SUFFIX)]
                    if n.endswith(_DP_SHARD_SUFFIX) else n for n in params]
            param_tp = any(block.has_var(p)
                           and getattr(block.var(p), "tp_spec", None)
                           for p in base)
            for name in eff.reads:
                bad = []
                for t in _lookup_taints(env, block, name):
                    if t.axis == DP_AXIS and t.kind == "shard" \
                            and sharded_update:
                        continue     # ZeRO-1: update runs on the dp slice
                    if t.axis == TP_AXIS and t.kind == "shard" and param_tp:
                        continue     # tp-sharded param: grad sharded alike
                    bad.append(t)
                if bad:
                    bad.sort(key=str)
                    diags.append(Diagnostic(
                        "replica-divergence", op_loc(block, idx, op),
                        f"optimizer input {name!r} diverges across "
                        f"replicas ({bad[0]}): parameter updates must "
                        f"consume replica-consistent values or replicas "
                        f"drift apart silently"))


# ---------------------------------------------------------------------------
# detector 3: buffer-reuse / WAR races over the interference graph
# ---------------------------------------------------------------------------


def _check_cross_block_slots(program, groups, diags):
    """Slot groups that CROSS a block boundary (r18 planner satellite):
    the per-block scan above compares live intervals inside one op list,
    so a planner slot shared between a parent-block var and a var inside
    a bound sub-block (while/cond/static_rnn body — or any region a
    binder op executes) was never verified. The sub-block var's effective
    live window in an ancestor block is its BINDER op's index — the
    binder (re-)executes the whole sub-block, possibly per iteration, so
    the var is live whenever the binder is. Walk each member's binder
    chain to the deepest common ancestor and report overlap there as the
    same `buffer-reuse-race` the in-block scan raises. Sibling sub-blocks
    of ONE binder (cond/switch branches) are mutually exclusive and
    sanctioned."""
    cross = {s: ms for s, ms in groups.items()
             if len({b.idx for b, _ in ms}) > 1}
    if not cross:
        return
    binders = _sub_block_map(program)
    lifetimes_cache: Dict[int, Dict] = {}

    def lifetimes(block):
        lt = lifetimes_cache.get(block.idx)
        if lt is None:
            lt = lifetimes_cache[block.idx] = var_lifetimes(block)
        return lt

    def spans(block, name):
        """{ancestor block idx: (start, end)} — the var's own lifetime in
        its block, then its binder op's point interval per ancestor."""
        iv = lifetimes(block).get(name)
        if iv is None:
            return None                   # never written: nothing to race
        out = {block.idx: iv}
        b = block
        seen = set()
        while b.idx in binders and b.idx not in seen:
            seen.add(b.idx)
            pb, pidx, _pop = binders[b.idx]
            out[pb.idx] = (pidx, pidx)
            b = pb
        return out

    for slot, members in sorted(cross.items(), key=lambda kv: repr(kv[0])):
        for i in range(len(members)):
            for j in range(i + 1, len(members)):
                (b1, n1), (b2, n2) = members[i], members[j]
                if b1.idx == b2.idx:
                    continue              # the per-block scan owns these
                s1, s2 = spans(b1, n1), spans(b2, n2)
                if s1 is None or s2 is None:
                    continue
                common = set(s1) & set(s2)
                if not common:
                    continue
                cb = max(common)          # deepest common ancestor
                (a1, e1), (a2, e2) = s1[cb], s2[cb]
                if cb not in (b1.idx, b2.idx) and (a1, e1) == (a2, e2):
                    continue    # sibling branches of one binder: exclusive
                if a1 <= e2 and a2 <= e1:
                    block = program.blocks[cb]
                    bidx = a1 if cb != b1.idx else a2
                    diags.append(Diagnostic(
                        "buffer-reuse-race",
                        op_loc(block, bidx, block.ops[bidx]),
                        f"buffer slot {slot!r}: {n1!r} (block {b1.idx}) "
                        f"and {n2!r} (block {b2.idx}) overlap in ancestor "
                        f"block {cb} — a sub-block var is live whenever "
                        f"its region binder executes, so a slot crossing "
                        f"the boundary must not overlap the binder's "
                        f"live window"))


def _check_buffer_reuse(program, diags):
    """The safety gate for liveness-driven buffer reuse (the memory plan):
    vars the planner assigns one buffer (`Variable.buffer_slot`) must not
    interfere. A proper live-interval overlap is a reuse race (two live
    values, one buffer); a write landing exactly on the op still reading
    the previous occupant is the WAR boundary case — legal only with a
    serializing copy, so it reports separately. Cross-name in-place
    aliases from effect rules get the same WAR treatment. Programs with
    no annotations (everything today outside the planner and its tests)
    short-circuit to zero cost."""
    all_groups: Dict[Any, List[Tuple[Any, str]]] = {}
    for block in program.blocks:
        groups: Dict[Any, List[str]] = {}
        for name, v in block.vars.items():
            slot = getattr(v, "buffer_slot", None)
            if slot is not None:
                groups.setdefault(slot, []).append(name)
                all_groups.setdefault(slot, []).append((block, name))
        # cross-name in-place aliases can only come from a REGISTERED
        # effect rule (the slot-derived default is same-name only), so the
        # scan touches just the ops that have one — everything else keeps
        # the advertised zero-cost path
        aliased = []
        for idx, op in enumerate(block.ops):
            if lookup_effect_rule(op.type) is None:
                continue
            for rin, rout in op_effects(op).inplace:
                if rin != rout:
                    aliased.append((idx, op, rin, rout))
        if not any(len(g) > 1 for g in groups.values()) and not aliased:
            continue
        lifetimes = var_lifetimes(block)
        du = def_use_chains(block)
        for slot, names in sorted(groups.items(), key=lambda kv: repr(kv[0])):
            if len(names) < 2:
                continue
            iv = []
            for name in sorted(names):
                v = block.vars[name]
                if v.persistable or v.is_data:
                    diags.append(Diagnostic(
                        "buffer-reuse-race", name,
                        f"buffer slot {slot!r}: {name!r} is "
                        f"{'persistable' if v.persistable else 'a feed'} "
                        f"— live for the whole program, never reusable"))
                    continue
                if name in lifetimes:
                    iv.append((lifetimes[name], name))
            iv.sort()
            # compare each interval against EVERY still-active occupant
            # (adjacent-only would miss a short-lived mate nested inside a
            # long-lived one); groups are small, the active list smaller
            active: List[Tuple[int, int, str]] = []   # (end, start, name)
            for (s1, e1), n1 in iv:
                active = [(e0, s0, n0) for e0, s0, n0 in active
                          if e0 >= s1]
                for e0, s0, n0 in active:
                    writer = block.ops[s1]
                    if s1 == e0 and n0 in writer.input_names():
                        diags.append(Diagnostic(
                            "buffer-war-race", op_loc(block, s1, writer),
                            f"buffer slot {slot!r}: writes {n1!r} into "
                            f"the buffer while the same op still reads "
                            f"the previous occupant {n0!r} — needs a "
                            f"serializing copy before the slot can be "
                            f"reused"))
                    else:
                        diags.append(Diagnostic(
                            "buffer-reuse-race", op_loc(block, s1, writer),
                            f"buffer slot {slot!r}: {n1!r} (live "
                            f"[{s1}, {e1}]) overlaps {n0!r} (live "
                            f"[{s0}, {e0}]) — interfering vars cannot "
                            f"share a buffer"))
                active.append((e1, s1, n1))
        for idx, op, rin, rout in aliased:
            late = du.uses_after(rin, idx)
            if late:
                j = late[0]
                diags.append(Diagnostic(
                    "buffer-war-race", op_loc(block, idx, op),
                    f"in-place alias {rin!r} -> {rout!r}: op#{j} "
                    f"{block.ops[j].type!r} still reads {rin!r} after "
                    f"the aliasing write overwrote its buffer"))
    _check_cross_block_slots(program, all_groups, diags)


# ---------------------------------------------------------------------------
# serving cache-write aliasing (r24) — opt-in via lint_program --serving
# ---------------------------------------------------------------------------

# The executor's donated-state path rebinds each persistable KV pool in
# place: builders pass `out=pool` so Cache and Out are the SAME var and
# the dispatch loop can donate the buffer. Either aliasing mistake
# silently corrupts serving state instead of crashing, which is why this
# is a static check and not a runtime assert.
CACHE_WRITE_OPS = ("cache_write", "paged_cache_write",
                   "paged_cache_write_quant")


def cache_write_aliasing(program: Program) -> List[Diagnostic]:
    """Serving-tier cache-write aliasing checks (lint_program --serving).

    Two named diagnostics over the tick/prefill program's cache-write
    ops (`CACHE_WRITE_OPS`; the Scales plane of the quantized write is
    checked as its own (Scales, ScalesOut) pair):

    - `serving-cache-write-alias`: a pool var with more than one writer
      in a block (two scatters race on one donated buffer — the executor
      aliases Out onto Cache, so op order stops being observable), or a
      PERSISTABLE pool written to a different Out var (the update lands
      in a temporary; the persistable state the next tick reads never
      advances — a silent fork of the serving cache).
    - `serving-cache-stale-read`: an op after the write still reading
      the old Cache name when Out is a fresh var — the reader sees the
      pre-write bytes (exactly the offload-use-before-arrival hazard,
      one tier up).
    """
    diags: List[Diagnostic] = []
    for block in program.blocks:
        writers: Dict[str, List[Tuple[int, Operator, str]]] = {}
        for idx, op in enumerate(block.ops):
            if op.type not in CACHE_WRITE_OPS:
                continue
            pairs = [("Cache", "Out")]
            if op.type == "paged_cache_write_quant":
                pairs.append(("Scales", "ScalesOut"))
            for cin, cout in pairs:
                cache = (op.inputs.get(cin) or [None])[0]
                outn = (op.outputs.get(cout) or [None])[0]
                if cache is None or outn is None:
                    continue
                writers.setdefault(cache, []).append((idx, op, outn))
        for cache, ws in sorted(writers.items()):
            if len(ws) > 1:
                idx, op, _ = ws[1]
                diags.append(Diagnostic(
                    "serving-cache-write-alias", op_loc(block, idx, op),
                    f"cache var {cache!r} has {len(ws)} writers in one "
                    f"block (first at op#{ws[0][0]}) — scatters race on "
                    f"the donated pool buffer"))
            for idx, op, outn in ws:
                if outn == cache:
                    continue
                var = block.vars.get(cache)
                if var is not None and getattr(var, "persistable", False):
                    diags.append(Diagnostic(
                        "serving-cache-write-alias", op_loc(block, idx, op),
                        f"persistable cache {cache!r} written to a "
                        f"different var {outn!r} — the serving state "
                        f"forks into a temporary and never advances"))
                for j in range(idx + 1, len(block.ops)):
                    later = block.ops[j]
                    if cache in later.input_names():
                        diags.append(Diagnostic(
                            "serving-cache-stale-read",
                            op_loc(block, j, later),
                            f"op#{j} {later.type!r} reads {cache!r} "
                            f"after op#{idx} rewrote it into {outn!r} — "
                            f"the reader sees the pre-write cache"))
                        break
    return diags


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def dataflow_checks(program: Program) -> List[Diagnostic]:
    """All three dataflow detectors; called from analysis.verify_program
    (and therefore from every sanitized pass apply). Pure Python over the
    IR — no jax, no tracing; cost is linear in op count."""
    diags: List[Diagnostic] = []
    env = divergence_taints(program)
    _check_collective_axes(program, diags)
    _check_pp_stage_order(program, diags)
    _check_divergent_control(program, env, diags)
    _check_replica_divergence(program, env, diags)
    _check_buffer_reuse(program, diags)
    return diags
