"""Static sharding propagation over the Program IR, and tp_shard_pass.

≙ paddle_tpu/framework/sharding.py, the same rules and the same rewrite:
per-variable specs seeded from ``ParamAttr(sharding_spec=...)`` /
``parallel.auto_shard.annotate_tp`` are propagated op by op with the
registered rules (``registry.register_shard_spec``), which record the
collectives the tp component needs: a partial-sum output that needs a tp
all-reduce (row-parallel matmul), a replicated activation entering
sharded compute that needs Megatron's f operator, a replicated operand
split to the local chunk, or a sharded value all-gathered back.
Conflicts report as diagnostics with the analyzer's op provenance.

`tp_shard_pass` makes the propagated specs executable: it splices
``tp_allreduce`` / ``tp_ident`` / ``tp_split`` / ``tp_allgather``
(parallel/tensor_parallel.py), rewrites vocab-sharded lookups to
``tp_vocab_lookup``, localizes reshape targets, re-maps the vjp_region's
fwd_ops and marks every sharded variable with ``tp_spec``. The rewritten
program's JSON equals the JAX package's. ParallelExecutor then runs it on
every rank of the tp group over the rank's local blocks, where the JAX
package runs it inside one full-manual shard_map.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.enforce import InvalidArgumentError, NotFoundError, enforce
from .analysis import (BATCH_SENTINEL, Diagnostic, ProgramAnalysisError,
                       _subst, op_loc)
from .passes import Pass, register_pass
from .program import Block, Operator, Program
from .registry import lookup_shard_rule, register_shard_spec

__all__ = [
    "TP_AXIS", "TP_PART_SUFFIX", "ShardCtx", "ShardingResult",
    "TpShardPass", "has_tp_annotations", "propagate_sharding",
    "tp_analytic_wire_bytes", "tp_component", "tp_local_shape",
]

# The model-parallel mesh axis name (== parallel.mesh.MODEL_AXIS; duplicated
# here so the framework layer does not import the parallel package).
TP_AXIS = "tp"

TP_PART_SUFFIX = "@TPPART"    # raw partial-sum output awaiting tp_allreduce
TP_IDENT_SUFFIX = "@TPID"     # identity-fwd / psum-bwd wrapped activation
TP_SPLIT_SUFFIX = "@TPSPLIT"  # local chunk of a replicated operand
TP_GATHER_SUFFIX = "@TPGATH"  # re-assembled (resharded) value


def tp_component(spec) -> Optional[tuple]:
    """Reduce a general sharding_spec (which may name dp/sp axes or axis
    tuples) to its tp component: a per-dim tuple of TP_AXIS-or-None, or
    None when no dim is tp-sharded."""
    if spec is None:
        return None
    out, any_tp = [], False
    for s in spec:
        names = s if isinstance(s, (tuple, list)) else (s,)
        if TP_AXIS in names:
            out.append(TP_AXIS)
            any_tp = True
        else:
            out.append(None)
    return tuple(out) if any_tp else None


def tp_local_shape(shape, tp_spec, tp: int) -> Optional[tuple]:
    """The per-shard shape of a var declared at `shape` and sharded per
    `tp_spec` over a tp axis of size `tp` (tp-sharded dims divide)."""
    if shape is None:
        return None
    if not tp_spec or tp <= 1:
        return tuple(shape)
    out = []
    for d, s in zip(shape, tuple(tp_spec) + (None,) * len(shape)):
        if s == TP_AXIS and d not in (-1, None) and d % tp == 0:
            out.append(d // tp)
        else:
            out.append(d)
    return tuple(out)


def has_tp_annotations(program: Program) -> bool:
    """Does any block-0 var carry a sharding_spec with a tp component?"""
    for v in program.global_block().vars.values():
        if tp_component(getattr(v, "sharding_spec", None)) is not None:
            return True
    return False


def _is_sharded(spec) -> bool:
    return spec is not None and any(s is not None for s in spec)


def _repl(rank: Optional[int]) -> Optional[tuple]:
    return None if rank is None else (None,) * rank


# ---------------------------------------------------------------------------
# propagation context + result
# ---------------------------------------------------------------------------


@dataclass
class OpActions:
    """Collective actions one op needs to execute its propagated sharding
    (consumed by tp_shard_pass; ignored by pure verification)."""
    op_idx: int
    psums: List[Tuple[str, int]] = field(default_factory=list)  # slot, i
    idents: List[Tuple[str, int]] = field(default_factory=list)
    splits: List[Tuple[str, int, int]] = field(default_factory=list)  # +dim
    gathers: List[Tuple[str, int, int]] = field(default_factory=list)
    replace: Optional[str] = None       # swap op.type (tp_vocab_lookup)

    def any(self):
        return bool(self.psums or self.idents or self.splits
                    or self.gathers or self.replace)


@dataclass
class ShardCtx:
    """Context handed to shard-propagation rules (the sharding-layer
    InferCtx): op provenance, the tp axis name/size, declared-shape lookup,
    and the action/diagnostic recorders."""
    block: Block
    op: Operator
    op_idx: int
    axis: str = TP_AXIS
    size: Optional[int] = None          # None = size-agnostic verification
    nominal_batch: int = BATCH_SENTINEL
    actions: OpActions = None
    diagnostics: List[Diagnostic] = None

    @property
    def loc(self) -> str:
        return op_loc(self.block, self.op_idx, self.op)

    def shape_of(self, name: str) -> Optional[tuple]:
        try:
            v = self.block.var(name)
        except NotFoundError:
            return None
        if v.shape is None:
            return None
        return _subst(v.shape, self.nominal_batch)

    def in_shape(self, slot: str, i: int = 0) -> Optional[tuple]:
        names = self.op.inputs.get(slot, ())
        return self.shape_of(names[i]) if i < len(names) else None

    # -- recorders --------------------------------------------------------
    def conflict(self, message: str, code: str = "shard-conflict"):
        self.diagnostics.append(Diagnostic(code, self.loc, message))

    def warn(self, message: str, code: str = "shard-reshard"):
        self.diagnostics.append(
            Diagnostic(code, self.loc, message, severity="warning"))

    def check_divisible(self, dim_size, what: str) -> bool:
        if (self.size and dim_size not in (None, -1)
                and dim_size % self.size != 0):
            self.diagnostics.append(Diagnostic(
                "shard-divisibility", self.loc,
                f"{what}: dim of size {dim_size} is not divisible by "
                f"tp={self.size}"))
            return False
        return True

    def psum(self, slot: str = "Out", i: int = 0):
        """Mark output (slot, i) as a PARTIAL sum: tp_allreduce follows."""
        self.actions.psums.append((slot, i))

    def ident_input(self, slot: str, i: int = 0):
        """Wrap replicated input (slot, i) entering sharded compute with
        tp_ident (Megatron's f: identity forward, psum backward)."""
        self.actions.idents.append((slot, i))

    def split_input(self, slot: str, i: int, dim: int):
        """Slice replicated input (slot, i) to the local chunk on `dim`."""
        self.actions.splits.append((slot, i, dim))

    def gather_input(self, slot: str, i: int, dim: int):
        """All-gather sharded input (slot, i) back to replicated (the
        reshard at a tp boundary)."""
        self.actions.gathers.append((slot, i, dim))

    def replace_op(self, new_type: str):
        self.actions.replace = new_type


@dataclass
class ShardingResult:
    specs: Dict[str, tuple]             # block-0 var name -> propagated spec
    diagnostics: List[Diagnostic]
    actions: List[OpActions]            # only entries with any() True
    seeded: Dict[str, tuple]            # annotation-seeded var -> tp spec

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == "error"]

    def sharded_vars(self) -> Dict[str, tuple]:
        return {n: s for n, s in self.specs.items() if _is_sharded(s)}


# ---------------------------------------------------------------------------
# propagation over the global block
# ---------------------------------------------------------------------------

# control-flow binder ops cannot consume tp-sharded values: the sub-block is
# traced by the lowering with no sharding model of its own
_CTRL_OPS = frozenset({"cond_block", "lazy_cond", "while", "switch_case",
                       "static_rnn", "array_read", "array_write"})

_REGION_TYPES = frozenset({"vjp_region", "pp_pipeline_region"})


def propagate_sharding(program: Program, tp_size: Optional[int] = None,
                       nominal_batch: int = BATCH_SENTINEL
                       ) -> ShardingResult:
    """Whole-program sharding propagation over the global block.

    Seeds from every var carrying a ``sharding_spec`` with a tp component,
    walks ops in order applying the registered per-op rules, and returns
    the propagated spec environment, conflict/divisibility diagnostics, and
    the collective actions tp_shard_pass would splice. `tp_size=None` runs
    size-agnostic (divisibility checks skipped)."""
    block = program.global_block()
    res = ShardingResult(specs={}, diagnostics=[], actions=[], seeded={})
    env = res.specs

    for name, v in block.vars.items():
        spec = tp_component(getattr(v, "sharding_spec", None))
        if spec is None:
            continue
        if v.shape is not None and len(spec) != len(v.shape):
            res.diagnostics.append(Diagnostic(
                "shard-spec-arity", name,
                f"sharding_spec {list(spec)} has {len(spec)} entries for "
                f"declared rank {len(v.shape)}"))
            continue
        env[name] = spec
        res.seeded[name] = spec
        if v.shape is not None and tp_size:
            for d, s in zip(v.shape, spec):
                if s == TP_AXIS and d not in (-1,) and d % tp_size != 0:
                    res.diagnostics.append(Diagnostic(
                        "shard-divisibility", name,
                        f"annotated dim of size {d} is not divisible by "
                        f"tp={tp_size}"))

    # optimizer accumulators carry no annotation of their own but live at
    # their param's placement (the r08 dp-sharded-update discipline, here on
    # the tp axis): same-shaped accumulators inherit the param's spec;
    # shape-mismatched state (Beta1Pow-style scalars) stays replicated
    for name, v in block.vars.items():
        owner = getattr(v, "accumulator_of", None)
        if owner is None or owner not in res.seeded:
            continue
        try:
            pvar = block.var(owner)
        except NotFoundError:
            continue
        if v.shape is not None and v.shape == pvar.shape:
            env[name] = res.seeded[owner]
            res.seeded[name] = res.seeded[owner]

    from .lowering import grad_var_name

    def _spec_for(name: str) -> Optional[tuple]:
        s = env.get(name)
        if s is not None:
            return s
        try:
            v = block.var(name)
        except NotFoundError:
            return None
        return _repl(len(v.shape)) if v.shape is not None else None

    for idx, op in enumerate(block.ops):
        if op.type in _REGION_TYPES:
            # gradients mirror their targets' shardings; the loss grad is
            # replicated (the engine executes the region itself)
            for t in op.attrs.get("targets", ()):
                s = env.get(t)
                if s is not None:
                    env[grad_var_name(t)] = s
            loss = op.attrs.get("loss")
            if loss:
                ls = _spec_for(loss)
                if ls is not None:
                    env[grad_var_name(loss)] = ls
            continue

        if op.type in ("pp_send", "pp_recv"):
            # pipeline boundary ops move values between pp shards and
            # re-bind the crossing names on the consuming stage; the names
            # keep their producers' specs (the pp axis is orthogonal to
            # the tp component being propagated — letting the default
            # replicated rule overwrite them manufactures conflicts on
            # pipelined tp-annotated programs)
            continue

        in_specs: Dict[str, List[Optional[tuple]]] = {}
        any_tp = False
        for slot, names in op.inputs.items():
            specs = [_spec_for(n) for n in names]
            in_specs[slot] = specs
            any_tp = any_tp or any(_is_sharded(s) for s in specs)

        actions = OpActions(op_idx=idx)
        sctx = ShardCtx(block=block, op=op, op_idx=idx, size=tp_size,
                        nominal_batch=nominal_batch, actions=actions,
                        diagnostics=res.diagnostics)

        out_specs: Dict[str, List[Optional[tuple]]] = {}
        if (op.attrs.get("op_role") == "optimize"
                and "Param" in op.inputs):
            out_specs = _optimize_rule(sctx, in_specs, op.attrs)
        elif not any_tp and lookup_shard_rule(op.type) is None:
            out_specs = {}                       # replicated fast path
        elif op.type in _CTRL_OPS and any_tp:
            sctx.conflict(
                f"control-flow op {op.type!r} consumes a tp-sharded "
                f"value; sub-block programs have no sharding model — "
                f"reshard or drop the annotation")
        else:
            rule = lookup_shard_rule(op.type)
            if rule is None:
                # GSPMD-style reshard-to-replicated fallback: correct, but
                # worth a warning — every gather is wire bytes
                gathered = []
                for slot, specs in in_specs.items():
                    for i, s in enumerate(specs):
                        if _is_sharded(s):
                            dim = next(d for d, a in enumerate(s)
                                       if a is not None)
                            sctx.gather_input(slot, i, dim)
                            gathered.append(op.inputs[slot][i])
                sctx.warn(
                    f"no sharding rule for op {op.type!r}: tp-sharded "
                    f"input(s) {gathered[:4]} will be all-gathered back "
                    f"to replicated (add a register_shard_spec rule to "
                    f"keep them sharded)")
            else:
                out_specs = rule(sctx, in_specs, dict(op.attrs)) or {}

        for slot, names in op.outputs.items():
            specs = out_specs.get(slot)
            for i, n in enumerate(names):
                s = specs[i] if specs is not None and i < len(specs) \
                    else None
                if s is None:
                    try:
                        v = block.var(n)
                        s = _repl(len(v.shape)) if v.shape is not None \
                            else None
                    except NotFoundError:
                        s = None
                # a seeded (annotated) var written with a different
                # sharding than its annotation is a conflict, not a
                # silent re-placement
                seeded = res.seeded.get(n)
                if seeded is not None and s is not None \
                        and tuple(seeded) != tuple(s):
                    sctx.conflict(
                        f"output {n!r} is annotated {list(seeded)} but "
                        f"the op produces sharding {list(s)}")
                    s = seeded
                if s is not None:
                    env[n] = s
        if actions.any():
            res.actions.append(actions)
    return res


def _optimize_rule(sctx, in_specs, attrs):
    """Optimizer ops update per-shard state elementwise: every output
    mirrors its same-named input slot (ParamOut <- Param, MomentOut <-
    Moment, ...); Grad and same-shaped accumulators must agree with Param's
    sharding."""
    pspec = in_specs.get("Param", [None])[0]
    pshape = sctx.in_shape("Param")
    for slot, specs in in_specs.items():
        if slot in ("Param", "LearningRate"):
            continue
        for i, s in enumerate(specs):
            if s is None or pspec is None:
                continue
            # only same-SHAPED state must agree (Beta1Pow-style [1]
            # scalars are replicated by construction)
            if sctx.op.inputs[slot][i:i + 1] and \
                    sctx.in_shape(slot, i) != pshape:
                continue
            if len(s) == len(pspec) and _is_sharded(s) != _is_sharded(pspec):
                sctx.conflict(
                    f"optimizer input {sctx.op.inputs[slot][i]!r} (slot "
                    f"{slot!r}) sharding {list(s)} disagrees with Param "
                    f"sharding {list(pspec) if pspec else None}")
    outs = {}
    for slot, names in sctx.op.outputs.items():
        src = slot[:-3] if slot.endswith("Out") else slot
        specs = in_specs.get(src) or in_specs.get("Param", [None])
        outs[slot] = [specs[i] if i < len(specs) else specs[0]
                      for i in range(len(names))]
    return outs


# ---------------------------------------------------------------------------
# propagation rules (registry.register_shard_spec — the sharding-layer
# sibling of register_infer_spec)
# ---------------------------------------------------------------------------


@register_shard_spec("mul")
def _shard_mul(sctx, in_specs, attrs):
    """fc matmul: [lead.., K] x [K, N]. Column-parallel (Y sharded on N):
    local matmul, output feature-sharded, replicated X wrapped in tp_ident.
    Row-parallel (Y sharded on K): X must arrive contraction-sharded (from
    a preceding column layer) or be split locally; the local product is a
    partial sum -> tp_allreduce."""
    xs = in_specs["X"][0]
    ys = in_specs["Y"][0]
    xd = int(attrs.get("x_num_col_dims", 1))
    yd = int(attrs.get("y_num_col_dims", 1))
    if xs is None or ys is None:
        return {}
    x_lead, x_con = list(xs[:xd]), list(xs[xd:])
    y_con, y_out = list(ys[:yd]), list(ys[yd:])
    y_con_sh = any(s is not None for s in y_con)
    y_out_sh = any(s is not None for s in y_out)
    if y_con_sh and y_out_sh:
        sctx.conflict("weight is sharded on BOTH its contraction and "
                      "output dims; shard exactly one")
        return {}
    if y_out_sh:                                   # column-parallel
        if any(s is not None for s in x_con):
            sctx.conflict(
                "column-parallel weight (output dim sharded) fed a "
                "contraction-sharded activation; only one side of the "
                "contraction may be sharded")
            return {}
        yshape = sctx.in_shape("Y")
        if yshape is not None:
            for d, s in zip(yshape[yd:], y_out):
                if s is not None:
                    sctx.check_divisible(d, "column-parallel output dim")
        sctx.ident_input("X", 0)
        return {"Out": [tuple(x_lead + y_out)]}
    if y_con_sh:                                   # row-parallel
        if len(y_con) != 1:
            sctx.conflict("row-parallel weight with y_num_col_dims > 1 "
                          "is unsupported")
            return {}
        xshape = sctx.in_shape("X")
        if xshape is not None:
            sctx.check_divisible(xshape[-1], "row-parallel contraction dim")
        if x_con and x_con[-1] is not None \
                and all(s is None for s in x_con[:-1]):
            pass                         # arrives sharded from column layer
        elif all(s is None for s in x_con):
            if len(x_con) != 1:
                sctx.conflict(
                    "row-parallel weight fed a flattened multi-dim "
                    "contraction; cannot split the activation locally")
                return {}
            sctx.split_input("X", 0, dim=len(xs) - 1)
        else:
            sctx.conflict(
                f"row-parallel contraction mismatch: activation spec "
                f"{list(xs)} does not align with weight spec {list(ys)}")
            return {}
        sctx.psum("Out", 0)
        return {"Out": [tuple(x_lead) + (None,) * len(y_out)]}
    # Y fully replicated
    if any(s is not None for s in x_con):
        sctx.gather_input("X", 0, dim=xd + next(
            k for k, s in enumerate(x_con) if s is not None))
        sctx.warn("contraction-sharded activation into a replicated "
                  "weight: all-gathering it back (annotate the weight "
                  "row-parallel to keep it sharded)")
        x_lead = [None] * len(x_lead)
    if any(s is not None for s in x_lead):
        sctx.ident_input("Y", 0)         # tp-data-parallel: w grad partial
    return {"Out": [tuple(x_lead) + (None,) * len(y_out)]}


@register_shard_spec("matmul")
def _shard_matmul(sctx, in_specs, attrs):
    """Batched matmul: batch dims sharded identically ride through
    (head-sharded attention); sharded contraction on both sides is a
    partial -> psum; mixed contraction sharding is a conflict."""
    xs, ys = in_specs["X"][0], in_specs["Y"][0]
    if xs is None or ys is None:
        return {}
    tx, ty = bool(attrs.get("transpose_X")), bool(attrs.get("transpose_Y"))
    if len(xs) < 2 or len(ys) < 2:
        return {}
    xm, xk = (xs[-1], xs[-2]) if tx else (xs[-2], xs[-1])
    yk, yn = (ys[-1], ys[-2]) if ty else (ys[-2], ys[-1])
    xb, yb = list(xs[:-2]), list(ys[:-2])
    nb = max(len(xb), len(yb))
    xb = [None] * (nb - len(xb)) + xb
    yb = [None] * (nb - len(yb)) + yb
    out_b = []
    for a, b in zip(xb, yb):
        if a is not None and b is not None and a != b:
            sctx.conflict(f"batched-matmul batch dims sharded "
                          f"inconsistently: {a} vs {b}")
        out_b.append(a if a is not None else b)
    out = tuple(out_b) + (xm, yn)
    if xk is not None and yk is not None:
        sctx.psum("Out", 0)
        return {"Out": [out]}
    if (xk is None) != (yk is None):
        sctx.conflict("matmul contraction dim sharded on one operand "
                      "only; shard both (partial+psum) or neither")
        return {}
    return {"Out": [out]}


def _shard_elementwise(sctx, in_specs, attrs):
    """Binary elementwise with the reference broadcast semantics: the
    output follows X; Y dims align trailing (axis=-1) or at `axis`. A
    sharded dim meeting a full-size replicated dim is a conflict (a
    sharded bias on a replicated activation — the classic annotation
    bug); a replicated broadcast operand entering a sharded result rides
    through (each shard broadcasts locally) but is tp_ident-wrapped so
    its backward cotangent is reduced."""
    xs = in_specs["X"][0]
    ys = in_specs["Y"][0]
    if xs is None:
        return {}
    if ys is None:
        return {"Out": [xs]}
    xshape = sctx.in_shape("X")
    yshape = sctx.in_shape("Y")
    axis = attrs.get("axis", -1)
    nx, ny = len(xs), len(ys)
    if axis is None or axis == -1:
        off = nx - ny                     # trailing-aligned
    else:
        off = int(axis)                   # leading-aligned at axis
    out = list(xs)
    y_broadcast_into_sharded = False
    x_broadcast_into_sharded = False
    for j in range(ny):
        d = off + j
        if d < 0 or d >= nx:
            continue
        xsp, ysp = xs[d], ys[j]
        x_sz = xshape[d] if xshape else None
        y_sz = yshape[j] if yshape else None
        if xsp is not None and ysp is None:
            if y_sz not in (1, None):
                sctx.conflict(
                    f"elementwise dim {d}: X is sharded but Y is "
                    f"replicated at full size {y_sz}; shard Y's dim the "
                    f"same way (or keep both replicated)")
            else:
                y_broadcast_into_sharded = True
        elif xsp is None and ysp is not None:
            if x_sz == 1:
                out[d] = ysp
                x_broadcast_into_sharded = True
            else:
                sctx.conflict(
                    f"elementwise dim {d}: Y is sharded but X is "
                    f"replicated at full size {x_sz}; shard X's dim the "
                    f"same way (or keep both replicated)")
    # a replicated broadcast operand entering a sharded result: its
    # backward cotangent sums over the sharded dim, so each shard's
    # contribution is partial — wrap with the f operator (both sides:
    # a size-1 X dim broadcast into a sharded Y dim is the mirror case)
    if _is_sharded(tuple(out)) and not _is_sharded(ys) \
            and (y_broadcast_into_sharded or ny < nx):
        sctx.ident_input("Y", 0)
    if _is_sharded(tuple(out)) and not _is_sharded(xs) \
            and x_broadcast_into_sharded:
        sctx.ident_input("X", 0)
    return {"Out": [tuple(out)]}


for _t in ("elementwise_add", "elementwise_sub", "elementwise_mul",
           "elementwise_div", "elementwise_max", "elementwise_min",
           "elementwise_pow", "less_than", "less_equal", "greater_than",
           "greater_equal", "equal", "not_equal"):
    register_shard_spec(_t)(_shard_elementwise)


def _shard_passthrough(sctx, in_specs, attrs):
    """Elementwise unary: every output mirrors X's sharding."""
    xs = in_specs.get("X", [None])[0]
    return {slot: [xs] * len(names)
            for slot, names in sctx.op.outputs.items()}


for _t in ("relu", "gelu", "tanh", "sigmoid", "exp", "log", "sqrt",
           "rsqrt", "square", "abs", "scale", "cast", "clip", "dropout",
           "softsign", "softplus", "leaky_relu", "relu6", "elu",
           "fill_zeros_like", "assign"):
    register_shard_spec(_t)(_shard_passthrough)


@register_shard_spec("sum")
def _shard_sum(sctx, in_specs, attrs):
    specs = in_specs.get("X", [])
    base = next((s for s in specs if s is not None), None)
    for s in specs:
        if s is not None and base is not None and tuple(s) != tuple(base):
            sctx.conflict(f"sum inputs sharded inconsistently: "
                          f"{list(s)} vs {list(base)}")
    return {"Out": [base]}


@register_shard_spec("reshape")
def _shard_reshape(sctx, in_specs, attrs):
    """Greedy factor-matching between in and out shapes: a sharded dim
    that maps 1:1 keeps its axis; a sharded dim that splits shards the
    OUTERMOST out dim of its group (head split: [B,T,D@tp] ->
    [B,T,nh@tp,dh]); a merged group may only be sharded on its outermost
    dim (head merge back). Anything else is a conflict."""
    xs = in_specs["X"][0]
    if xs is None or not _is_sharded(xs):
        out_shape = sctx.shape_of(sctx.op.outputs["Out"][0])
        return {"Out": [_repl(len(out_shape)) if out_shape else None]}
    in_shape = sctx.in_shape("X")
    out_shape = sctx.shape_of(sctx.op.outputs["Out"][0])
    if in_shape is None or out_shape is None:
        sctx.conflict("reshape of a tp-sharded value with undeclared "
                      "shapes cannot be propagated")
        return {}
    out = [None] * len(out_shape)
    i = j = 0
    ok = True
    while i < len(in_shape) and j < len(out_shape) and ok:
        gi, gj = [i], [j]
        pa, pb = in_shape[i], out_shape[j]
        while pa != pb:
            if pa < pb and gi[-1] + 1 < len(in_shape):
                gi.append(gi[-1] + 1)
                pa *= in_shape[gi[-1]]
            elif pa > pb and gj[-1] + 1 < len(out_shape):
                gj.append(gj[-1] + 1)
                pb *= out_shape[gj[-1]]
            else:
                ok = False
                break
        if not ok:
            break
        sharded = [k for k in gi if xs[k] is not None]
        if sharded:
            k = sharded[0]
            if len(sharded) > 1:
                sctx.conflict("reshape merges two tp-sharded dims")
            elif len(gi) == 1 and len(gj) == 1:
                out[gj[0]] = xs[k]
            elif k != gi[0]:
                sctx.conflict(
                    f"reshape: sharded dim {k} is not the outermost of "
                    f"its factor group {gi} -> {gj}; the local chunks "
                    f"would interleave")
            else:
                if sctx.check_divisible(out_shape[gj[0]],
                                        "reshape split of a sharded dim"):
                    out[gj[0]] = xs[k]
        i, j = gi[-1] + 1, gj[-1] + 1
    if not ok:
        sctx.conflict("reshape factor groups do not align; cannot "
                      "propagate the tp sharding through")
        return {}
    return {"Out": [tuple(out)]}


@register_shard_spec("transpose")
def _shard_transpose(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    perm = list(attrs.get("axis", range(len(xs))))
    return {"Out": [tuple(xs[p] for p in perm)]}


@register_shard_spec("unsqueeze")
def _shard_unsqueeze(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    out = list(xs)
    for a in sorted(int(a) for a in attrs.get("axes", ())):
        a = a if a >= 0 else a + len(out) + 1
        out.insert(a, None)
    return {"Out": [tuple(out)]}


@register_shard_spec("squeeze")
def _shard_squeeze(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    axes = [int(a) if a >= 0 else int(a) + len(xs)
            for a in attrs.get("axes", ())]
    out = [s for d, s in enumerate(xs) if d not in axes]
    return {"Out": [tuple(out)]}


@register_shard_spec("softmax")
def _shard_softmax(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    ax = int(attrs.get("axis", -1))
    if xs[ax] is not None:
        sctx.conflict("softmax over a tp-sharded axis cannot be computed "
                      "locally; keep the normalized axis replicated")
    return {"Out": [xs]}


@register_shard_spec("log_softmax")
def _shard_log_softmax(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    if xs[-1] is not None:
        sctx.conflict("log_softmax over a tp-sharded axis cannot be "
                      "computed locally")
    return {"Out": [xs]}


@register_shard_spec("layer_norm")
def _shard_layer_norm(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    begin = int(attrs.get("begin_norm_axis", 1))
    if any(s is not None for s in xs[begin:]):
        sctx.conflict("layer_norm normalizes over a tp-sharded dim; "
                      "normalization axes must stay replicated "
                      "(psum the activation first — Megatron row-parallel)")
    for slot in ("Scale", "Bias"):
        s = in_specs.get(slot, [None])[0]
        if _is_sharded(s):
            sctx.conflict(f"layer_norm {slot} is tp-sharded but the "
                          f"normalized activation is replicated")
    return {"Y": [xs], "Mean": [tuple(xs[:begin])],
            "Variance": [tuple(xs[:begin])]}


@register_shard_spec("softmax_with_cross_entropy")
def _shard_sce(sctx, in_specs, attrs):
    ls = in_specs["Logits"][0]
    if ls is None:
        return {}
    if ls[-1] is not None:
        sctx.conflict("softmax_with_cross_entropy over tp-sharded logits "
                      "is unsupported; the row-parallel lm head psums "
                      "logits back to replicated first")
        return {}
    return {"Loss": [tuple(ls[:-1]) + (None,)], "Softmax": [ls]}


@register_shard_spec("fused_attention")
def _shard_fused_attention(sctx, in_specs, attrs):
    qs = in_specs["Q"][0]
    ks = in_specs["K"][0]
    vs = in_specs["V"][0]
    if qs is None:
        return {}
    for name, s in (("K", ks), ("V", vs)):
        if s is not None and tuple(s) != tuple(qs):
            sctx.conflict(f"fused_attention {name} sharding {list(s)} "
                          f"!= Q sharding {list(qs)}")
    if len(qs) >= 2 and any(s is not None for s in qs[-2:]):
        sctx.conflict("fused_attention sequence/head-depth dims may not "
                      "be tp-sharded (shard the head COUNT dim)")
    return {"Out": [qs]}


@register_shard_spec("lookup_table")
def _shard_lookup_table(sctx, in_specs, attrs):
    ws = in_specs["W"][0]
    ids_shape = sctx.in_shape("Ids")
    rank = len(ids_shape) if ids_shape else 2
    if ids_shape and len(ids_shape) >= 2 and ids_shape[-1] == 1:
        rank -= 1
    if ws is None or not _is_sharded(ws):
        # a replicated table: each output row is its id's row, so the
        # output keeps the ids' split (the data axes split the ids)
        ids = (in_specs.get("Ids") or [None])[0]
        if ids is None or not _is_sharded(ids) or ws is None:
            return {}
        return {"Out": [tuple(ids[:rank]) + (None,) * (len(ws) - 1)]}
    if ws[0] is not None and any(s is not None for s in ws[1:]):
        sctx.conflict("embedding table sharded on BOTH vocab and feature "
                      "dims; shard exactly one")
        return {}
    if ws[0] is not None:
        # vocab-row-sharded (the EP analogue): masked local lookup +
        # psum, executed by the tp_vocab_lookup op
        wshape = sctx.in_shape("W")
        if wshape:
            sctx.check_divisible(wshape[0], "vocab-sharded embedding")
        sctx.replace_op("tp_vocab_lookup")
        return {"Out": [(None,) * rank + (None,) * (len(ws) - 1)]}
    # feature-column-sharded: local lookup, output feature-sharded
    return {"Out": [(None,) * rank + tuple(ws[1:])]}


def _reduce_dims(attrs, rank):
    dims = attrs.get("dim")
    if dims is None:
        return list(range(rank))
    if isinstance(dims, (int, np.integer)):
        dims = [dims]
    return [int(d) if d >= 0 else int(d) + rank for d in dims]


@register_shard_spec("reduce_sum")
def _shard_reduce_sum(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    dims = _reduce_dims(attrs, len(xs))
    if any(xs[d] is not None for d in dims):
        sctx.psum("Out", 0)          # local sum is a partial over tp
    keep = bool(attrs.get("keep_dim", False))
    if keep:
        out = tuple(None if d in dims else s for d, s in enumerate(xs))
    else:
        out = tuple(s for d, s in enumerate(xs) if d not in dims)
    return {"Out": [out]}


@register_shard_spec("reduce_mean")
def _shard_reduce_mean(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if xs is None:
        return {}
    dims = _reduce_dims(attrs, len(xs))
    if any(xs[d] is not None for d in dims):
        sctx.conflict("reduce_mean over a tp-sharded dim is unsupported; "
                      "psum the value back to replicated first")
        return {}
    keep = bool(attrs.get("keep_dim", False))
    if keep:
        out = tuple(None if d in dims else s for d, s in enumerate(xs))
    else:
        out = tuple(s for d, s in enumerate(xs) if d not in dims)
    return {"Out": [out]}


@register_shard_spec("mean")
def _shard_mean(sctx, in_specs, attrs):
    xs = in_specs["X"][0]
    if _is_sharded(xs):
        sctx.conflict("mean over a tp-sharded value is unsupported; psum "
                      "it back to replicated first")
    return {"Out": [()]}


@register_shard_spec("concat")
def _shard_concat(sctx, in_specs, attrs):
    specs = in_specs.get("X", [])
    base = next((s for s in specs if _is_sharded(s)), None)
    if base is None:
        return {}
    ax = int(attrs.get("axis", 0))
    if base[ax] is not None:
        sctx.conflict("concat along a tp-sharded axis is unsupported")
    for s in specs:
        if s is not None and tuple(s) != tuple(base):
            sctx.conflict(f"concat inputs sharded inconsistently: "
                          f"{list(s)} vs {list(base)}")
    return {"Out": [base]}


# explicit-pipeline ops (present when linting a dp-comm/pipeline-rewritten
# program): shardings ride through untouched
@register_shard_spec("dp_grad_comm")
def _shard_dp_grad_comm(sctx, in_specs, attrs):
    return {"Out": list(in_specs.get("X", [])),
            "ErrOut": list(in_specs.get("ErrIn", []))}


@register_shard_spec("dp_shard_slice")
def _shard_dp_shard_slice(sctx, in_specs, attrs):
    return {"Out": [in_specs["X"][0]]}


@register_shard_spec("dp_shard_all_gather")
def _shard_dp_shard_all_gather(sctx, in_specs, attrs):
    return {"Out": [in_specs["X"][0]]}


@register_shard_spec("pp_send")
def _shard_pp_send(sctx, in_specs, attrs):
    return {"Out": [(None,)]}


@register_shard_spec("pp_recv")
def _shard_pp_recv(sctx, in_specs, attrs):
    # re-binds crossing names: their specs are already in the environment
    return {}


# ---------------------------------------------------------------------------
# tp_shard_pass: make the propagated shardings executable
# ---------------------------------------------------------------------------


@register_pass("tp_shard_pass")
class TpShardPass(Pass):
    """Splice explicit tp collectives into a tp-annotated program so the
    ParallelExecutor's ranks compute exactly the single-device math
    (the way comm_optimize_pass splices dp_grad_comm). attrs:

      tp: the tp mesh-axis size (local shapes divide by it).
      nominal_batch: stand-in for -1 dims in divisibility checks.

    The rewrite, per propagated action:
      - partial-sum outputs are renamed to <name>@TPPART and a
        ``tp_allreduce`` restores <name> (row-parallel psum);
      - replicated activations entering sharded compute are wrapped in
        ``tp_ident`` (identity fwd / psum bwd — Megatron's f), deduped per
        variable so one backward all-reduce serves all consumers;
      - replicated operands of a row-parallel contraction are sliced with
        ``tp_split`` (fwd slice / bwd all-gather — Megatron's lm-head
        entry);
      - rule-less consumers of sharded values get a ``tp_allgather``
        reshard;
      - vocab-sharded embedding lookups become ``tp_vocab_lookup``.

    Every tp-sharded variable (params, activations, their grads) is marked
    with ``tp_spec``; vjp_region fwd_ops indices are re-mapped around the
    insertions. Raises on propagation conflicts; a clean no-annotation
    program is returned untouched."""

    allowed_attrs = ("tp", "nominal_batch")

    def apply(self, program, scope=None):
        from ..parallel import tensor_parallel  # registers the tp_* ops
        tp = int(self.attrs["tp"])
        enforce(tp >= 2, f"tp_shard_pass needs tp >= 2, got {tp}",
                exc=InvalidArgumentError)
        if getattr(program, "_tp_applied", False):
            return program
        if not has_tp_annotations(program):
            return program
        nb = int(self.attrs.get("nominal_batch", BATCH_SENTINEL))
        res = propagate_sharding(program, tp_size=tp, nominal_batch=nb)
        if res.errors:
            raise ProgramAnalysisError(
                "tp_shard_pass: sharding propagation found conflicts:\n  "
                + "\n  ".join(str(d) for d in res.errors), res.errors)

        out = program.clone()
        out._dp_comm_applied = getattr(program, "_dp_comm_applied", False)
        block = out.global_block()
        sharded = res.sharded_vars()

        from .lowering import grad_var_name
        for name, spec in sharded.items():
            v = block.vars.get(name)
            if v is not None:
                v.tp_spec = tuple(spec)
            g = block.vars.get(grad_var_name(name))
            if g is not None and g.shape == (v.shape if v else None):
                g.tp_spec = tuple(spec)

        actions_by_idx = {a.op_idx: a for a in res.actions}
        pre_by_idx: Dict[int, List[Operator]] = {}
        post_by_idx: Dict[int, List[Operator]] = {}
        derived: Dict[Tuple[str, str], str] = {}   # (kind, src) -> name

        def _local_shape(name):
            v = block.vars.get(name)
            if v is None or v.shape is None:
                return None
            return list(tp_local_shape(
                v.shape, sharded.get(name), tp))

        def _mk_var(name, like, tp_spec=None):
            src = block.var(like)
            nv = block.create_var(name=name, shape=src.shape,
                                  dtype=src.dtype)
            nv.stop_gradient = bool(getattr(src, "stop_gradient", False))
            if tp_spec is not None and _is_sharded(tp_spec):
                nv.tp_spec = tuple(tp_spec)
            return nv

        n_psum = 0
        for idx, op in sorted(actions_by_idx.items()):
            a = actions_by_idx[idx]
            oper = block.ops[idx]
            if a.replace == "tp_vocab_lookup":
                wname = oper.inputs["W"][0]
                wshape = block.var(wname).shape
                oper.attrs = dict(oper.attrs)
                oper.attrs.update({"axis": TP_AXIS, "parts": tp,
                                   "vocab": int(wshape[0])})
                oper.type = "tp_vocab_lookup"
            for slot, i, dim in a.splits:
                src = oper.inputs[slot][i]
                key = ("split%d" % dim, src)
                nname = derived.get(key)
                if nname is None:
                    nname = src + TP_SPLIT_SUFFIX
                    spec = [None] * len(block.var(src).shape or ())
                    spec[dim] = TP_AXIS
                    _mk_var(nname, src, tp_spec=tuple(spec))
                    pre_by_idx.setdefault(idx, []).append(Operator(
                        block, "tp_split", inputs={"X": [src]},
                        outputs={"Out": [nname]},
                        attrs={"axis": TP_AXIS, "dim": dim, "parts": tp,
                               "op_role": oper.attrs.get("op_role")}))
                    derived[key] = nname
                oper.inputs[slot] = list(oper.inputs[slot])
                oper.inputs[slot][i] = nname
            for slot, i in a.idents:
                src = oper.inputs[slot][i]
                key = ("ident", src)
                nname = derived.get(key)
                if nname is None:
                    nname = src + TP_IDENT_SUFFIX
                    _mk_var(nname, src, tp_spec=sharded.get(src))
                    pre_by_idx.setdefault(idx, []).append(Operator(
                        block, "tp_ident", inputs={"X": [src]},
                        outputs={"Out": [nname]},
                        attrs={"axis": TP_AXIS,
                               "op_role": oper.attrs.get("op_role")}))
                    derived[key] = nname
                oper.inputs[slot] = list(oper.inputs[slot])
                oper.inputs[slot][i] = nname
            for slot, i, dim in a.gathers:
                src = oper.inputs[slot][i]
                key = ("gather", src)
                nname = derived.get(key)
                if nname is None:
                    nname = src + TP_GATHER_SUFFIX
                    _mk_var(nname, src)       # replicated (global shape)
                    pre_by_idx.setdefault(idx, []).append(Operator(
                        block, "tp_allgather", inputs={"X": [src]},
                        outputs={"Out": [nname]},
                        attrs={"axis": TP_AXIS, "dim": dim, "parts": tp,
                               "op_role": oper.attrs.get("op_role")}))
                    derived[key] = nname
                oper.inputs[slot] = list(oper.inputs[slot])
                oper.inputs[slot][i] = nname
            for slot, i in a.psums:
                out_name = oper.outputs[slot][i]
                part = out_name + TP_PART_SUFFIX
                _mk_var(part, out_name)
                oper.outputs[slot] = list(oper.outputs[slot])
                oper.outputs[slot][i] = part
                post_by_idx.setdefault(idx, []).append(Operator(
                    block, "tp_allreduce", inputs={"X": [part]},
                    outputs={"Out": [out_name]},
                    attrs={"axis": TP_AXIS,
                           "op_role": oper.attrs.get("op_role")}))
                n_psum += 1

        # --- localize shape-bearing attrs on the sharded path ------------
        # reshape carries its target shape as a concrete attr; per-shard
        # execution sees the tp-local input, so sharded target dims divide
        # by tp (the head-split [B,T,D@tp] -> [B,T,nh/tp,dh] case)
        for op in block.ops:
            if op.type != "reshape":
                continue
            spec = sharded.get(op.outputs["Out"][0])
            if not spec:
                continue
            shape = list(op.attrs.get("shape", ()))
            for d, s in enumerate(spec):
                if s is not None and d < len(shape) and shape[d] > 0:
                    enforce(shape[d] % tp == 0,
                            f"reshape target dim {d} ({shape[d]}) not "
                            f"divisible by tp={tp}",
                            exc=InvalidArgumentError)
                    shape[d] //= tp
            op.attrs = dict(op.attrs)
            op.attrs["shape"] = shape

        # --- rebuild the op list with the insertions ---------------------
        new_ops: List[Operator] = []
        inserted_anchor: Dict[int, int] = {}       # id(new op) -> old idx
        for idx, op in enumerate(block.ops):
            for nop in pre_by_idx.get(idx, ()):
                inserted_anchor[id(nop)] = idx
                new_ops.append(nop)
            new_ops.append(op)
            for nop in post_by_idx.get(idx, ()):
                inserted_anchor[id(nop)] = idx
                new_ops.append(nop)
        newidx = {id(op): i for i, op in enumerate(new_ops)}

        # re-map region fwd_ops: old indices -> new, plus inserted ops
        # anchored inside the segment (the collectives ARE forward ops)
        for op in new_ops:
            if op.type not in _REGION_TYPES:
                continue
            seg = set(int(i) for i in op.attrs.get("fwd_ops", ()))
            mapped = [newidx[id(block.ops[i])] for i in sorted(seg)]
            for nop_id, anchor in inserted_anchor.items():
                if anchor in seg:
                    mapped.append(newidx[nop_id])
            op.attrs["fwd_ops"] = sorted(mapped)
        block.ops = new_ops

        out._bump()
        out._tp_applied = True
        out._tp_size = tp
        out._tp_n_collectives = n_psum
        return out


# ---------------------------------------------------------------------------
# analytic wire model (ring accounting, shared discipline with
# grad_comm.analytic_wire_bytes)
# ---------------------------------------------------------------------------


def _var_numel(block, name, nominal_batch):
    v = block.vars.get(name)
    if v is None or v.shape is None:
        return 0
    n = 1
    for d in _subst(v.shape, nominal_batch):
        n *= d
    return n


def tp_analytic_wire_bytes(program: Program, tp: int,
                           nominal_batch: int = 8) -> Optional[Dict]:
    """Per-device interconnect bytes per TRAIN step of the tp collectives a
    tp_shard_pass-rewritten program executes (the JAX package's model:
    its figures are equal). Ring accounting:

      tp_allreduce (fwd psum):        2 n (tp-1)/tp
      tp_ident (BWD psum of its
        cotangent, same numel):       2 n (tp-1)/tp
      tp_split (BWD all-gather of
        the full cotangent):            n (tp-1)/tp
      tp_allgather (fwd):               n (tp-1)/tp
      tp_vocab_lookup (fwd psum):     2 n_out (tp-1)/tp

    Sizes are LOCAL-shape-independent (psum/all-gather outputs are the
    replicated/global tensors). -1 dims count as `nominal_batch` rows.
    Backward entries are counted only when their input is differentiable
    (stop_gradient values never get a cotangent). Returns None for
    programs the pass did not rewrite."""
    if not getattr(program, "_tp_applied", False):
        return None
    block = program.global_block()
    f = (tp - 1) / tp
    ar = ag = 0.0
    counts = {"tp_allreduce": 0, "tp_ident": 0, "tp_split": 0,
              "tp_allgather": 0, "tp_vocab_lookup": 0}
    for op in block.ops:
        if op.type not in counts:
            continue
        counts[op.type] += 1
        if op.type in ("tp_allreduce", "tp_vocab_lookup"):
            n = _var_numel(block, op.outputs["Out"][0], nominal_batch)
            ar += 2.0 * n * 4 * f
        elif op.type == "tp_ident":
            src = block.vars.get(op.inputs["X"][0])
            if src is not None and not getattr(src, "stop_gradient", False):
                n = _var_numel(block, op.inputs["X"][0], nominal_batch)
                ar += 2.0 * n * 4 * f
        elif op.type == "tp_split":
            src = block.vars.get(op.inputs["X"][0])
            if src is not None and not getattr(src, "stop_gradient", False):
                n = _var_numel(block, op.inputs["X"][0], nominal_batch)
                ag += n * 4 * f
        elif op.type == "tp_allgather":
            n = _var_numel(block, op.outputs["Out"][0], nominal_batch)
            ag += n * 4 * f
    return {"tp": tp,
            "tp_allreduce_wire_bytes": int(ar),
            "tp_allgather_wire_bytes": int(ag),
            "tp_wire_bytes": int(ar + ag),
            "tp_op_counts": counts}
