"""Static program analysis over the Program IR.

≙ paddle_tpu/framework/analysis.py, line for line but for the shape
mechanism: where the JAX package abstract-evaluates a lowering with
`jax.eval_shape`, the port runs the lowering itself on `device="meta"`
tensors, which carry shape and dtype and no storage. A meta tensor is not
`is_cuda`, so a kernel wrapper takes its plain version's shape logic and
computes nothing; an op that reads a value on the host (`.item()`,
`.tolist()`) fails on meta as it fails under `eval_shape`, and degrades to
its declared outputs with an `infer-error` warning. The port keeps int64
and float64 (ROADMAP.md §3, deliberate differences), so its inferred types
are the declared 64-bit types where the JAX package's are 32-bit. Types
are `ShapeDtype(shape, dtype)` pairs with a torch dtype.

Three cooperating layers (≙ the reference's multi_devices_check_pass +
ir::HasCircle asserts and each OpMaker's InferShape, plus the role the HLO
verifier plays between XLA passes; TVM's typed/verifiable IR treats the same
checks as the precondition for safe graph rewriting):

1. **Shape/dtype inference** (`infer_program`): propagates ShapeDtypeStructs
   block-by-block through the op DAG *before* trace time and cross-checks
   every inferred output against the declared `Variable.shape`/`dtype`,
   reporting mismatches with `block/op#/op.type` provenance. The default
   per-op rule runs the registered lowering itself on meta tensors — the
   lowering IS the shape function, so rule and kernel
   cannot drift; explicit `infer_spec` rules (registry.py) cover ops whose
   lowering cannot run standalone (mesh collectives, region pseudo-ops).
   Symbolic batch dims (-1) ride through as a sentinel prime and are
   rendered back as ``B`` in diagnostics.

2. **Structural + parallel consistency verification** (`verify_program`):
   def-before-use (absorbing the old CheckPass), duplicate-writer hazards,
   region attribute schemas, and the parallel invariants — every `pp_send`
   paired with its `pp_recv` across a stage boundary, `dp_grad_comm` sitting
   between the backward region and every gradient consumer, dp divisibility
   of sharded gradients.

2b. **Dataflow detectors** (framework/dataflow.py, run inside
   `verify_program`): SPMD collective-consistency/deadlock checks, GSPMD-
   style replica-divergence taint propagation, and buffer-reuse/WAR race
   checks over the variable interference graph. Pure Python over the IR —
   the sanitizer gets them on every pass apply.

3. **Pass sanitizer** (`sanitized_apply`, wired into `Pass.__call__`): every
   pass apply runs verify-before/verify-after, attributing any NEW violation
   to the offending pass by name. Always on; kill switch
   ``PTPU_VERIFY_PASSES=0``.

`analyze_program` runs layers 1+2; `check_program` raises on errors.
`python -m paddle_tpu_torch.tools.lint_program` is the CLI over all of it.
"""

from __future__ import annotations

import re as _re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from collections import namedtuple

import numpy as np
import torch

from ..core import flags
from ..core.dtypes import convert_dtype, dtype_name
from ..core.enforce import EnforceError, NotFoundError, enforce
from .program import Block, Operator, Program

__all__ = [
    "BATCH_SENTINEL", "Diagnostic", "InferCtx", "InferResult",
    "INFER_WAIVED", "PassSanitizerError", "ProgramAnalysisError",
    "ShapeDtype",
    "analyze_program", "check_program", "infer_coverage", "infer_op",
    "infer_program", "op_loc", "peak_live_bytes", "sanitized_apply",
    "sanitizer_enabled", "verify_program",
]

#: an inferred type: shape tuple and torch dtype (≙ jax.ShapeDtypeStruct)
ShapeDtype = namedtuple("ShapeDtype", ["shape", "dtype"])

# Sentinel stand-in for the symbolic -1 batch dim: a prime large enough not
# to collide with real layer widths in practice, small enough that lowerings
# which loop over a (mis-declared) batch-led dim stay cheap to trace.
BATCH_SENTINEL = 61

flags.define_bool(
    "verify_passes", True,
    "Run the structural program verifier before/after every Pass apply and "
    "attribute new violations to the pass by name (the role the HLO "
    "verifier plays between XLA passes). Kill switch: PTPU_VERIFY_PASSES=0.")


# ---------------------------------------------------------------------------
# diagnostics
# ---------------------------------------------------------------------------


def op_loc(block: Block, idx: int, op: Operator) -> str:
    """Shared op-provenance formatter: ``block 0 op#12 'matmul'``. Used by
    every analyzer diagnostic and by the enforce raises in passes.py /
    grad_comm.py / pipeline.py, so errors from all layers read the same."""
    return f"block {block.idx} op#{idx} {op.type!r}"


@dataclass
class Diagnostic:
    code: str        # stable kebab-case id, e.g. "shape-mismatch"
    loc: str         # op_loc(...) or a var name
    message: str
    severity: str = "error"      # "error" | "warning"

    def __str__(self):
        return f"[{self.code}] {self.loc}: {self.message}"


class ProgramAnalysisError(EnforceError):
    """Raised by check_program when analysis finds error-severity
    diagnostics."""

    def __init__(self, msg, diagnostics=()):
        super().__init__(msg)
        self.diagnostics = list(diagnostics)


class PassSanitizerError(ProgramAnalysisError):
    """A pass apply introduced NEW verifier violations; carries the pass
    name (≙ the HLO verifier failing between two XLA passes)."""

    def __init__(self, pass_name, diagnostics):
        self.pass_name = pass_name
        super().__init__(
            f"pass {pass_name!r} broke program invariants "
            f"(PTPU_VERIFY_PASSES verify-after):\n  "
            + "\n  ".join(str(d) for d in diagnostics), diagnostics)


# ---------------------------------------------------------------------------
# shape/dtype inference
# ---------------------------------------------------------------------------

# Ops the engine interprets itself instead of calling a spec/lowering.
_REGION_OPS = frozenset({"vjp_region", "pp_pipeline_region"})

# Ops with no standalone shape semantics: sub-block control flow binds inner
# vars via attrs at lowering time, TensorArray ops need the array
# environment. Their outputs fall back to the declared var shapes (still
# cross-checkable by downstream consumers). Every entry carries its reason —
# test_op_coverage.py enforces the waiver list stays small (>= 90% of the
# registry must infer).
INFER_WAIVED: Dict[str, str] = {
    "cond_block": "sub-block control flow: shapes live in the bound block",
    "lazy_cond": "sub-block control flow: shapes live in the bound block",
    "while": "sub-block control flow: loop-carried shapes are bound vars",
    "switch_case": "sub-block control flow: shapes live in the bound blocks",
    "static_rnn": "sub-block control flow: step/memory shapes are bound vars",
    "array_read": "TensorArray environment: element shape is array state",
    "array_write": "TensorArray environment: element shape is array state",
    "array_length": "TensorArray environment: length is array state",
}


def _tp_localized(v, shape, program) -> tuple:
    """tp-sharded vars (tp_shard_pass marks them with `tp_spec`) are
    declared at their GLOBAL shape but run on each rank at the tp-local
    shape: the sharded dims divided by the program's tp size
    (framework/sharding.py tp_local_shape, the rule the comm planner
    shares)."""
    tp = int(getattr(program, "_tp_size", 0) or 0)
    spec = getattr(v, "tp_spec", None)
    if tp <= 1 or not spec or not getattr(program, "_tp_applied", False):
        return tuple(shape)
    from .sharding import tp_local_shape
    return tp_local_shape(tuple(shape), spec, tp)


@dataclass
class InferCtx:
    """Context handed to explicit infer_spec rules (≙ InferShapeContext)."""
    block: Block
    op: Operator
    op_idx: int
    nominal_batch: int = BATCH_SENTINEL
    extras: dict = field(default_factory=dict)

    def declared(self, name: str) -> Optional[Tuple[tuple, Any]]:
        """(shape, dtype) of a declared var with -1 -> sentinel (and
        tp-sharded dims localized), or None."""
        try:
            v = self.block.var(name)
        except NotFoundError:
            return None
        if v.shape is None:
            return None
        shape = _tp_localized(v, _subst(v.shape, self.nominal_batch),
                              self.block.program)
        return (shape, convert_dtype(v.dtype))


def _subst(shape, nominal_batch) -> tuple:
    return tuple(nominal_batch if d == -1 else int(d) for d in shape)


def _render_dim(d, nominal_batch) -> str:
    if d == nominal_batch:
        return "B"
    if d and d % nominal_batch == 0:
        return f"{d // nominal_batch}*B"
    return str(d)


def _render_shape(shape, nominal_batch) -> str:
    return "[" + ", ".join(_render_dim(d, nominal_batch) for d in shape) + "]"


def _canon_dtype(dt):
    """The dtype a declared type runs in: the port keeps 64-bit types (the
    JAX package with x64 off narrows them to 32-bit)."""
    return convert_dtype(dt)


def _dtypes_compatible(inferred, declared) -> bool:
    """Canonicalized-dtype equality, with one sanctioned relaxation: the
    mixed-precision matmul/conv path (use_bf16) legitimately computes
    bfloat16 values for vars declared float32 — the declaration is the
    LOGICAL dtype, the bf16 residency is an execution detail the next
    fp32 op absorbs. Everything else (int where float was declared, bool
    leaking into arithmetic) is a real lie and reports."""
    ci, cd = _canon_dtype(inferred), _canon_dtype(declared)
    if ci == cd:
        return True
    bf16_pair = {dtype_name(ci), dtype_name(cd)}
    return bf16_pair == {"bfloat16", "float32"}


_MEMO: Dict[tuple, Any] = {}


def _lower_ctx():
    """A LowerCtx on the meta device. Random ops draw with no generator
    (a meta generator does not exist; a meta draw is only a shape)."""
    from .registry import LowerCtx

    class _MetaCtx(LowerCtx):
        def generator(self, seed: int = 0):
            return None

    return _MetaCtx(device=torch.device("meta"))


def _meta(struct):
    return torch.empty(tuple(struct.shape), dtype=convert_dtype(struct.dtype),
                       device="meta")


def _struct(v):
    """An output of a lowering run on meta tensors as a ShapeDtype (None
    for a value with no shape: the slot stays unknown)."""
    if v is None or not hasattr(v, "shape") or not hasattr(v, "dtype"):
        return None
    try:
        dt = convert_dtype(v.dtype)
    except Exception:  # noqa: BLE001 — not a tensor type
        return None
    return ShapeDtype(tuple(int(d) for d in v.shape), dt)


def infer_op(op_type: str, in_structs: Dict[str, List[Any]],
             attrs: Dict[str, Any], ictx: Optional[InferCtx] = None
             ) -> Dict[str, List[Any]]:
    """Infer output ShapeDtypeStructs of one op from input structs.

    Uses the op's explicit `infer_spec` when registered, else derives the
    result by running the lowering on meta tensors (no FLOPs, no buffers).
    in_structs: slot -> list of ShapeDtype (or anything with .shape /
    .dtype). Raises on ops in INFER_WAIVED."""
    from .registry import lookup_op

    if op_type in INFER_WAIVED:
        raise NotImplementedError(
            f"op {op_type!r} is waived from static inference: "
            f"{INFER_WAIVED[op_type]}")
    opdef = lookup_op(op_type)
    in_structs = {k: [ShapeDtype(tuple(v.shape), convert_dtype(v.dtype))
                      for v in vs] for k, vs in in_structs.items()}
    if opdef.infer_spec is not None:
        in_shapes = {k: [tuple(v.shape) for v in vs]
                     for k, vs in in_structs.items()}
        in_dtypes = {k: [v.dtype for v in vs]
                     for k, vs in in_structs.items()}
        out = opdef.infer_spec(ictx, in_shapes, in_dtypes, dict(attrs))
        return {k: [ShapeDtype(tuple(s), convert_dtype(d))
                    for s, d in vs] for k, vs in out.items()}

    # memoize derived results: real programs repeat the same op shape
    # (every resnet block's conv)
    memo_key = None
    try:
        attr_key = tuple(sorted((k, v if not isinstance(v, (list, np.ndarray))
                                 else repr(np.asarray(v).tolist()))
                                for k, v in attrs.items()))
        memo_key = (op_type, attr_key,
                    tuple((k, tuple((tuple(v.shape), str(v.dtype))
                                    for v in vs))
                          for k, vs in sorted(in_structs.items())))
        hash(memo_key)
    except TypeError:
        memo_key = None
    if memo_key is not None and memo_key in _MEMO:
        return _MEMO[memo_key]

    ctx = _lower_ctx()
    ctx.is_test = bool(attrs.get("is_test", False))

    ins = {k: [_meta(v) for v in vs] for k, vs in in_structs.items()}
    with torch.no_grad():
        raw = opdef.lower(ctx, ins, dict(attrs)) or {}
    out = {k: [_struct(v) for v in (vs if isinstance(vs, (list, tuple))
                                    else [vs])]
           for k, vs in raw.items()}
    if memo_key is not None:
        _MEMO[memo_key] = out
    return out


@dataclass
class InferResult:
    types: Dict[Tuple[int, str], Any]      # (block idx, var name) -> struct
    diagnostics: List[Diagnostic]
    n_ops: int = 0
    n_inferred: int = 0
    n_skipped: int = 0

    @property
    def errors(self):
        return [d for d in self.diagnostics if d.severity == "error"]


def _shapes_compatible(inferred: tuple, declared: tuple) -> bool:
    if len(inferred) != len(declared):
        # a declared leading batch dim of -1 with the value reshaped flat
        # is still a mismatch; ranks must agree
        return False
    for di, dd in zip(inferred, declared):
        if dd == -1:
            continue                       # declared wildcard
        if di == dd:
            continue
        return False
    return True


def infer_program(program: Program, nominal_batch: int = BATCH_SENTINEL,
                  extra_feeds: Sequence[str] = ()) -> InferResult:
    """Whole-program shape/dtype inference + declared-shape cross-check.

    Walks every block in op order. Feeds (is_data), persistables, and
    `extra_feeds` seed the environment from their declared shapes with -1
    batch dims replaced by the sentinel; each op's outputs are inferred and
    compared against declared Variable shapes, with mismatches reported as
    error diagnostics carrying op provenance. Ops whose inputs are unknown
    (sub-block bindings, waived producers) degrade to their declared output
    shapes and are counted as skipped, never mis-reported."""
    res = InferResult(types={}, diagnostics=[])
    diags = res.diagnostics

    for block in program.blocks:
        env: Dict[str, Any] = {}
        # sharded-update state (r08 ZeRO-1): vars marked dp_shard_update
        # are declared at their GLOBAL shape but execute per-shard at
        # [dim0/dp, ...] — seed and cross-check them at the shard shape
        dp = max((int(op.attrs.get("dp", 1)) for op in block.ops
                  if op.type == "dp_grad_comm"), default=1)

        def _shard_aware_shape(v):
            # tp localization first (tp_shard_pass marks), then the r08
            # dp-sharded-update split of (the tp-local) dim 0
            shape = _tp_localized(v, _subst(v.shape, nominal_batch),
                                  program)
            if (getattr(v, "dp_shard_update", False) and dp > 1
                    and shape and shape[0] % dp == 0):
                shape = (shape[0] // dp,) + shape[1:]
            return shape

        def _seed(name):
            """Struct from the declared shape, or None."""
            try:
                v = block.var(name)
            except NotFoundError:
                return None
            if v.shape is None:
                return None
            return ShapeDtype(_shard_aware_shape(v), _canon_dtype(v.dtype))

        b = block
        while b is not None:
            for name, v in b.vars.items():
                if v.is_data or v.persistable or name in set(extra_feeds):
                    s = _seed(name)
                    if s is not None and name not in env:
                        env[name] = s
            b = b.parent

        def _fallback_outputs(op):
            for name in op.output_names():
                s = _seed(name)
                if s is not None:
                    env[name] = s

        for idx, op in enumerate(block.ops):
            res.n_ops += 1
            loc = op_loc(block, idx, op)

            if op.type in _REGION_OPS:
                # Grads outputs mirror the diff targets' structs; LossGrad
                # mirrors the loss (backward.py append_backward layout)
                targets = list(op.attrs.get("targets", ()))
                gnames = list(op.outputs.get("Grads", ()))
                for gname, tname in zip(gnames, targets):
                    s = env.get(tname)
                    if s is None:
                        s = _seed(tname)
                    if s is not None:
                        env[gname] = s
                loss = op.attrs.get("loss")
                ls = env.get(loss) if loss else None
                if ls is None and loss:
                    ls = _seed(loss)
                for lg in op.outputs.get("LossGrad", ()):
                    if ls is not None:
                        env[lg] = ls
                res.n_inferred += 1
                continue

            if op.type in INFER_WAIVED:
                _fallback_outputs(op)
                res.n_skipped += 1
                continue

            in_structs, unknown = {}, False
            for slot, names in op.inputs.items():
                vals = []
                for n in names:
                    s = env.get(n)
                    if s is None:
                        s = _seed(n)
                    if s is None:
                        unknown = True
                        break
                    vals.append(s)
                if unknown:
                    break
                in_structs[slot] = vals
            if unknown:
                _fallback_outputs(op)
                res.n_skipped += 1
                continue

            ictx = InferCtx(block=block, op=op, op_idx=idx,
                            nominal_batch=nominal_batch)
            try:
                out = infer_op(op.type, in_structs, op.attrs, ictx)
            except Exception as e:  # noqa: BLE001 — degrade, don't abort
                diags.append(Diagnostic(
                    "infer-error", loc,
                    f"shape inference over the lowering failed: "
                    f"{type(e).__name__}: {str(e)[:300]}",
                    severity="warning"))
                _fallback_outputs(op)
                res.n_skipped += 1
                continue
            res.n_inferred += 1

            for slot, names in op.outputs.items():
                vals = out.get(slot)
                if vals is None:
                    for n in names:
                        s = _seed(n)
                        if s is not None:
                            env[n] = s
                    continue
                if len(vals) < len(names):
                    # spec/lowering arity drift must not silently starve
                    # downstream inference via zip truncation
                    diags.append(Diagnostic(
                        "infer-arity", loc,
                        f"slot {slot!r}: rule returned {len(vals)} "
                        f"value(s) for {len(names)} declared outputs",
                        severity="warning"))
                    for n in names[len(vals):]:
                        s = _seed(n)
                        if s is not None:
                            env[n] = s
                for n, s in zip(names, vals):
                    if s is None:
                        continue
                    env[n] = s
                    v = block.vars.get(n)
                    if v is None or v.shape is None:
                        continue
                    declared = _tp_localized(v, tuple(v.shape), program)
                    if (getattr(v, "dp_shard_update", False) and dp > 1
                            and declared and declared[0] % dp == 0):
                        declared = (declared[0] // dp,) + declared[1:]
                    if not _shapes_compatible(tuple(s.shape), declared):
                        diags.append(Diagnostic(
                            "shape-mismatch", loc,
                            f"output {n!r} (slot {slot!r}): inferred "
                            f"{_render_shape(s.shape, nominal_batch)} != "
                            f"declared {list(v.shape)}"))
                    if not _dtypes_compatible(s.dtype, v.dtype):
                        diags.append(Diagnostic(
                            "dtype-mismatch", loc,
                            f"output {n!r} (slot {slot!r}): inferred "
                            f"{dtype_name(s.dtype)} != declared "
                            f"{dtype_name(v.dtype)}"))

        for name, s in env.items():
            res.types[(block.idx, name)] = s
    return res


def infer_coverage() -> Tuple[List[str], Dict[str, str]]:
    """(ops static inference covers, waived op -> reason). Coverage =
    explicit infer_spec, engine-interpreted region op, or eval_shape over
    the lowering; the floor test in test_op_coverage.py asserts the covered
    fraction stays >= 90% and every waiver carries its reason."""
    from .registry import registered_ops
    ops = registered_ops()
    covered = [op for op in ops if op not in INFER_WAIVED]
    return covered, {op: r for op, r in INFER_WAIVED.items() if op in ops}


# ---------------------------------------------------------------------------
# structural + parallel verification
# ---------------------------------------------------------------------------

# control-flow ops binding sub-block var names via attrs (see the def-
# before-use walk): their string/string-list attrs name vars defined inside
# the referenced block
_SUB_KEYS = ("sub_block", "true_block", "false_block",
             "case_blocks", "default_block")


def _binder_names(program: Program) -> Dict[int, set]:
    bound: Dict[int, set] = {}
    for blk in program.blocks:
        for op in blk.ops:
            sub_idxs = []
            for key in _SUB_KEYS:
                v = op.attrs.get(key)
                if isinstance(v, int) and not isinstance(v, bool):
                    sub_idxs.append(v)
                elif isinstance(v, (list, tuple)):
                    sub_idxs.extend(x for x in v if isinstance(x, int))
            if not sub_idxs:
                continue
            names = set()
            for v in op.attrs.values():
                if isinstance(v, str):
                    names.add(v)
                elif isinstance(v, (list, tuple)) and \
                        all(isinstance(x, str) for x in v):
                    names.update(v)
            for si in sub_idxs:
                if 0 < si < len(program.blocks):
                    bound.setdefault(si, set()).update(names)
    return bound


def _check_def_before_use(program, extra_feeds, diags):
    """Every op input produced earlier, fed (is_data), persistable, or a
    recognized companion/binder var (absorbed from the old CheckPass ≙
    multi_devices_check_pass + ir::HasCircle,
    reference parallel_executor.cc:91 / multi_devices_graph_pass.cc:465)."""
    bound = _binder_names(program)
    for block in program.blocks:
        defined = set(extra_feeds) | bound.get(block.idx, set())
        for name, var in block.vars.items():
            if (getattr(var, "persistable", False)
                    or getattr(var, "is_data", False)):
                defined.add(name)
                defined.add(name + "@SEQLEN")
        b = block
        while b.parent is not None:
            b = b.parent
            defined |= set(b.vars)
        for idx, op in enumerate(block.ops):
            for name in op.input_names():
                if name not in defined:
                    diags.append(Diagnostic(
                        "def-before-use", op_loc(block, idx, op),
                        f"reads {name!r} before any producer/feed"))
            defined.update(op.output_names())


def _check_duplicate_writers(program, diags):
    """A non-persistable var written by two ops is a rewrite hazard (which
    value do readers see?). Sanctioned second writers: pp_recv (the
    partition pass deliberately re-binds crossing names on the consuming
    stage), TensorArray writes (append semantics), and self-updating ops
    that also READ the var they rewrite (increment(in_place=True),
    switch_case re-binding a produced target via its Prev input) — those
    are ordered in-place updates, not ambiguous rebindings."""
    exempt_types = {"pp_recv", "array_write"}
    for block in program.blocks:
        # record ALL writers (exempt ones included, so a non-exempt second
        # writer after an array_write/pp_recv first writer still reports);
        # only the exempt op itself is never flagged as the duplicate
        writers: Dict[str, List[int]] = {}
        for idx, op in enumerate(block.ops):
            for name in op.output_names():
                writers.setdefault(name, []).append(idx)
        for name, idxs in writers.items():
            if len(idxs) < 2:
                continue
            try:
                v = block.var(name)
                if v.persistable:
                    continue
            except NotFoundError:
                pass
            first = idxs[0]
            for idx in idxs[1:]:
                op = block.ops[idx]
                if op.type in exempt_types:
                    continue
                if name in op.input_names():
                    continue                  # in-place self-update
                diags.append(Diagnostic(
                    "duplicate-writer", op_loc(block, idx, op),
                    f"re-writes non-persistable {name!r} already produced "
                    f"by op#{first} {block.ops[first].type!r}"))


def _check_attr_schemas(program, diags):
    """Structural attribute invariants of region/boundary ops: recorded op
    indices must address real, earlier ops; stage lists must partition the
    region; dp_grad_comm's plan arrays must stay aligned."""
    for block in program.blocks:
        n = len(block.ops)
        for idx, op in enumerate(block.ops):
            loc = op_loc(block, idx, op)
            role = op.attrs.get("op_role")
            if role is not None and not isinstance(role, str):
                diags.append(Diagnostic(
                    "attr-schema", loc,
                    f"op_role must be a string, got {type(role).__name__}"))
            if op.type in _REGION_OPS:
                seg = op.attrs.get("fwd_ops")
                if not isinstance(seg, (list, tuple)):
                    diags.append(Diagnostic(
                        "attr-schema", loc, "missing fwd_ops index list"))
                    continue
                bad = [i for i in seg
                       if not isinstance(i, (int, np.integer))
                       or i < 0 or i >= n or i == idx]
                if bad:
                    diags.append(Diagnostic(
                        "attr-schema", loc,
                        f"fwd_ops indices out of range: {bad[:6]}"))
                if not isinstance(op.attrs.get("targets"), (list, tuple)) \
                        or "loss" not in op.attrs:
                    diags.append(Diagnostic(
                        "attr-schema", loc,
                        "region op missing targets/loss attrs"))
            if op.type == "pp_pipeline_region":
                stages = op.attrs.get("stages") or []
                k = op.attrs.get("num_stages")
                if len(stages) != k or any(not s for s in stages):
                    diags.append(Diagnostic(
                        "attr-schema", loc,
                        f"stages must be {k} non-empty op-index lists, got "
                        f"{[len(s) for s in stages]}"))
                flat = sorted(i for s in stages for i in s)
                if flat != sorted(op.attrs.get("fwd_ops", ())):
                    diags.append(Diagnostic(
                        "attr-schema", loc,
                        "stages do not partition fwd_ops"))
            if op.type in ("pp_send", "pp_recv") and \
                    not isinstance(op.attrs.get("cut"),
                                   (int, np.integer)):
                diags.append(Diagnostic(
                    "attr-schema", loc, "missing integer 'cut' attr"))
            if op.type == "dp_grad_comm":
                kinds = op.attrs.get("kinds", [])
                numels = op.attrs.get("numels", [])
                shapes = op.attrs.get("shapes", [])
                xs = op.inputs.get("X", [])
                outs = op.outputs.get("Out", [])
                if not (len(kinds) == len(numels) == len(shapes)
                        == len(xs) == len(outs)):
                    diags.append(Diagnostic(
                        "attr-schema", loc,
                        f"plan arrays misaligned: kinds={len(kinds)} "
                        f"numels={len(numels)} shapes={len(shapes)} "
                        f"X={len(xs)} Out={len(outs)}"))
                    continue
                covered = set()
                for b in op.attrs.get("buckets", []):
                    for i in b:
                        if i in covered or i >= len(kinds) \
                                or kinds[i] != "bucket":
                            diags.append(Diagnostic(
                                "attr-schema", loc,
                                f"bucket entry {i} invalid (dup, out of "
                                f"range, or not kind='bucket')"))
                        covered.add(i)
                missing = [i for i, k in enumerate(kinds)
                           if k == "bucket" and i not in covered]
                if missing:
                    diags.append(Diagnostic(
                        "attr-schema", loc,
                        f"bucket-kind gradients not in any bucket: "
                        f"{missing[:6]}"))


def _check_pipeline_invariants(program, diags):
    """Every stage cut carries exactly one matched pp_send/pp_recv pair:
    same cut id, send before recv, send inputs == recv outputs (the names
    re-bound on the consuming stage); a pp_pipeline_region of K stages owns
    cuts 0..K-2 — and boundary ops without a region are orphans."""
    for block in program.blocks:
        sends: Dict[Any, List[int]] = {}
        recvs: Dict[Any, List[int]] = {}
        regions = []
        for idx, op in enumerate(block.ops):
            if op.type == "pp_send":
                sends.setdefault(op.attrs.get("cut"), []).append(idx)
            elif op.type == "pp_recv":
                recvs.setdefault(op.attrs.get("cut"), []).append(idx)
            elif op.type == "pp_pipeline_region":
                regions.append(idx)
        if not (sends or recvs or regions):
            continue
        if (sends or recvs) and not regions:
            idx = min(v[0] for v in (list(sends.values())
                                     + list(recvs.values())))
            diags.append(Diagnostic(
                "pp-orphan-boundary", op_loc(block, idx, block.ops[idx]),
                "pp_send/pp_recv present but no pp_pipeline_region "
                "executes them"))
        for cut in sorted(set(sends) | set(recvs), key=repr):
            s, r = sends.get(cut, []), recvs.get(cut, [])
            if len(s) != 1 or len(r) != 1:
                idx = (s or r)[0]
                diags.append(Diagnostic(
                    "pp-unmatched-boundary",
                    op_loc(block, idx, block.ops[idx]),
                    f"cut {cut}: expected exactly one pp_send and one "
                    f"pp_recv, found {len(s)} send(s) / {len(r)} recv(s)"))
                continue
            si, ri = s[0], r[0]
            if si >= ri:
                diags.append(Diagnostic(
                    "pp-unmatched-boundary",
                    op_loc(block, si, block.ops[si]),
                    f"cut {cut}: pp_send (op#{si}) must precede its "
                    f"pp_recv (op#{ri})"))
            snames = list(block.ops[si].inputs.get("X", ()))
            rnames = list(block.ops[ri].outputs.get("Out", ()))
            if snames != rnames:
                diags.append(Diagnostic(
                    "pp-unmatched-boundary",
                    op_loc(block, ri, block.ops[ri]),
                    f"cut {cut}: pp_recv outputs {rnames} != pp_send "
                    f"inputs {snames}"))
        for ridx in regions:
            rop = block.ops[ridx]
            k = int(rop.attrs.get("num_stages", 0))
            m = int(rop.attrs.get("num_microbatches", 0))
            loc = op_loc(block, ridx, rop)
            if k < 2:
                diags.append(Diagnostic(
                    "pp-config", loc, f"num_stages must be >= 2, got {k}"))
            if m < 1:
                diags.append(Diagnostic(
                    "pp-config", loc,
                    f"num_microbatches must be >= 1, got {m}"))
            want = set(range(max(0, k - 1)))
            have = {c for c in sends if isinstance(c, (int, np.integer))}
            if k >= 2 and want != have:
                diags.append(Diagnostic(
                    "pp-unmatched-boundary", loc,
                    f"{k} stages need cuts {sorted(want)}, pp_send ops "
                    f"cover {sorted(have)}"))


def _check_dp_comm_invariants(program, diags):
    """dp_grad_comm must sit BETWEEN the backward region and every gradient
    consumer: raw region gradients flow only into the comm op, every
    consumer of a comm'd gradient runs after it, and sharded-path entries
    stay dp-divisible (≙ the placement contract of
    fuse_all_reduce_op_pass + multi_devices_graph_pass)."""
    from .lowering import grad_var_name
    for block in program.blocks:
        comms = [(i, op) for i, op in enumerate(block.ops)
                 if op.type == "dp_grad_comm"]
        if not comms:
            continue
        region_idxs = [i for i, op in enumerate(block.ops)
                       if op.type in _REGION_OPS]
        for cidx, comm in comms:
            loc = op_loc(block, cidx, comm)
            if not region_idxs or min(region_idxs) > cidx:
                diags.append(Diagnostic(
                    "dp-comm-misplaced", loc,
                    "no backward region (vjp_region/pp_pipeline_region) "
                    "precedes dp_grad_comm"))
                continue
            rop = block.ops[max(i for i in region_idxs if i < cidx)]
            target_grads = {grad_var_name(t)
                            for t in rop.attrs.get("targets", ())}
            raw = [n for n in comm.inputs.get("X", ())]
            stray = [n for n in raw if n not in target_grads]
            if stray:
                diags.append(Diagnostic(
                    "dp-comm-misplaced", loc,
                    f"inputs {stray[:4]} are not gradients of the "
                    f"preceding region's targets"))
            outs = set(comm.outputs.get("Out", ()))
            raw_set = set(raw)
            for idx, op in enumerate(block.ops):
                if op is comm or op.type in _REGION_OPS:
                    continue
                reads = set(op.input_names())
                bypass = sorted(reads & raw_set)
                if bypass:
                    diags.append(Diagnostic(
                        "dp-comm-bypass", op_loc(block, idx, op),
                        f"reads raw (un-reduced) gradient(s) {bypass[:4]} "
                        f"— consumers must read the dp_grad_comm outputs"))
                early = sorted(reads & outs) if idx < cidx else []
                if early:
                    diags.append(Diagnostic(
                        "dp-comm-misplaced", op_loc(block, idx, op),
                        f"consumes comm'd gradient(s) {early[:4]} before "
                        f"dp_grad_comm (op#{cidx}) produces them"))
            dp = int(comm.attrs.get("dp", 1))
            kinds = comm.attrs.get("kinds", ())
            shapes = comm.attrs.get("shapes", ())
            xs = comm.inputs.get("X", ())
            if not (len(kinds) == len(shapes) == len(xs)):
                continue    # misaligned plan: attr-schema already reported
            for i, kind in enumerate(kinds):
                if kind != "sharded":
                    continue
                shape = shapes[i]
                if not shape or int(shape[0]) % max(dp, 1) != 0:
                    diags.append(Diagnostic(
                        "dp-divisibility", loc,
                        f"sharded gradient {xs[i]!r} dim0 "
                        f"{shape and shape[0]} not divisible by dp={dp}"))


def verify_program(program: Program,
                   extra_feeds: Sequence[str] = ()) -> List[Diagnostic]:
    """Layer-2 structural + parallel consistency verification. Returns the
    full diagnostic list (empty = clean); never raises. The dataflow
    detectors (framework/dataflow.py: collective consistency/deadlock,
    replica divergence, buffer-reuse races) run here too — pure Python
    over the IR, so every sanitized pass apply gets them for free."""
    diags: List[Diagnostic] = []
    _check_def_before_use(program, extra_feeds, diags)
    _check_duplicate_writers(program, diags)
    _check_attr_schemas(program, diags)
    _check_pipeline_invariants(program, diags)
    _check_dp_comm_invariants(program, diags)
    from . import dataflow as _dataflow     # lazy: dataflow imports us
    diags += _dataflow.dataflow_checks(program)
    return diags


def analyze_program(program: Program, extra_feeds: Sequence[str] = (),
                    nominal_batch: int = BATCH_SENTINEL,
                    infer: bool = True,
                    tp_size: Optional[int] = None) -> List[Diagnostic]:
    """Full static analysis: structural verification + (optionally)
    whole-program shape/dtype inference + — whenever the program carries
    tp sharding annotations (or `tp_size` is given) — sharding propagation
    (framework/sharding.py), so annotation conflicts surface with the same
    op provenance as every other diagnostic. Returns all diagnostics."""
    diags = verify_program(program, extra_feeds=extra_feeds)
    if infer:
        diags += infer_program(program, nominal_batch=nominal_batch,
                               extra_feeds=extra_feeds).diagnostics
    from . import sharding as _sharding
    if tp_size is not None or _sharding.has_tp_annotations(program):
        diags += _sharding.propagate_sharding(
            program, tp_size=tp_size,
            nominal_batch=nominal_batch).diagnostics
    return diags


def _has_tp_annotations(program: Program) -> bool:
    """≙ sharding.has_tp_annotations: a block-0 var whose sharding_spec
    names the tp axis."""
    for v in program.global_block().vars.values():
        for s in getattr(v, "sharding_spec", None) or ():
            if s == "tp" or (isinstance(s, (tuple, list)) and "tp" in s):
                return True
    return False


def check_program(program: Program, extra_feeds: Sequence[str] = (),
                  infer: bool = True) -> None:
    """Raise ProgramAnalysisError when analysis finds error-severity
    diagnostics (warnings pass)."""
    diags = analyze_program(program, extra_feeds=extra_feeds, infer=infer)
    errors = [d for d in diags if d.severity == "error"]
    if errors:
        raise ProgramAnalysisError(
            "program analysis failed:\n  "
            + "\n  ".join(str(d) for d in errors), errors)


# ---------------------------------------------------------------------------
# pass sanitizer
# ---------------------------------------------------------------------------


def sanitizer_enabled() -> bool:
    return bool(flags.get_flag("verify_passes"))


_OPNUM = _re.compile(r"op#\d+")


def _attribution_key(d: Diagnostic) -> tuple:
    """Diagnostic identity for the before/after comparison, with op indices
    masked out: a pass that inserts or removes ops renumbers every later
    op#, and a pre-existing violation whose loc merely shifted must stay
    the caller's, not be blamed on the pass."""
    return (d.code, _OPNUM.sub("op#*", d.loc), _OPNUM.sub("op#*", d.message))


def sanitized_apply(pass_obj, program: Program, scope=None):
    """Run one Pass apply under verify-before/verify-after (wired into
    Pass.__call__). Violations present BEFORE the pass are the caller's —
    only NEW error-severity diagnostics are attributed, by name, to the
    pass. Shape inference is not run here (it runs every lowering; the
    structural verifier is pure Python and cheap enough for every apply) —
    lint/tests run the full analyzer."""
    if not sanitizer_enabled() or getattr(pass_obj, "name", "") == "check_pass":
        return pass_obj.apply(program, scope)
    before = {_attribution_key(d) for d in verify_program(program)}
    out = pass_obj.apply(program, scope)
    target = out if isinstance(out, Program) else program
    new = [d for d in verify_program(target)
           if d.severity == "error" and _attribution_key(d) not in before]
    if new:
        raise PassSanitizerError(pass_obj.name, new)
    return out


# ---------------------------------------------------------------------------
# static memory estimate (lint_program's peak-live-bytes table)
# ---------------------------------------------------------------------------


def peak_live_bytes(program: Program, nominal_batch: int = 8) -> Dict:
    """Static peak-live-bytes estimate from variable lifetimes: a transient
    var is live from its first writer to its last reader (inclusive);
    feeds/persistables are live for the whole program. -1 dims count as
    `nominal_batch` rows. An *estimate* — the allocator reuses
    and fuses further — but it ranks programs and partitionings the same
    way (the lifetime census discipline of
    transpiler/memory_optimization.py).

    The walk covers the WHOLE program, not just block 0's op list:

    - backward regions (`vjp_region`/`pp_pipeline_region`) keep every
      value their forward segment touches live until the region executes
      (the backward re-runs the segment under autograd, so activations are
      backward inputs — dataflow.var_lifetimes owns this rule). The pp
      region's *schedule-dependent* stash (≤K in-flight microbatches under
      1F1B, =M under GPipe) is NOT modeled here — parallel/pipeline.py's
      stash census owns that number;
    - sub-blocks (while/cond_block/static_rnn/switch_case bodies) are
      walked recursively: a sub-block's own transient peak is attributed
      at its binder op's index in the parent — live for exactly the ops
      that execute it.

    Returns the block-0 keys of the r10 shape plus `sub_block_peaks`
    ({block idx: transient bytes} for every bound sub-block)."""
    from . import dataflow as _dataflow

    def nbytes(block, name):
        # only vars DECLARED in this block: parent vars are the parent
        # sweep's to count (persistables/feeds are block 0's); ONE
        # pricing rule shared with the memory planner
        return _dataflow.declared_var_bytes(block, name, nominal_batch)

    block0 = program.global_block()
    persistent, feed = 0, 0
    for name, v in block0.vars.items():
        if v.persistable:
            persistent += nbytes(block0, name)
        elif v.is_data:
            feed += nbytes(block0, name)

    # binder op -> sub-block indices (while/cond_block/... attrs)
    def sub_idxs(op):
        out = []
        for key in _SUB_KEYS:
            v = op.attrs.get(key)
            if isinstance(v, int) and not isinstance(v, bool):
                out.append(v)
            elif isinstance(v, (list, tuple)):
                out.extend(x for x in v if isinstance(x, int))
        return [i for i in out if 0 < i < len(program.blocks)]

    sub_peaks: Dict[int, int] = {}

    def block_peak(bidx, chain=()):
        enforce(bidx not in chain,
                f"peak_live_bytes: sub-block {bidx} binds itself "
                f"(binder chain {chain}) — the lifetime walk cannot "
                f"terminate on a cyclic block graph",
                exc=EnforceError)
        block = program.blocks[bidx]
        n = len(block.ops)
        lifetimes = _dataflow.var_lifetimes(block)
        alloc: Dict[int, int] = {}
        free: Dict[int, int] = {}
        for name, (w, end) in lifetimes.items():
            v = block.vars.get(name)
            if v is not None and (v.persistable or v.is_data):
                continue
            size = nbytes(block, name)
            if not size:
                continue
            alloc[w] = alloc.get(w, 0) + size
            free[end + 1] = free.get(end + 1, 0) + size
        for idx, op in enumerate(block.ops):
            for si in sub_idxs(op):
                sp = block_peak(si, chain + (bidx,))
                sub_peaks[si] = sp
                alloc[idx] = alloc.get(idx, 0) + sp
                free[idx + 1] = free.get(idx + 1, 0) + sp
        peak, peak_at, live = 0, None, 0
        for t in range(n):
            live += alloc.get(t, 0) - free.get(t, 0)
            if live > peak:
                peak, peak_at = live, t
        return (peak, peak_at) if bidx == 0 else peak

    peak, peak_at = block_peak(0)
    loc = (op_loc(block0, peak_at, block0.ops[peak_at])
           if peak_at is not None else None)
    return {"persistent_bytes": persistent,
            "feed_bytes": feed,
            "peak_transient_bytes": peak,
            "peak_total_bytes": persistent + feed + peak,
            "peak_at": loc,
            "sub_block_peaks": dict(sorted(sub_peaks.items())),
            "nominal_batch": nominal_batch}
