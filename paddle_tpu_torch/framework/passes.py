"""Program pass framework: Pass base, registry, the pruning and memory
passes, the two fusion passes, the weight-only quantization pass and the
Analyzer pass manager.

≙ paddle_tpu/framework/passes.py (itself ≙ the reference's framework/ir
ir::Pass + PassRegistry): the executor applies `fuse_recurrent_cell_pass`
and `fuse_decode_attention_pass` to one clone of every program it plans
(`apply_fusion_passes`); the serving engines apply `quantize_params_pass`
to their tick programs (`quant=`). Every apply runs under the pass
sanitizer (verify-before / verify-after, framework/analysis.py
`sanitized_apply`, flag `verify_passes`) inside a `pass` span, as in the
JAX package. `check_pass` and `graph_viz_pass` (over debugger.py) are here;
`memory_plan_pass` registers from framework/memory_plan.py on first use.
`pipeline_partition_pass` cuts a training program into pipeline stages
(parallel/pipeline.py runs them). `bn_fold_pass` and `quant_freeze_pass`
wrap the inference and quantize transpilers (transpiler/); the first is
the Analyzer's default.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from ..core.enforce import (AlreadyExistsError, InvalidArgumentError,
                            NotFoundError, enforce)
from .program import Program
from .scope import Scope, global_scope


class Pass:
    """A named program rewrite (≙ ir::Pass, reference ir/pass.h:32).
    Subclasses list `allowed_attrs`; unknown attrs raise instead of
    silently no-op'ing a mistyped option."""

    name = "pass"
    allowed_attrs: tuple = ()

    def __init__(self, **attrs):
        unknown = set(attrs) - set(self.allowed_attrs)
        if unknown:
            raise TypeError(
                f"pass {self.name!r} got unknown attrs {sorted(unknown)}; "
                f"allowed: {sorted(self.allowed_attrs)}")
        self.attrs = attrs

    def apply(self, program: Program, scope: Optional[Scope] = None) -> Program:
        raise NotImplementedError

    def __call__(self, program, scope=None):
        # every apply runs under the pass sanitizer (verify-before /
        # verify-after): a rewrite that breaks a structural invariant is
        # attributed to THIS pass by name. Kill switch PTPU_VERIFY_PASSES=0.
        # The apply is a "pass" span carrying the pass name and attrs.
        from ..observability import tracing as _tracing
        from .analysis import sanitized_apply
        with _tracing.span("pass", f"pass/{self.name}",
                           **{k: v for k, v in self.attrs.items()
                              if isinstance(v, (str, int, float, bool))}):
            return sanitized_apply(self, program, scope)


_REGISTRY: Dict[str, Callable[..., Pass]] = {}


def register_pass(name: str):
    """≙ REGISTER_PASS (reference ir/pass.h PassRegistry)."""

    def deco(cls):
        if name in _REGISTRY:
            raise AlreadyExistsError(f"pass {name!r} already registered")
        cls.name = name
        _REGISTRY[name] = cls
        return cls

    return deco


# passes registered by a module this one does not import eagerly; get_pass
# imports it on first use (≙ the JAX package's)
_LAZY_PASS_MODULES = {"memory_plan_pass": "memory_plan",
                      "tp_shard_pass": "sharding"}


def get_pass(name: str, **attrs) -> Pass:
    if name not in _REGISTRY and name in _LAZY_PASS_MODULES:
        import importlib
        importlib.import_module("." + _LAZY_PASS_MODULES[name], __package__)
    if name not in _REGISTRY:
        raise NotFoundError(
            f"no pass named {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**attrs)


def registered_passes() -> List[str]:
    return sorted(_REGISTRY)


@register_pass("bn_fold_pass")
class BNFoldPass(Pass):
    """Constant-fold inference batch_norm into the preceding conv/mul
    (≙ the conv-bn fuse of inference_transpiler.py:24)."""

    allowed_attrs = ()

    def apply(self, program, scope=None):
        from ..transpiler import InferenceTranspiler
        InferenceTranspiler().transpile(program, scope=scope or global_scope())
        return program


@register_pass("quant_freeze_pass")
class QuantFreezePass(Pass):
    """Bake QAT weight quantization into stored weights (≙ the reference
    freeze flow over fake_quantize ops)."""

    allowed_attrs = ("weight_bits", "activation_bits")

    def apply(self, program, scope=None):
        from ..transpiler import QuantizeTranspiler
        QuantizeTranspiler(**self.attrs) \
            .freeze_program(program, scope=scope or global_scope())
        return program


@register_pass("graph_viz_pass")
class GraphVizPass(Pass):
    """Dump the program graph as graphviz dot (≙ ir/graph_viz_pass.cc).
    attrs: path=...; block_idx=0."""

    allowed_attrs = ("path", "block_idx")

    def apply(self, program, scope=None):
        from ..debugger import draw_block_graphviz
        block = program.blocks[self.attrs.get("block_idx", 0)]
        draw_block_graphviz(block, self.attrs["path"])
        return program


@register_pass("check_pass")
class CheckPass(Pass):
    """Validate program well-formedness before execution: a thin alias over
    `framework.analysis.verify_program` (def-before-use, duplicate-writer
    hazards, attribute schemas, pipeline / dp-comm invariants), as in the
    JAX package. Raises NotFoundError with the full violation list."""

    allowed_attrs = ("extra_feeds",)

    def apply(self, program, scope=None):
        from .analysis import verify_program
        problems = [d for d in verify_program(
            program, extra_feeds=self.attrs.get("extra_feeds", ()))
            if d.severity == "error"]
        if problems:
            raise NotFoundError(
                "program check failed:\n  "
                + "\n  ".join(str(d) for d in problems))
        return program


def _balanced_partition(costs: List[float], k: int) -> List[Tuple[int, int]]:
    """Split `costs` into k contiguous NON-EMPTY segments minimizing the
    max segment sum (linear-partition DP; ≙ the JAX package's, which its
    pipeline partitioner and the memory planner's remat search share).
    Returns [start, end) pairs."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    dp = [[inf] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n - (k - j) + 1):
            best, where = inf, j - 1
            for c in range(j - 1, i):
                if dp[j - 1][c] == inf:
                    continue
                v = max(dp[j - 1][c], prefix[i] - prefix[c])
                if v < best:
                    best, where = v, c
            dp[j][i] = best
            cut[j][i] = where
    bounds = []
    i = n
    for j in range(k, 0, -1):
        c = cut[j][i]
        bounds.append((c, i))
        i = c
    bounds.reverse()
    return bounds


@register_pass("prune_pass")
class PrunePass(Pass):
    """Keep only the ops needed for `targets` (≙ framework/prune.cc via
    Program.prune). attrs: targets=[var names or Variables]."""

    allowed_attrs = ("targets",)

    def apply(self, program, scope=None):
        return program.prune(self.attrs["targets"])


@register_pass("memory_optimize_pass")
class MemoryOptimizePass(Pass):
    """Remat and live-out narrowing (≙ memory_optimization_transpiler)."""

    allowed_attrs = ("level", "skip_opt_set", "print_log")

    def apply(self, program, scope=None):
        from ..transpiler import memory_optimize
        return memory_optimize(
            program, level=self.attrs.get("level", 0),
            skip_opt_set=self.attrs.get("skip_opt_set"),
            print_log=self.attrs.get("print_log", False))


@register_pass("fuse_recurrent_cell_pass")
class FuseRecurrentCellPass(Pass):
    """Rewrite `dynamic_lstm` / `dynamic_gru` ops to their fused-cell
    equivalents (`fused_lstm` / `fused_gru`, fusion/recurrent.py): the
    whole recurrence becomes one kernel launch instead of a loop of
    per-step ops. Only default-activation instances are fusable; others
    are left untouched. The rewrite is 1:1 in the op list, so op indices
    (vjp_region fwd_ops segments) stay valid and every block is visited,
    the one holding the vjp_region included."""

    _REWRITES = {"dynamic_lstm": "fused_lstm", "dynamic_gru": "fused_gru"}

    def apply(self, program, scope=None):
        n = 0
        for block in program.blocks:
            for op in block.ops:
                if _fusable_recurrent(op):
                    op.attrs["fused_from"] = op.type
                    op.type = self._REWRITES[op.type]
                    n += 1
        if n:
            program._bump()
        return program


def _fusable_recurrent(op) -> bool:
    from ..fusion.recurrent import gru_attrs_fusable, lstm_attrs_fusable
    if op.type == "dynamic_lstm":
        return lstm_attrs_fusable(op.attrs)
    return op.type == "dynamic_gru" and gru_attrs_fusable(op.attrs)


def _visited_blocks(program: Program):
    """The blocks the decode pass rewrites: all but those holding a
    vjp_region or pp_pipeline_region (see FuseDecodeAttentionPass)."""
    return [blk for blk in program.blocks
            if not any(op.type in ("vjp_region", "pp_pipeline_region")
                       for op in blk.ops)]


@register_pass("fuse_decode_attention_pass")
class FuseDecodeAttentionPass(Pass):
    """Fuse the cached-decode attention chain
    matmul(q, K^T, alpha) -> elementwise_add(bias) -> softmax -> matmul(V)
    (a single-position query over a KV cache, the `_attend_cached` idiom,
    or a verify window of 1 < G < T positions, `_attend_cached_multi`)
    into one `fused_decode_attention` op. attrs: protected=[var names that
    must survive — fetch targets]. Blocks containing a vjp_region (or a
    pp_pipeline_region) are skipped: those regions' fwd_ops/stages segments
    index into the op list, which a multi-op splice would invalidate
    (decode graphs are inference-only)."""

    allowed_attrs = ("protected",)

    def apply(self, program, scope=None):
        protected = set(self.attrs.get("protected", ()))
        # a fused intermediate may not be read anywhere else in the program
        reads = {}
        for blk in program.blocks:
            for op in blk.ops:
                for name in op.input_names():
                    reads[name] = reads.get(name, 0) + 1
        n = 0
        for block in _visited_blocks(program):
            n += self._rewrite_block(block, reads, protected)
        if n:
            program._bump()
        return program

    @staticmethod
    def _shape(block, name):
        try:
            return block.var(name).shape
        except NotFoundError:
            return None

    def _match(self, block, ops, si, producer, reads, protected):
        """The chain whose softmax is ops[si] if it may be fused (a match
        dict), else None."""
        m = self._chain(block, ops, si, producer)
        if m is None:
            return None
        # intermediates must be pure glue: consumed exactly once, by the
        # next op in the chain, and not fetched/protected
        for name in (m["m1"].outputs["Out"][0], m["add"].outputs["Out"][0],
                     m["sm"].outputs["Out"][0]):
            if reads.get(name, 0) != 1 or name in protected:
                return None
            var = block.vars.get(name)
            if var is not None and (var.persistable or var.is_data):
                return None
        return m

    def _chain(self, block, ops, si, producer):
        """The decode-attention chain whose softmax is ops[si] (a match
        dict), or None when ops[si] ends no such chain. Says nothing on
        whether its intermediates may be fused away."""
        sm = ops[si]
        if sm.attrs.get("axis", -1) != -1:
            return None
        add = producer.get(sm.inputs.get("X", [None])[0])
        if add is None or add.type != "elementwise_add" or \
                add.attrs.get("axis", -1) != -1:
            return None
        m1 = producer.get(add.inputs["X"][0])
        if m1 is None or m1.type != "matmul" or \
                not m1.attrs.get("transpose_Y") or \
                m1.attrs.get("transpose_X") or m1.attrs.get("use_bf16"):
            return None
        # the single consumer of the softmax must be the context matmul
        sm_out = sm.outputs["Out"][0]
        m2 = None
        for op in ops:
            if sm_out in op.input_names():
                if m2 is not None:
                    return None
                m2 = op
        if m2 is None or m2.type != "matmul" or \
                m2.inputs["X"][0] != sm_out or \
                m2.attrs.get("transpose_X") or m2.attrs.get("transpose_Y") \
                or m2.attrs.get("alpha", 1.0) != 1.0 \
                or m2.attrs.get("use_bf16"):
            return None
        q, k = m1.inputs["X"][0], m1.inputs["Y"][0]
        v = m2.inputs["Y"][0]
        bias = add.inputs["Y"][0]
        qs, ks = self._shape(block, q), self._shape(block, k)
        vs, bs = self._shape(block, v), self._shape(block, bias)
        if qs is None or ks is None or vs is None or bs is None:
            return None
        # decode-width query over an equal-layout cache (no beam
        # broadcast on K/V — that pattern reads better through a batched
        # matmul). Width 1 is the plain decode tick; 1 < G < T is a
        # speculative verify window (γ+1 positions scored against the
        # cache in one forward, the same kernel's G-row route).
        # Full-sequence chains (Tq == Tk) are NOT
        # decode steps and stay unfused. Rank 3 ([B, 1, H] state over
        # [B, T, H] encoder outputs — the GRU-attention NMT idiom) fuses
        # too: the batch rows simply ride the fused kernel's head axis.
        if len(qs) < 3 or len(ks) != len(qs) or \
                not (qs[-2] == 1 or 1 < qs[-2] < ks[-2]) or \
                tuple(ks[:-2]) != tuple(qs[:-2]) or tuple(vs) != tuple(ks):
            return None
        tgt = tuple(qs[:-2]) + (qs[-2], ks[-2])
        if len(bs) != len(tgt) or any(
                bd != 1 and bd != td for bd, td in zip(bs, tgt)):
            return None
        return {"m1": m1, "add": add, "sm": sm, "m2": m2,
                "q": q, "k": k, "v": v, "bias": bias,
                "scale": float(m1.attrs.get("alpha", 1.0))}

    def _rewrite_block(self, block, reads, protected):
        from .program import Operator
        ops = block.ops
        producer = {}
        for op in ops:
            for name in op.output_names():
                producer[name] = op
        matches = []
        claimed = set()
        for si, op in enumerate(ops):
            if op.type != "softmax":
                continue
            m = self._match(block, ops, si, producer, reads, protected)
            if m is None:
                continue
            group = {id(m["m1"]), id(m["add"]), id(m["sm"]), id(m["m2"])}
            if group & claimed:
                continue
            claimed |= group
            matches.append(m)
        if not matches:
            return 0
        # splice at the LAST op of the chain (m2): every fused input
        # (q/k/v/bias) is produced before it by construction — the bias
        # may legitimately be built between the score matmul and the add
        # (the NMT attention builds it mid-chain)
        by_anchor = {id(m["m2"]): m for m in matches}
        drop = set()
        for m in matches:
            drop |= {id(m["m1"]), id(m["add"]), id(m["sm"])}
        new_ops = []
        for op in ops:
            m = by_anchor.get(id(op))
            if m is not None:
                fused = Operator(
                    block, "fused_decode_attention",
                    inputs={"Q": [m["q"]], "K": [m["k"]], "V": [m["v"]],
                            "Bias": [m["bias"]]},
                    outputs={"Out": [m["m2"].outputs["Out"][0]]},
                    attrs={"scale": m["scale"]})
                new_ops.append(fused)
                out_name = m["m2"].outputs["Out"][0]
                if out_name in block.vars:
                    block.vars[out_name].op = fused
                for name in (m["m1"].outputs["Out"][0],
                             m["add"].outputs["Out"][0],
                             m["sm"].outputs["Out"][0]):
                    block.vars.pop(name, None)
                continue
            if id(op) in drop:
                continue
            new_ops.append(op)
        block.ops = new_ops
        return len(matches)


@register_pass("quantize_params_pass")
class QuantizeParamsPass(Pass):
    """Weight-only serving quantization (≙ the JAX package's pass of the
    same name): rewrite a serving program's persistable f32 weights into
    block-scaled (payload, scales) pairs and their consumer ops into the
    quantized ops — `mul` -> `qmatmul`, `lookup_table` -> `qlookup`
    (ops/nn_ops.py, ops/tensor_ops.py). attrs: bits (8 or 4), block (tile
    edge, parallel/collective.py QUANT_BLOCK_2D).

    Contract: MUTATES `program` and `scope` in place — the f32 weight is
    dropped from the scope and its var from the block (its memory is the
    freed headroom), replaced by `<w>@qparam` (int8; nibble-packed columns
    at bits=4) and `<w>@qscale` (f32 tile grid), quantized where the
    weight lies. The name suffixes are the census contract
    (framework/costs.py `state_category`). A weight is quantized only when
    NO op writes it and EVERY consumer reads it through a rewritable slot
    (mul.Y with y_num_col_dims=1 / lookup_table.W). A twin program (the
    speculative verify forward, sharing weights by name with a program
    quantized before it) finds the f32 weight gone and the pair present,
    and reads the same resident payloads. The rewrite is 1:1 in the op
    list, so op indices stay valid, and the rewritten program's JSON is
    the JAX package's."""

    allowed_attrs = ("bits", "block")

    def apply(self, program, scope=None):
        from ..core.dtypes import dtype_name
        from ..parallel.collective import (QUANT_BLOCK_2D,
                                           quantize_blocks_2d)
        from .program import Operator
        from .scope import global_scope

        scope = scope or global_scope()
        bits = int(self.attrs.get("bits", 8))
        tile = int(self.attrs.get("block", QUANT_BLOCK_2D))
        if bits not in (8, 4):
            raise InvalidArgumentError(
                f"quantize_params_pass supports bits in (8, 4), got {bits}")

        written, consumers = set(), {}
        for blk in program.blocks:
            for op in blk.ops:
                written.update(op.output_names())
                for name in op.input_names():
                    consumers.setdefault(name, []).append(op)

        def weight_slot(op):
            if op.type == "mul" and op.attrs.get("y_num_col_dims", 1) == 1:
                return "Y"
            if op.type == "lookup_table":
                return "W"
            return None

        def rewritable(name):
            ops = consumers.get(name, [])
            return bool(ops) and all(
                weight_slot(op) is not None
                and op.inputs.get(weight_slot(op)) == [name]
                and not any(name in vs for s, vs in op.inputs.items()
                            if s != weight_slot(op))
                for op in ops)

        chosen = {}
        for blk in program.blocks:
            for name, var in blk.vars.items():
                if (not var.persistable or name in written
                        or var.shape is None or len(var.shape) != 2
                        or -1 in var.shape
                        or dtype_name(var.dtype) != "float32"):
                    continue
                reuse = not scope.has_var(name)
                if reuse and not (scope.has_var(name + "@qparam")
                                  and scope.has_var(name + "@qscale")):
                    continue
                if bits == 4 and var.shape[1] % 2:
                    continue     # nibble packing needs even columns
                if rewritable(name):
                    chosen[name] = (blk, reuse)
        if not chosen:
            return program

        for name, (blk, reuse) in chosen.items():
            qname, sname = name + "@qparam", name + "@qscale"
            if reuse:
                var = blk.vars[name]
                q, s = scope.get(qname), scope.get(sname)
                want_cols = var.shape[1] // 2 if bits == 4 else var.shape[1]
                if tuple(q.shape) != (var.shape[0], want_cols):
                    raise InvalidArgumentError(
                        f"existing quantized payload {qname} has shape "
                        f"{tuple(q.shape)}, incompatible with {name} "
                        f"{tuple(var.shape)} at bits={bits} — the twin "
                        f"program must be quantized at the same bits as "
                        f"the scope's resident payloads")
            else:
                q, s = quantize_blocks_2d(scope.get(name), bits=bits,
                                          block=tile)
            blk.create_var(name=qname, shape=tuple(q.shape), dtype="int8",
                           persistable=True, stop_gradient=True)
            blk.create_var(name=sname, shape=tuple(s.shape),
                           dtype="float32", persistable=True,
                           stop_gradient=True)
            if not reuse:
                scope.set_var(qname, q)
                scope.set_var(sname, s)
                scope.erase(name)
            blk.vars.pop(name, None)

        for blk in program.blocks:
            for i, op in enumerate(blk.ops):
                if op.type == "mul" and op.inputs["Y"][0] in chosen:
                    wname = op.inputs["Y"][0]
                    attrs = {"bits": bits, "x_num_col_dims":
                             op.attrs.get("x_num_col_dims", 1)}
                    if op.attrs.get("use_bf16", False):
                        attrs["use_bf16"] = True
                    new = Operator(
                        blk, "qmatmul",
                        inputs={"X": op.inputs["X"],
                                "QW": [wname + "@qparam"],
                                "Scales": [wname + "@qscale"]},
                        outputs={"Out": op.outputs["Out"]}, attrs=attrs)
                elif op.type == "lookup_table" and \
                        op.inputs["W"][0] in chosen:
                    wname = op.inputs["W"][0]
                    attrs = {"bits": bits}
                    if op.attrs.get("padding_idx") is not None:
                        attrs["padding_idx"] = op.attrs["padding_idx"]
                    new = Operator(
                        blk, "qlookup",
                        inputs={"Ids": op.inputs["Ids"],
                                "QW": [wname + "@qparam"],
                                "Scales": [wname + "@qscale"]},
                        outputs={"Out": op.outputs["Out"]}, attrs=attrs)
                else:
                    continue
                blk.ops[i] = new
                out = new.outputs["Out"][0]
                if out in blk.vars:
                    blk.vars[out].op = new
        program._bump()
        return program


# ---------------------------------------------------------------------------
# pipeline partitioning (≙ the JAX package's pipeline_partition_pass, itself
# ≙ the reference's pipeline_trainer program-section splitting). The pass
# cuts the single vjp_region's forward segment into K contiguous stages
# balanced by the analytic cost model, validates every boundary is a narrow
# activation cut, splices explicit `pp_send`/`pp_recv` ops at the cuts, and
# replaces the vjp_region with a `pp_pipeline_region` executed by the
# GPipe/1F1B schedule engine (parallel/pipeline.py run_pp_region).
# ---------------------------------------------------------------------------


def _pipeline_cost_fns():
    """(op_cost_flops_bytes, op_time_cost) from framework/costs.py — the
    one analytic cost model, shared with the predict() ledger API (on the
    card's constants: the balance, and so the cut, follows the H100's
    flops-to-bytes ridge)."""
    from .costs import op_cost_flops_bytes, op_time_cost
    return op_cost_flops_bytes, op_time_cost


@register_pass("pipeline_partition_pass")
class PipelinePartitionPass(Pass):
    """Program-level pipeline partitioning. attrs:
      num_stages (K >= 2), num_microbatches, schedule ('gpipe'|'1f1b'),
      dp_axis ('' when the mesh has no data axis), reduce_dp (pmean grads
      over dp inside the region — False when the r08 dp_grad_comm pipeline
      owns the dp reduction), max_boundary_vars (narrow-cut gate),
      nominal_batch (cost-model batch stand-in for -1 dims).

    Gates (rejected, not mis-trained): multiple backward regions;
    batch-global ops (batch_norm folds statistics over the whole batch —
    per-microbatch execution would silently change them); non-MEAN losses
    (per-microbatch means average to the global mean only for equal
    microbatches of a mean-reduced loss); wide/non-float boundary cuts;
    load-bearing downstream consumers of forward activations (pipeline
    publishes only the loss + parameter gradients; pure metric-head sinks
    are pruned instead, and fetching them raises the clear error)."""

    allowed_attrs = ("num_stages", "num_microbatches", "schedule",
                     "dp_axis", "reduce_dp", "max_boundary_vars",
                     "nominal_batch")

    @staticmethod
    def _batch_led(block, name):
        try:
            v = block.var(name)
        except NotFoundError:
            return True     # undeclared sidecars (@SEQLEN) are batch-led
        shape = getattr(v, "shape", None)
        return shape is None or (bool(shape) and shape[0] == -1)

    def apply(self, program, scope=None):
        from ..core.dtypes import convert_dtype, dtype_name
        from ..parallel.grad_comm import _BATCH_GLOBAL_OPS, _MEAN_LOSS_OPS
        from ..parallel.mesh import PIPELINE_AXIS
        from ..parallel.pipeline import PP_REGION_TYPE  # registers pp ops
        from .program import Operator

        if getattr(program, "_pp_applied", False):
            return program
        K = int(self.attrs["num_stages"])
        M = int(self.attrs.get("num_microbatches", 1))
        schedule = self.attrs.get("schedule", "1f1b")
        max_bvars = int(self.attrs.get("max_boundary_vars", 8))
        enforce(K >= 2, f"pipeline_partition_pass needs num_stages >= 2, "
                f"got {K}", exc=InvalidArgumentError)

        out = program.clone()
        out._dp_comm_applied = getattr(program, "_dp_comm_applied", False)
        block = out.global_block()
        regions = [i for i, op in enumerate(block.ops)
                   if op.type == "vjp_region"]
        enforce(len(regions) == 1,
                f"pipeline partitioning supports exactly one backward "
                f"region (vjp_region), found {len(regions)}: multi-loss "
                f"programs cannot be cut into one faithful stage chain. "
                f"Run without pipeline_stages",
                exc=InvalidArgumentError)
        rop = block.ops[regions[0]]
        seg = list(rop.attrs["fwd_ops"])
        loss_name = rop.attrs["loss"]
        targets = list(rop.attrs["targets"])
        enforce(len(seg) >= K,
                f"cannot cut {len(seg)} forward ops into {K} non-empty "
                f"pipeline stages", exc=InvalidArgumentError)
        seg_ops = [block.ops[i] for i in seg]

        bad = sorted({op.type for op in seg_ops
                      if op.type in _BATCH_GLOBAL_OPS})
        enforce(not bad,
                f"pipeline execution runs the forward per-microbatch, but "
                f"ops {bad} fold statistics over the WHOLE batch and would "
                f"silently compute per-microbatch statistics instead. Run "
                f"this program without pipeline_stages",
                exc=InvalidArgumentError)
        from .analysis import op_loc
        producer = next((o for o in reversed(seg_ops)
                         if loss_name in o.output_names()), None)
        if producer is None or producer.type not in _MEAN_LOSS_OPS:
            # provenance built only on the failing path: the index scan +
            # formatting must not run on every successful apply
            desc = (op_loc(block, block.ops.index(producer), producer)
                    if producer else "<nothing>")
            enforce(False,
                    f"pipeline execution requires a MEAN-reduced loss (got "
                    f"{loss_name!r} produced by {desc}): "
                    f"per-microbatch mean losses average to the global-batch "
                    f"mean only for equal microbatches of a mean reduction. "
                    f"Reduce the loss with layers.mean / reduce_mean",
                    exc=InvalidArgumentError)

        # --- cost-balanced contiguous partition -------------------------
        cost_fn, combine = _pipeline_cost_fns()
        nb = int(self.attrs.get("nominal_batch", 8))
        costs = [combine(*cost_fn(op, block, nb)) for op in seg_ops]
        bounds = _balanced_partition(costs, K)
        stage_pos = [seg[a:b] for a, b in bounds]

        # --- boundary (cut) computation + narrow-cut validation ----------
        produced, prod_pos = {}, {}
        for k, idxs in enumerate(stage_pos):
            for i in idxs:
                for n in block.ops[i].output_names():
                    if n not in produced:
                        produced[n] = k
                        prod_pos[n] = i
        reads_by_stage = [set() for _ in range(K)]
        for k, idxs in enumerate(stage_pos):
            for i in idxs:
                reads_by_stage[k] |= set(block.ops[i].input_names())
        seg_produced = set(produced)
        ext_reads = set().union(*reads_by_stage) - seg_produced
        enforce(produced.get(loss_name) == K - 1,
                f"loss {loss_name!r} is not produced by the last stage — "
                f"partitioner bug", exc=InvalidArgumentError)

        crossings = []
        for c in range(K - 1):
            later_reads = set().union(*reads_by_stage[c + 1:])
            names = sorted((n for n, pk in produced.items()
                            if pk <= c and n in later_reads),
                           key=lambda n: prod_pos[n])
            enforce(names, f"stage cut {c} carries no activation — the "
                    f"loss would not depend on stages <= {c} "
                    f"(partitioner bug)", exc=InvalidArgumentError)
            enforce(len(names) <= max_bvars,
                    f"stage boundary {c} is not a narrow activation cut: "
                    f"{len(names)} variables would cross it "
                    f"({names[:6]}{'...' if len(names) > 6 else ''}). "
                    f"Pick a different num_stages or restructure the "
                    f"model so stage boundaries carry one activation",
                    exc=InvalidArgumentError)
            for n in names:
                v = block.var(n)
                enforce(not v.persistable,
                        f"boundary var {n!r} at cut {c} is persistable — "
                        f"state cannot cross a pipeline cut",
                        exc=InvalidArgumentError)
                enforce(convert_dtype(v.dtype).is_floating_point,
                        f"boundary var {n!r} at cut {c} has non-float "
                        f"dtype {dtype_name(v.dtype)}; only floating activations may "
                        f"cross a stage cut (ids/labels are feeds — they "
                        f"reach every stage directly)",
                        exc=InvalidArgumentError)
            crossings.append(names)

        # --- downstream consumers of forward activations -----------------
        # Forward values only ever exist per-microbatch on their stage's
        # device, so ops outside the region cannot read them. Pure sink
        # chains (metric heads: accuracy/top_k over the logits) are PRUNED
        # transitively — fetching their outputs raises the clear pipeline
        # error at compile (_pp_hidden). Anything load-bearing (an
        # optimize/backward-role op) reading a hidden activation cannot be
        # pruned and is rejected instead.
        hidden = set(seg_produced) - {loss_name}
        seg_set = set(seg)
        dropped_ops = set()
        for i, op in enumerate(block.ops):
            if i in seg_set or op is rop:
                continue
            bad_reads = sorted(set(op.input_names()) & hidden)
            if not bad_reads:
                continue
            from .analysis import op_loc
            enforce(op.attrs.get("op_role") not in ("optimize", "backward"),
                    f"{op_loc(block, i, op)} (role "
                    f"{op.attrs.get('op_role')!r}) reads forward "
                    f"activation(s) {bad_reads} computed inside the "
                    f"pipeline region and cannot be pruned: pipeline mode "
                    f"publishes only the loss and parameter gradients. "
                    f"Run this program without pipeline_stages",
                    exc=InvalidArgumentError)
            dropped_ops.add(id(op))
            hidden |= set(op.output_names())

        # --- splice pp_send/pp_recv at every cut -------------------------
        # both sides of a cut share one correlation id: a merged
        # cross-rank timeline (paddle_tpu_torch/tools/trace_merge.py)
        # pairs the sender's and receiver's spans by it, so "who waited
        # on whom" reads off the matched corr_id lanes
        sends, recvs = [], []
        for c in range(K - 1):
            corr = f"ppcut-{c}-s{c}to{c + 1}"
            buf = block.create_var(name=f"pp_cut{c}@PP", shape=None,
                                   dtype="float32", stop_gradient=True)
            sends.append(Operator(
                block, "pp_send", inputs={"X": list(crossings[c])},
                outputs={"Out": [buf.name]},
                attrs={"cut": c, "corr_id": corr, "op_role": "forward"}))
            recvs.append(Operator(
                block, "pp_recv", inputs={"X": [buf.name]},
                outputs={"Out": list(crossings[c])},
                attrs={"cut": c, "corr_id": corr, "op_role": "forward"}))
        ins_by_pos: Dict[int, list] = {}
        for c in range(K - 1):
            ins_by_pos.setdefault(stage_pos[c][-1] + 1, []).append(sends[c])
            ins_by_pos.setdefault(stage_pos[c + 1][0], []).append(recvs[c])
        new_ops = []
        for i, op in enumerate(block.ops):
            # a send (insert AFTER op i-1) sorts before a recv (insert
            # BEFORE op i) at the same position: sends were appended first
            for nop in ins_by_pos.get(i, []):
                new_ops.append(nop)
            if id(op) not in dropped_ops:
                new_ops.append(op)

        stage_objs = []
        for k in range(K):
            objs = ([recvs[k - 1]] if k > 0 else []) \
                + [block.ops[i] for i in stage_pos[k]] \
                + ([sends[k]] if k < K - 1 else [])
            stage_objs.append(objs)
        newidx = {id(op): i for i, op in enumerate(new_ops)}
        stage_idx_lists = [[newidx[id(o)] for o in objs]
                           for objs in stage_objs]

        # --- replace the vjp_region with the pipeline region -------------
        x_names = sorted(ext_reads | set(targets))
        batch_led = [n for n in x_names
                     if n not in set(targets) and self._batch_led(block, n)]
        region = Operator(
            block, PP_REGION_TYPE,
            inputs={"X": x_names},
            outputs={"Grads": list(rop.outputs["Grads"]),
                     "LossGrad": list(rop.outputs["LossGrad"])},
            attrs={"fwd_ops": sorted(i for lst in stage_idx_lists
                                     for i in lst),
                   "stages": stage_idx_lists,
                   "num_stages": K, "num_microbatches": M,
                   "schedule": schedule, "axis": PIPELINE_AXIS,
                   "dp_axis": self.attrs.get("dp_axis", ""),
                   "reduce_dp": bool(self.attrs.get("reduce_dp", False)),
                   "targets": targets, "loss": loss_name,
                   "x_names": x_names, "batch_led": batch_led,
                   "stage_costs": [float(sum(costs[a:b]))
                                   for a, b in bounds],
                   "op_role": "backward"})
        new_ops[newidx[id(rop)]] = region
        block.ops = new_ops

        out._bump()
        out._pp_applied = True
        out._pp_hidden = frozenset(hidden)
        out._pp_microbatches = M
        out._pp_stages = K
        return out


def _decode_chains(program: Program) -> int:
    """How many decode-attention chains `program` still holds in the blocks
    the pass visits, whether or not their intermediates allow fusing."""
    chain = FuseDecodeAttentionPass()._chain
    n = 0
    for block in _visited_blocks(program):
        producer = {name: op for op in block.ops
                    for name in op.output_names()}
        n += sum(1 for si, op in enumerate(block.ops)
                 if op.type == "softmax"
                 and chain(block, block.ops, si, producer) is not None)
    return n


def apply_fusion_passes(program: Program, protected=(),
                        require_fused=False) -> Program:
    """Executor-time entry: apply the flag-enabled fusion passes to one
    CLONE of `program` (the caller's program is never mutated). Returns the
    original program untouched when the flags are off or nothing can match
    — the common case costs one cheap op-type scan.

    require_fused (an executor on a CUDA device): decode attention and the
    default-activation recurrent cells run on the card only through their
    kernels, so a decode-attention chain left unfused (the flag off, or an
    intermediate of the chain fetched or read elsewhere) or a fusable
    `dynamic_lstm` / `dynamic_gru` left unfused (the flag off) raises
    InvalidArgumentError instead of running as plain ops."""
    from ..core import flags
    fuse_dec = flags.get_flag("fuse_decode_attention")
    fuse_rnn = flags.get_flag("fuse_recurrent_cells")
    has_dec = any(op.type == "softmax" for blk in _visited_blocks(program)
                  for op in blk.ops)
    has_rnn = any(_fusable_recurrent(op) for blk in program.blocks
                  for op in blk.ops)
    rewritten = program
    if (fuse_dec and has_dec) or (fuse_rnn and has_rnn):
        rewritten = program.clone()
        if fuse_rnn and has_rnn:
            get_pass("fuse_recurrent_cell_pass")(rewritten)
        if fuse_dec and has_dec:
            get_pass("fuse_decode_attention_pass",
                     protected=sorted(protected))(rewritten)
    if require_fused:
        left = _decode_chains(rewritten) if has_dec else 0
        if left:
            why = ("the fuse_decode_attention flag is off" if not fuse_dec
                   else "an intermediate of the chain is fetched or read "
                   "elsewhere")
            raise InvalidArgumentError(
                f"{left} decode-attention chain(s) would run unfused on a "
                f"CUDA device ({why}); on the card decode attention runs "
                f"only through its kernel")
        cells = [op.type for blk in rewritten.blocks for op in blk.ops
                 if _fusable_recurrent(op)]
        if cells:
            raise InvalidArgumentError(
                f"{len(cells)} recurrent op(s) {sorted(set(cells))} with "
                f"the default activations would run unfused on a CUDA "
                f"device (the fuse_recurrent_cells flag is off); on the "
                f"card they run only through the fused-cell kernels")
    return rewritten


class Analyzer:
    """Ordered pass manager preparing a trained program for serving
    (≙ inference/analysis/analyzer.h:53 running its pass pipeline).

        program = Analyzer(passes=["memory_optimize_pass"]).run(program)

    The default list is the JAX package's, `bn_fold_pass`: batch norms
    folded into the convs and fc layers before them, in the program and in
    the scope."""

    DEFAULT_PASSES = ["bn_fold_pass"]

    def __init__(self, passes: Optional[List[str]] = None, **pass_attrs):
        self.pass_names = list(passes or self.DEFAULT_PASSES)
        self.pass_attrs = pass_attrs

    def run(self, program: Program, scope: Optional[Scope] = None,
            targets=None) -> Program:
        scope = scope or global_scope()
        if targets is not None:
            program = get_pass("prune_pass", targets=targets)(program, scope)
        for name in self.pass_names:
            attrs = self.pass_attrs.get(name, {})
            program = get_pass(name, **attrs)(program, scope)
        return program
