"""Pipeline parallelism over the `pp` mesh axis.

≙ paddle_tpu/parallel/pipeline.py. Two layers live here:

1. `pipeline_apply` — the GPipe-style ring for UNIFORM stages (stage
   parameters stacked with a leading [num_stages] dim split over `pp`),
   on the port's differentiable `ppermute`.

2. The program-level executor mode: `framework/passes.py`
   `pipeline_partition_pass` cuts the op DAG into K contiguous stages and
   splices explicit `pp_send` / `pp_recv` ops at the cuts; the
   `pp_pipeline_region` engine here runs a STATIC tick schedule — GPipe or
   non-interleaved 1F1B — from the host-side tables of `build_schedule`
   (copied from the JAX package, so `schedule_census` reads the tables the
   engine executes).

The JAX engine runs one `lax.scan` over ticks inside the executor's
shard_map, a `lax.switch` per stage, and shifts one activation and one
gradient buffer through a `ppermute` pair EVERY tick (a scan body is
uniform). The port runs one process per pp rank (ParallelExecutor):

- rank k runs stage k's ops on the ticks its table row names. A forward
  tick runs the stage under `torch.no_grad` and packs the cut's
  activations into one float32 buffer (the JAX `_pack`: bfloat16
  activations round alike); a backward tick recomputes the stage forward
  under torch.autograd from the stashed boundary input (activation
  checkpointing at stage granularity) and pulls back the incoming
  boundary gradient, or the 1/M loss seed on the last stage;
- each stage keeps its own activation and gradient stashes, slot
  `mb % depth` with the tables' depths;
- boundary buffers move over torch.distributed point-to-point
  (`batch_isend_irecv` on the pp group: NCCL on the cards, gloo on the
  CPU), and ONLY on ticks whose arrival table names a microbatch;
- parameter gradients accumulate over the microbatches; after the last
  tick one all-reduce (sum) over pp gives every stage the totals (and the
  loss), then a mean over dp when the region owns the dp reduction;
- randomness comes from a generator per (microbatch, stage), seeded as
  the JAX `fold_in(mb * K + k)`, so the backward's recompute replays the
  forward's draws.

`run_one_process` runs every stage of a partitioned program in ONE process
on one device through the same tick loop, tables, stashes, recompute and
accumulation, each tick's outputs landing on the neighbour's stash (as the
ring ran in one process in `ring_attention.ring_forward_local`): the only
way one card holds the engine, since NCCL refuses two ranks on one card.
ParallelExecutor never falls back to it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.enforce import InvalidArgumentError, enforce
from ..framework.registry import (LowerCtx, register_effects,  # noqa: F401
                                  register_infer_spec, register_op)
from .collective import ppermute, ring_perm
from .mesh import (PIPELINE_AXIS, DeviceMesh, current_mesh,  # noqa: F401
                   shard_map)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _pipeline_body(stage_fn: Callable, axis_name: str):
    """The per-rank pipeline function: (stage_params, x) -> y where
    stage_params is this rank's stage (leading stacked dim cut to 1 by
    shard_map) and x: [M, mb, ...] the microbatched input (replicated)."""
    from . import collective as C

    def body(params, x):
        params = _tree_map(lambda p: p[0], params)
        n = C.axis_size(axis_name)
        idx = C.axis_index(axis_name)
        m = x.shape[0]
        perm = ring_perm(n)
        state = torch.zeros_like(x[0])
        ys = []
        for t in range(m + n - 1):
            # stage 0 ingests microbatch t (if any); others take the ring
            inp = x[min(t, m - 1)] if idx == 0 else state
            out = stage_fn(params, inp)
            # the last stage emits microbatch t-(n-1)
            if t >= n - 1:
                ys.append(out if idx == n - 1 else torch.zeros_like(out))
            state = ppermute(out, axis_name, perm)
        # only the last rank holds real outputs; share them over the ring
        return C.all_reduce(torch.stack(ys), axis_name)

    return body


def pipeline_apply(mesh: DeviceMesh, stage_fn: Callable, stacked_params, x,
                   num_microbatches: int, axis_name: str = PIPELINE_AXIS):
    """Run `stage_fn(params_i, x) -> y` as a pipeline over the pp axis.

    stacked_params: pytree (dict / list / tuple) whose leaves have leading
    dim == pp axis size. x: [B, ...] global batch; it is reshaped to
    [M, B/M, ...] microbatches. Returns y: [B, ...]."""
    b = x.shape[0]
    enforce(num_microbatches >= 1,
            f"num_microbatches must be >= 1, got {num_microbatches}",
            exc=InvalidArgumentError)
    enforce(b % num_microbatches == 0,
            f"pipeline_apply: batch size {b} is not divisible by "
            f"num_microbatches {num_microbatches}; every microbatch must be "
            f"equal-sized (the schedule averages per-microbatch losses and "
            f"an uneven tail would be silently re-weighted). Pad the batch "
            f"or pick a divisor of {b}",
            exc=InvalidArgumentError)
    xm = x.reshape((num_microbatches, b // num_microbatches)
                   + tuple(x.shape[1:]))
    # the ring buffer requires stage output shape/dtype == input: probe one
    # stage on meta tensors and fail fast with a clear message
    probe_p = _tree_map(lambda p: torch.empty(tuple(p.shape[1:]),
                                              dtype=p.dtype, device="meta"),
                        stacked_params)
    probe_x = torch.empty(tuple(xm.shape[1:]), dtype=xm.dtype, device="meta")
    with torch.no_grad():
        out = stage_fn(probe_p, probe_x)
    if (tuple(out.shape), out.dtype) != (tuple(probe_x.shape), probe_x.dtype):
        raise ValueError(
            f"pipeline stage must map activations to the same shape/dtype "
            f"(got {tuple(probe_x.shape)}/{probe_x.dtype} -> "
            f"{tuple(out.shape)}/{out.dtype}); wrap shape-changing "
            f"layers into the first/last stage outside the pipeline")
    from .tensor_parallel import split_once
    n = mesh.axis_size(axis_name)
    with mesh:
        # this rank's stage of every stacked leaf (≙ shard_map's in_spec
        # P(axis_name)): the cut's backward gathers the cotangent
        local = _tree_map(lambda p: split_once(
            p, axis_name, 0, n, mesh.axis_index(axis_name)),
            stacked_params)
        ym = _pipeline_body(stage_fn, axis_name)(local, xm)
    return ym.reshape((b,) + tuple(ym.shape[2:]))


# ===========================================================================
# program-level pipeline execution (pp_pipeline_region)
# ===========================================================================

PP_REGION_TYPE = "pp_pipeline_region"
PIPELINE_SCHEDULES = ("gpipe", "1f1b")

# ParallelExecutor binds this rank's pp coordinate here for the step (≙ the
# JAX package's traced index); outside a step the current mesh's.
_CURRENT_PP_INDEX: List = []


class pp_index_scope:
    """Context manager binding this rank's pp stage index for the region."""

    def __init__(self, idx):
        self.idx = idx

    def __enter__(self):
        _CURRENT_PP_INDEX.append(self.idx)

    def __exit__(self, *a):
        _CURRENT_PP_INDEX.pop()


def current_pp_index(axis_name: str) -> int:
    if _CURRENT_PP_INDEX:
        return _CURRENT_PP_INDEX[-1]
    return current_mesh().axis_index(axis_name)


def pipeline_config(strategy) -> Optional[Dict]:
    """None when the strategy does not ask for program-level pipelining (or
    the PTPU_PIPELINE=0 kill switch is down); otherwise the resolved
    config."""
    from ..core import flags
    stages = int(getattr(strategy, "pipeline_stages", 0) or 0)
    if stages <= 1 or not flags.get_flag("pipeline"):
        return None
    sched = getattr(strategy, "pipeline_schedule", "1f1b")
    enforce(sched in PIPELINE_SCHEDULES,
            f"BuildStrategy.pipeline_schedule must be one of "
            f"{PIPELINE_SCHEDULES}, got {sched!r}",
            exc=InvalidArgumentError)
    m = int(getattr(strategy, "num_microbatches", 1) or 1)
    enforce(m >= 1,
            f"BuildStrategy.num_microbatches must be >= 1, got {m}",
            exc=InvalidArgumentError)
    return {"stages": stages, "microbatches": m, "schedule": sched}


# ---------------------------------------------------------------------------
# schedule tables: host-side slot-synchronous simulation (the JAX package's)
# ---------------------------------------------------------------------------

class PipelineSchedule:
    """Static tick tables driving the engine. Slot model: each tick a
    stage performs ONE forward or ONE backward (or idles — a bubble);
    boundary activations/gradients sent at the END of a tick arrive for
    the next tick. Tables are [ticks, num_stages] int arrays of microbatch
    indices, -1 = none."""

    def __init__(self, name, num_microbatches, num_stages, fwd_mb, bwd_mb,
                 fwd_slot, bwd_slot):
        self.name = name
        self.num_microbatches = num_microbatches
        self.num_stages = num_stages
        self.fwd_mb = fwd_mb                      # [T, K]
        self.bwd_mb = bwd_mb                      # [T, K]
        self.ticks = fwd_mb.shape[0]
        self._fwd_slot = fwd_slot                 # [K][M] completion slots
        self._bwd_slot = bwd_slot
        K, T = num_stages, self.ticks
        # arrival tables: what lands on stage k's stash at END of tick t
        self.arr_act = np.full((T, K), -1, np.int32)
        self.arr_act[:, 1:] = fwd_mb[:, :-1]
        self.arr_grad = np.full((T, K), -1, np.int32)
        self.arr_grad[:, :-1] = bwd_mb[:, 1:]
        # stash depths: peak count of microbatches live (arrived, backward
        # not yet done) — the live window is contiguous in mb index (fwd and
        # bwd both issue in order), so `mb % depth` is collision-free
        self.act_stash_depth = max(1, max(
            self._peak_live(k, arrival="act") for k in range(K)))
        self.grad_stash_depth = max(1, max(
            self._peak_live(k, arrival="grad") for k in range(K)))

    def _peak_live(self, k, arrival):
        """Peak occupancy of stage k's stash: live interval of microbatch m
        is (arrival_slot, bwd_slot] — arrival is the upstream fwd (act) or
        downstream bwd (grad); edge stages (0 for act, K-1 for grad) own
        the value locally (no stash needed), counted from local issue."""
        M, K = self.num_microbatches, self.num_stages
        if arrival == "act":
            arr = (self._fwd_slot[k - 1] if k > 0 else self._fwd_slot[k])
        else:
            if k == K - 1:
                return 0
            arr = self._bwd_slot[k + 1]
        done = self._bwd_slot[k]
        peak = 0
        for t in range(self.ticks + 1):
            live = sum(1 for m in range(M) if arr[m] < t <= done[m])
            peak = max(peak, live)
        return peak

    def stash_census(self):
        """Per-stage peak stashed-microbatch count (activation liveness):
        for stage k, the max number of microbatches whose forward input is
        held for a pending backward, derived from the executed tables."""
        return [self._peak_live(k, "act") for k in range(self.num_stages)]

    def bubble_census(self):
        M, K, T = self.num_microbatches, self.num_stages, self.ticks
        idle = [int(T - (self.fwd_mb[:, k] >= 0).sum()
                    - (self.bwd_mb[:, k] >= 0).sum()) for k in range(K)]
        return {
            "ticks": T,
            "work_slots_per_stage": 2 * M,
            "idle_slots_per_stage": idle,
            "bubble_fraction_per_stage": [i / T for i in idle],
            "bubble_fraction": (T - 2 * M) / T,
            "analytic_bubble_fraction": (K - 1) / (M + K - 1),
        }


def build_schedule(name: str, num_microbatches: int,
                   num_stages: int) -> PipelineSchedule:
    """Simulate the slot-synchronous schedule and emit its tick tables.

    One simulator, one knob: the per-stage in-flight limit. GPipe allows M
    microbatches in flight (all forwards first, flush at the end); 1F1B
    caps stage k at min(K - k, M) — after its warmup a stage must retire a
    backward before admitting the next forward, which is exactly the
    1-forward-1-backward steady state and the bounded activation stash.
    Recorded as a "pp_tick" span (schedule/M/K provenance)."""
    from ..observability import tracing as _tracing
    with _tracing.span("pp_tick", "pipeline/build_schedule",
                       schedule=str(name), microbatches=int(num_microbatches),
                       stages=int(num_stages)):
        return _build_schedule_impl(name, num_microbatches, num_stages)


def _build_schedule_impl(name: str, num_microbatches: int,
                         num_stages: int) -> PipelineSchedule:
    M, K = int(num_microbatches), int(num_stages)
    enforce(name in PIPELINE_SCHEDULES,
            f"unknown pipeline schedule {name!r}; known: "
            f"{PIPELINE_SCHEDULES}", exc=InvalidArgumentError)
    enforce(M >= 1 and K >= 1, f"need M >= 1, K >= 1 (got M={M}, K={K})",
            exc=InvalidArgumentError)
    limit = [M] * K if name == "gpipe" else [min(K - k, M) for k in range(K)]
    fwd_slot = [[None] * M for _ in range(K)]
    bwd_slot = [[None] * M for _ in range(K)]
    next_f, next_b = [0] * K, [0] * K
    rows_f, rows_b = [], []
    cap = 4 * (M + K) + 8
    t = 0
    while any(nb < M for nb in next_b):
        enforce(t < cap, f"pipeline schedule simulation did not converge "
                f"(schedule={name}, M={M}, K={K}) — scheduler bug",
                exc=InvalidArgumentError)
        row_f, row_b = [-1] * K, [-1] * K
        for k in range(K):
            nf, nb = next_f[k], next_b[k]
            f_avail = nf < M and (
                k == 0 or (fwd_slot[k - 1][nf] is not None
                           and fwd_slot[k - 1][nf] < t))
            b_avail = (nb < M and nb < nf and fwd_slot[k][nb] < t
                       and (k == K - 1 or (bwd_slot[k + 1][nb] is not None
                                           and bwd_slot[k + 1][nb] < t)))
            in_flight = nf - nb
            if b_avail and (in_flight >= limit[k] or nf >= M
                            or not f_avail):
                row_b[k] = nb
                bwd_slot[k][nb] = t
                next_b[k] += 1
            elif f_avail and in_flight < limit[k]:
                row_f[k] = nf
                fwd_slot[k][nf] = t
                next_f[k] += 1
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1
    return PipelineSchedule(name, M, K,
                            np.asarray(rows_f, np.int32),
                            np.asarray(rows_b, np.int32),
                            fwd_slot, bwd_slot)


def schedule_census(name: str, num_microbatches: int,
                    num_stages: int) -> Dict:
    """The bubble + activation-liveness census of one schedule, from the
    same tables the engine executes. `bubble_fraction` lands exactly on
    the analytic (K-1)/(M+K-1) for both schedules."""
    s = build_schedule(name, num_microbatches, num_stages)
    out = {"schedule": name, "num_microbatches": s.num_microbatches,
           "num_stages": s.num_stages}
    out.update(s.bubble_census())
    stash = s.stash_census()
    out["peak_stash_per_stage"] = stash
    out["peak_stash"] = max(stash)
    out["act_stash_depth"] = s.act_stash_depth
    out["grad_stash_depth"] = s.grad_stash_depth
    return out


# ---------------------------------------------------------------------------
# op stubs: constructed by pipeline_partition_pass, executed by the engine
# ---------------------------------------------------------------------------


@register_op("pp_send")
def _pp_send_stub(ctx, ins, attrs):
    raise RuntimeError(
        "pp_send marks a pipeline stage boundary; it is executed by the "
        "pp_pipeline_region scheduler, never lowered directly")


@register_op("pp_recv")
def _pp_recv_stub(ctx, ins, attrs):
    raise RuntimeError(
        "pp_recv marks a pipeline stage boundary; it is executed by the "
        "pp_pipeline_region scheduler, never lowered directly")


@register_op(PP_REGION_TYPE)
def _pp_region_stub(ctx, ins, attrs):
    raise RuntimeError(
        "pp_pipeline_region must be executed via the block planner "
        "(framework/lowering.py REGION_RUNNERS)")


# static-analysis infer specs (framework/analysis.py): the boundary ops are
# executed by the region scheduler, never lowered, so the analyzer needs
# their shape contract stated explicitly.

@register_infer_spec("pp_send")
def _infer_pp_send(ictx, in_shapes, in_dtypes, attrs):
    # Out is a zero-size token tying the cut into the DAG; the real
    # transfer is the scheduler's packed f32 buffer
    return {"Out": [((0,), np.dtype("float32"))]}


@register_infer_spec("pp_recv")
def _infer_pp_recv(ictx, in_shapes, in_dtypes, attrs):
    # re-binds the crossing activations on the consuming stage: shapes are
    # exactly the declared shapes of the names it re-binds
    outs = []
    for name in ictx.op.outputs["Out"]:
        decl = ictx.declared(name)
        if decl is None:
            raise NotImplementedError(
                f"pp_recv output {name!r} has no declared shape")
        outs.append(decl)
    return {"Out": outs}


# dataflow effect sets (framework/dataflow.py): the boundary ops move a
# value between pp ranks — a transfer, not a reduction; the region op runs
# the schedule's collectives over pp (plus the dp gradient mean when it
# owns the dp reduction, i.e. reduce_dp).

@register_effects("pp_send")
def _eff_pp_send(op):
    return {"collective_axes": (PIPELINE_AXIS,)}


@register_effects("pp_recv")
def _eff_pp_recv(op):
    return {"collective_axes": (PIPELINE_AXIS,)}


@register_effects(PP_REGION_TYPE)
def _eff_pp_region(op):
    axes = [op.attrs.get("axis") or PIPELINE_AXIS]
    if op.attrs.get("reduce_dp") and op.attrs.get("dp_axis"):
        axes.append(op.attrs["dp_axis"])
    return {"collective_axes": tuple(axes)}


# ---------------------------------------------------------------------------
# transports: how a tick's boundary buffers reach the neighbour stages
# ---------------------------------------------------------------------------


class _Stats:
    """Per-step transfer counts of one rank (or, in one process, of every
    stage): what the census is held to."""

    def __init__(self):
        self.sends = 0
        self.send_bytes = 0
        self.recvs = 0
        self.recv_bytes = 0

    def as_dict(self):
        return {"sends": self.sends, "send_bytes": self.send_bytes,
                "recvs": self.recvs, "recv_bytes": self.recv_bytes}


class DistTransport:
    """Point-to-point over the pp group of the current mesh: each tick's
    sends and receives go out as ONE `batch_isend_irecv` (NCCL on the
    cards, gloo on the CPU), each wrapped in a `pp_send/<cut>` /
    `pp_recv/<cut>` collective span carrying the cut's corr_id."""

    _warm = set()

    def __init__(self, mesh: DeviceMesh, axis: str):
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.group(axis)
        self.peers = mesh.axis_ranks(axis)
        self.stats = _Stats()
        enforce(self.group is not None,
                f"the pipeline engine needs a joined world with a "
                f"{axis!r} axis; this mesh has none", exc=InvalidArgumentError)
        key = id(self.group)
        if key not in DistTransport._warm:
            # the first p2p call on a group must involve all its ranks
            # (NCCL's rule for batch_isend_irecv): one tiny all-reduce first
            import torch.distributed as dist
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if dist.get_backend(self.group) == "nccl"
                   else torch.device("cpu"))
            dist.all_reduce(torch.zeros(1, device=dev), group=self.group)
            DistTransport._warm.add(key)

    def exchange(self, sends, recvs, cut_attrs):
        """sends: [(dst coord, tensor, cut)]; recvs: [(src coord, numel,
        cut, device)]. Returns the received tensors in `recvs` order."""
        import contextlib

        import torch.distributed as dist
        from ..observability import tracing as _tracing
        from .collective import batch_p2p
        ops, out = [], []
        with contextlib.ExitStack() as spans:
            for dst, t, cut in sends:
                t = t.contiguous()
                spans.enter_context(_tracing.span(
                    "collective", f"pp_send/{cut}", cut=cut,
                    corr_id=cut_attrs[cut]))
                ops.append(dist.P2POp(dist.isend, t, self.peers[dst],
                                      self.group))
                self.stats.sends += 1
                self.stats.send_bytes += t.numel() * t.element_size()
            for src, numel, cut, device in recvs:
                buf = torch.empty(numel, dtype=torch.float32, device=device)
                spans.enter_context(_tracing.span(
                    "collective", f"pp_recv/{cut}", cut=cut,
                    corr_id=cut_attrs[cut]))
                ops.append(dist.P2POp(dist.irecv, buf, self.peers[src],
                                      self.group))
                out.append(buf)
                self.stats.recvs += 1
                self.stats.recv_bytes += numel * 4
            batch_p2p(ops)
        return out


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _resolve_cuts(block, stage_ops):
    """[(cut names tuple)] for cuts 0..K-2, read off the spliced pp_send
    ops — the program IS the source of truth for what crosses each
    boundary."""
    from ..framework.analysis import op_loc
    cuts = []
    for k, ops in enumerate(stage_ops[:-1]):
        send = [op for op in ops if op.type == "pp_send"]
        if len(send) != 1:
            desc = (op_loc(block, block.ops.index(ops[0]), ops[0])
                    if ops else "<empty stage>")
            enforce(False,
                    f"stage {k} ({desc} ...) must end in exactly one "
                    f"pp_send, found {len(send)} — program not produced by "
                    f"pipeline_partition_pass?", exc=InvalidArgumentError)
        cuts.append(tuple(send[0].inputs["X"]))
    return cuts


def _stage_seed(seed: int, mb: int, k: int, K: int) -> int:
    """≙ jax.random.fold_in(key, mb * K + k): one stream per (microbatch,
    stage), the backward's recompute replaying the forward's."""
    return (int(seed) * 1000003 + mb * K + k + 1) % 2147483648


class _Region:
    """One pp_pipeline_region's static view: stages, cuts, targets and the
    tick tables (built once per plan; `ctx.constants` holds it)."""

    def __init__(self, region_op):
        attrs = region_op.attrs
        block = region_op.block
        self.op = region_op
        self.block = block
        self.K = int(attrs["num_stages"])
        self.M = int(attrs["num_microbatches"])
        self.axis = attrs["axis"]
        self.dp_axis = attrs.get("dp_axis") or None
        self.reduce_dp = bool(attrs.get("reduce_dp"))
        self.targets: List[str] = list(attrs["targets"])
        self.loss = attrs["loss"]
        self.batch_led = set(attrs["batch_led"])
        self.x_names = list(attrs["x_names"])
        self.stage_ops = [[block.ops[i] for i in idxs]
                          for idxs in attrs["stages"]]
        self.cuts = _resolve_cuts(block, self.stage_ops)
        self.corr = {}
        for ops in self.stage_ops:
            for op in ops:
                if op.type == "pp_send":
                    self.corr[op.attrs["cut"]] = op.attrs.get("corr_id", "")
        self.stage_targets = []
        for ops in self.stage_ops:
            reads = set()
            for op in ops:
                reads |= set(op.input_names())
            self.stage_targets.append([n for n in self.targets
                                       if n in reads])
        self.sched = build_schedule(attrs["schedule"], self.M, self.K)


def _run_stage(R, k, env2, bin_by_name, ctx2):
    """Run stage k's spliced op list; returns the cut's out values (None
    for the last stage)."""
    from ..framework.lowering import run_op
    out_vals = None
    for op in R.stage_ops[k]:
        if op.type == "pp_recv":
            for n in op.outputs["Out"]:
                env2[n] = bin_by_name[n]
        elif op.type == "pp_send":
            out_vals = [env2[n] for n in op.inputs["X"]]
        else:
            run_op(op, env2, ctx2)
    return out_vals


def _layouts(R, statics, stacked, mb, params, ctx):
    """Per cut [(name, shape, dtype, offset, numel)]: every stage run in
    order on meta tensors (≙ the JAX engine's eval_shape pass); the loss's
    (shape, dtype)."""
    from ..framework.analysis import _lower_ctx

    def meta(v):
        return torch.empty(tuple(v.shape), dtype=v.dtype, device="meta") \
            if isinstance(v, torch.Tensor) else v

    mctx = _lower_ctx()
    mctx.is_test = ctx.is_test
    mctx.extras = {k: v for k, v in ctx.extras.items()
                   if k not in ("op_overrides", "grad_allreduce")}
    layouts, cut_meta = [], {}
    loss_meta = None
    with torch.no_grad():
        for k in range(R.K):
            env2 = {n: meta(v) for n, v in statics.items()}
            for n, v in stacked.items():
                env2[n] = torch.empty((mb,) + tuple(v.shape[1:]),
                                      dtype=v.dtype, device="meta")
            env2.update({n: meta(p) for n, p in zip(R.targets, params)})
            ins = ({n: cut_meta[n] for n in R.cuts[k - 1]} if k > 0 else {})
            outs = _run_stage(R, k, env2, ins, mctx)
            if k == R.K - 1:
                loss_meta = env2[R.loss]
                continue
            off, lay = 0, []
            for n, v in zip(R.cuts[k], outs):
                enforce(v.is_floating_point(),
                        f"pipeline boundary var {n!r} has non-float dtype "
                        f"{v.dtype}; only floating activations may cross "
                        f"a stage cut", exc=InvalidArgumentError)
                numel = int(np.prod(v.shape)) if v.dim() else 1
                lay.append((n, tuple(v.shape), v.dtype, off, numel))
                cut_meta[n] = v
                off += numel
            layouts.append(lay)
    return layouts, (tuple(loss_meta.shape), loss_meta.dtype)


def _pack(vals):
    # packing order == the send op's input order == the cut layout
    return torch.cat([v.to(torch.float32).reshape(-1) for v in vals])


def _unpack(buf, lay):
    return {n: buf[off:off + numel].reshape(shape).to(dtype)
            for n, shape, dtype, off, numel in lay}


class _Engine:
    """The tick loop over the schedule tables for the stages this process
    runs (`stages`: [k] on a pp rank, every stage in one process)."""

    def __init__(self, R, env, ctx, stages, transport):
        self.R = R
        self.ctx = ctx
        self.stages = list(stages)
        self.transport = transport
        M = R.M
        missing = [n for n in R.targets if n not in env]
        if missing:
            from ..core.enforce import NotFoundError
            raise NotFoundError(
                f"pp_pipeline_region differentiates wrt {missing} which are "
                f"not initialized — run the startup program or feed them")
        self.params = [env[n] for n in R.targets]
        tset = set(R.targets)
        statics, stacked = {}, {}
        b = None
        for n in R.x_names:
            if n in tset:
                continue
            v = env.get(n)
            if v is None:
                continue
            if n in R.batch_led and isinstance(v, torch.Tensor) \
                    and v.dim() >= 1:
                if b is None:
                    b = v.shape[0]
                enforce(v.shape[0] == b,
                        f"pipeline feeds disagree on the batch dim: {n!r} "
                        f"has {v.shape[0]}, expected {b}",
                        exc=InvalidArgumentError)
                stacked[n] = v
            else:
                statics[n] = v
        enforce(b is not None,
                "pipeline mode needs at least one batch-led feed to "
                "microbatch", exc=InvalidArgumentError)
        enforce(b % M == 0,
                f"pipeline mode: per-shard batch {b} is not divisible by "
                f"num_microbatches {M}; the schedule averages EQUAL-sized "
                f"microbatch losses, so feed a batch divisible by "
                f"dp * num_microbatches", exc=InvalidArgumentError)
        self.mb = b // M
        self.statics, self.stacked = statics, stacked
        key = ("pp_layouts", id(R.op), self.mb,
               tuple((n, tuple(v.shape), v.dtype) for n, v in
                     stacked.items()))
        lay = ctx.constants.get(key)
        if lay is None:
            lay = ctx.constants[key] = _layouts(R, statics, stacked, self.mb,
                                                self.params, ctx)
        self.layouts, self.loss_struct = lay
        self.device = self.params[0].device if self.params else ctx.device
        self.gacc = [None] * len(R.targets)
        self.loss_sum = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
        # stashes per stage: mb % depth -> buffer (stage 0's act entries
        # mark its in-flight forwards, holding no buffer)
        self.stash_a = {k: {} for k in self.stages}
        self.stash_g = {k: {} for k in self.stages}
        self.peak_stash = {k: 0 for k in self.stages}
        self.moved_bytes = 0

    # -- one stage, one microbatch -----------------------------------------
    def _mb_env(self, i):
        e = dict(self.statics)
        for n, v in self.stacked.items():
            e[n] = v.narrow(0, i * self.mb, self.mb)
        return e

    def _stage_ctx(self, k, i):
        c = self.ctx
        return LowerCtx(device=c.device, seed=_stage_seed(c.seed, i, k,
                                                          self.R.K),
                        constants=c.constants, fetch_names=c.fetch_names,
                        is_test=c.is_test, read_names=c.read_names,
                        extras=c.extras)

    def _stage_fwd(self, k, pvals, bin_flat, i):
        R = self.R
        env2 = self._mb_env(i)
        env2.update(zip(R.targets, pvals))
        bin_by_name = _unpack(bin_flat, self.layouts[k - 1]) if k > 0 else {}
        out_vals = _run_stage(R, k, env2, bin_by_name,
                              self._stage_ctx(k, i))
        if k == R.K - 1:
            return env2[R.loss].to(torch.float32).reshape(())
        return _pack(out_vals)

    def forward(self, k, i):
        bin_f = self.stash_a[k][i % self.depth_a][1] if k > 0 else None
        with torch.no_grad():
            out = self._stage_fwd(k, self.params, bin_f, i)
        if k == self.R.K - 1:
            self.loss_sum = self.loss_sum + out
            return None
        return out

    def backward(self, k, i):
        R = self.R
        own = R.stage_targets[k]
        pos = [R.targets.index(n) for n in own]
        leaves = [self.params[j].detach().requires_grad_() for j in pos]
        pvals = list(self.params)
        for j, leaf in zip(pos, leaves):
            pvals[j] = leaf
        bin_b = None
        if k > 0:
            bin_b = self.stash_a[k][i % self.depth_a][1].detach() \
                .requires_grad_()
        with torch.enable_grad():
            out = self._stage_fwd(k, pvals, bin_b, i)
            if k < R.K - 1:
                seed = self.stash_g[k][i % self.depth_g]
            else:
                seed = torch.full((), 1.0 / R.M, dtype=torch.float32,
                                  device=out.device)
            wrt = leaves + ([bin_b] if bin_b is not None else [])
            grads = (torch.autograd.grad(out, wrt, seed, allow_unused=True)
                     if out.requires_grad and wrt else [None] * len(wrt))
        for j, leaf, g in zip(pos, leaves, grads):
            if g is None:
                continue
            self.gacc[j] = g if self.gacc[j] is None else self.gacc[j] + g
        if k == 0:
            return None
        g = grads[-1]
        return torch.zeros_like(bin_b) if g is None else g

    # -- the tick loop ---------------------------------------------------
    def run(self):
        R = self.R
        s = R.sched
        self.depth_a, self.depth_g = s.act_stash_depth, s.grad_stash_depth
        K = R.K
        for t in range(s.ticks):
            for k in self.stages:
                live = sum(1 for e in self.stash_a[k].values() if e[0] < t)
                self.peak_stash[k] = max(self.peak_stash[k], live)
            acts, grads = {}, {}
            for k in self.stages:
                fm, bm = int(s.fwd_mb[t, k]), int(s.bwd_mb[t, k])
                if fm >= 0:
                    if k == 0:
                        self._put(self.stash_a[0], fm, self.depth_a,
                                  (t, None))
                    out = self.forward(k, fm)
                    if out is not None:
                        acts[k] = (fm, out)
                elif bm >= 0:
                    g = self.backward(k, bm)
                    self.stash_a[k].pop(bm % self.depth_a)
                    if k < K - 1:
                        self.stash_g[k].pop(bm % self.depth_g)
                    if g is not None:
                        grads[k] = (bm, g)
            self._deliver(t, acts, grads)
        return self._finish()

    @staticmethod
    def _put(stash, i, depth, entry):
        enforce(i % depth not in stash,
                f"pipeline stash slot {i % depth} still holds a live "
                f"microbatch — schedule bug", exc=InvalidArgumentError)
        stash[i % depth] = entry

    def _deliver(self, t, acts, grads):
        s = self.R.sched
        if self.transport is None:
            # one process: each tick's outputs land on the neighbour's stash
            for k, (i, buf) in acts.items():
                self._put(self.stash_a[k + 1], i, self.depth_a, (t, buf))
                self.moved_bytes += buf.numel() * 4
            for k, (i, buf) in grads.items():
                self._put(self.stash_g[k - 1], i, self.depth_g, buf)
                self.moved_bytes += buf.numel() * 4
            return
        (k,) = self.stages
        sends = []
        if k in acts:
            sends.append((k + 1, acts[k][1], k))
        if k in grads:
            sends.append((k - 1, grads[k][1], k - 1))
        recvs = []
        am, gm = int(s.arr_act[t, k]), int(s.arr_grad[t, k])
        if am >= 0:
            lay = self.layouts[k - 1]
            recvs.append((k - 1, lay[-1][3] + lay[-1][4], k - 1,
                          self.device))
        if gm >= 0:
            lay = self.layouts[k]
            recvs.append((k + 1, lay[-1][3] + lay[-1][4], k, self.device))
        got = self.transport.exchange(sends, recvs, self.R.corr)
        j = 0
        if am >= 0:
            self._put(self.stash_a[k], am, self.depth_a, (t, got[j]))
            j += 1
        if gm >= 0:
            self._put(self.stash_g[k], gm, self.depth_g, got[j])

    def _finish(self):
        R = self.R
        grads = [torch.zeros_like(p) if g is None else g.to(p.dtype)
                 for p, g in zip(self.params, self.gacc)]
        loss_sum = self.loss_sum
        if self.transport is not None:
            from . import collective as C
            # the loss (held by the last stage) and one flat all-reduce
            # (sum) over pp per gradient dtype: every stage gets the totals
            # (zeros elsewhere); then the mean over dp when the region
            # owns the dp reduction
            group = C._group(R.axis)
            loss_sum = C._ar(loss_sum.reshape(1), group).reshape(())
            dp = C.axis_size(R.dp_axis) if (R.reduce_dp and R.dp_axis) \
                else 1
            by_dtype: Dict[torch.dtype, List[int]] = {}
            for j, g in enumerate(grads):
                by_dtype.setdefault(g.dtype, []).append(j)
            for idxs in by_dtype.values():
                buf = C._ar(torch.cat([grads[j].reshape(-1) for j in idxs]),
                            group)
                if dp > 1:
                    buf = C._ar(buf, C._group(R.dp_axis)) / dp
                off = 0
                for j in idxs:
                    m = grads[j].numel()
                    grads[j] = buf[off:off + m].view_as(grads[j])
                    off += m
        return loss_sum / R.M, grads


LAST_STEP: Dict[str, Any] = {}


def run_pp_region(region_op, env, ctx):
    """Execute a pp_pipeline_region: the microbatched 1F1B / GPipe schedule.

    Publishes into `env`: the loss (mean over all microbatches, LOCAL to
    the dp shard), loss@GRAD (ones), and every target's @GRAD — the
    gradient of the microbatch-mean loss, summed over pipeline stages and,
    when `reduce_dp`, averaged over the dp axis. Forward activations are
    NOT published: they only ever exist per microbatch on their stage.

    The transport is ParallelExecutor's pp group (`ctx.extras
    ["pp_transport"]`, this rank running its own stage), or, inside
    `one_process()`, none: every stage runs here."""
    from ..framework.lowering import grad_var_name
    key = ("pp_region", id(region_op))
    R = ctx.constants.get(key)
    if R is None:
        R = ctx.constants[key] = _Region(region_op)
    transport = ctx.extras.get("pp_transport")
    if transport is not None:
        k = current_pp_index(R.axis)
        enforce(transport.mesh.axis_size(R.axis) == R.K,
                f"the pipeline region has {R.K} stages but the mesh's "
                f"{R.axis!r} axis has {transport.mesh.axis_size(R.axis)} "
                f"ranks", exc=InvalidArgumentError)
        transport.stats = _Stats()
        eng = _Engine(R, env, ctx, [k], transport)
    else:
        enforce(_ONE_PROCESS, "a pipeline-partitioned program runs through "
                "ParallelExecutor on a mesh whose pp axis has one rank per "
                "stage, or in one process inside "
                "parallel.pipeline.one_process()", exc=InvalidArgumentError)
        eng = _Engine(R, env, ctx, range(R.K), None)
    loss, grads = eng.run()
    LAST_STEP.clear()
    LAST_STEP.update({
        "peak_stash_per_stage": [eng.peak_stash[k] for k in eng.stages],
        "stages": list(eng.stages),
        "moved_bytes": (eng.moved_bytes if transport is None else
                        transport.stats.send_bytes),
        "transfers": (transport.stats.as_dict() if transport is not None
                      else None),
        "ticks": R.sched.ticks,
    })
    shape, dtype = eng.loss_struct
    loss_val = loss.to(dtype).reshape(shape)
    env[R.loss] = loss_val
    env[grad_var_name(R.loss)] = torch.ones_like(loss_val)
    for n, g in zip(R.targets, grads):
        env[grad_var_name(n)] = g


_ONE_PROCESS: List[bool] = []


class one_process:
    """Run pipeline-partitioned programs in this process: every stage,
    in tick order, on one device (the plain Executor's place)."""

    def __enter__(self):
        _ONE_PROCESS.append(True)
        return self

    def __exit__(self, *a):
        _ONE_PROCESS.pop()
        return False


def run_one_process(executor, program, feed=None, fetch_list=None,
                    scope=None, return_numpy=True):
    """`executor.run` of a pipeline-partitioned program with every stage
    in this process (see `one_process`)."""
    with one_process():
        return executor.run(program=program, feed=feed,
                            fetch_list=fetch_list, scope=scope,
                            return_numpy=return_numpy)


def pp_boundary_wire_bytes(program, microbatch_rows: int) -> Optional[Dict]:
    """Per-device interconnect bytes per STEP of a pipeline-partitioned
    program's boundary transfers in the JAX package's engine: one
    activation and one gradient buffer of S f32 (the largest cut) through
    a collective-permute EVERY tick, so 2 * ticks * S * 4 bytes. None for
    non-partitioned programs. The port's engine moves a cut only on the
    ticks that carry one (`pp_live_transfers`)."""
    if not getattr(program, "_pp_applied", False):
        return None
    block = program.global_block()
    region = next((op for op in block.ops if op.type == PP_REGION_TYPE),
                  None)
    if region is None:
        return None
    numels = cut_numels(block, microbatch_rows)
    if not numels:
        return None
    s = max(numels)
    sched = build_schedule(region.attrs["schedule"],
                           region.attrs["num_microbatches"],
                           region.attrs["num_stages"])
    per_tick = 2 * s * 4                       # act shift + grad shift
    return {"buffer_numel": s,
            "cut_numels": numels,
            "ticks_per_step": sched.ticks,
            "pp_boundary_bytes": per_tick * sched.ticks}


def cut_numels(block, microbatch_rows) -> List[int]:
    """Each cut's element count at `microbatch_rows` rows a microbatch,
    from the declared shapes of the names its pp_send carries (a -1 dim
    counts the rows), in cut order."""
    out = []
    for op in block.ops:
        if op.type != "pp_send":
            continue
        total = 0
        for n in op.inputs["X"]:
            v = block.var(n)
            numel = 1
            for d in list(v.shape or ()):
                numel *= (microbatch_rows if d == -1 else int(d))
            total += numel
        out.append(total)
    return out


def pp_live_transfers(schedule: PipelineSchedule,
                      cut_numels: List[int]) -> List[Dict]:
    """Per stage, the point-to-point transfers the port's engine makes in
    one step, read off the tables: a send per forward tick of stages
    0..K-2 (the cut's activations) and per backward tick of stages 1..K-1
    (the cut's gradient), float32; each send is one receive downstream."""
    K = schedule.num_stages
    out = []
    for k in range(K):
        sends = send_bytes = recvs = recv_bytes = 0
        if k < K - 1:
            n = int((schedule.fwd_mb[:, k] >= 0).sum())
            sends += n
            send_bytes += n * cut_numels[k] * 4
            g = int((schedule.arr_grad[:, k] >= 0).sum())
            recvs += g
            recv_bytes += g * cut_numels[k] * 4
        if k > 0:
            n = int((schedule.bwd_mb[:, k] >= 0).sum())
            sends += n
            send_bytes += n * cut_numels[k - 1] * 4
            a = int((schedule.arr_act[:, k] >= 0).sum())
            recvs += a
            recv_bytes += a * cut_numels[k - 1] * 4
        out.append({"sends": sends, "send_bytes": send_bytes,
                    "recvs": recvs, "recv_bytes": recv_bytes})
    return out


# register the region runner with the block planner
from ..framework import lowering as _lowering  # noqa: E402

_lowering.REGION_RUNNERS[PP_REGION_TYPE] = run_pp_region
