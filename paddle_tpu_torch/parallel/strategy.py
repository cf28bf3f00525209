"""Execution/build strategy knobs for the parallel executor.

≙ paddle_tpu/parallel/strategy.py, a copy (≙ reference framework/details/
execution_strategy.h:83 + build_strategy.h:23-60): the same fields and
defaults, so a strategy built for one package builds the other. The
port's ParallelExecutor reads every field: the reduce, scale and
sequence-parallel modes, the quantized wire, the buckets, the pipeline,
the host-offloaded optimizer state, the memory plan and the auto-parallel
planner. The comments below are the JAX package's.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ReduceStrategy(enum.Enum):
    """≙ BuildStrategy::ReduceStrategy (reference build_strategy.h:44).

    AllReduce: gradients all-reduced, every device runs the full optimizer on
    replicated state (reference multi_devices_graph_pass.cc:419-425).
    Reduce: ZeRO-1 style — optimizer state sharded across the data axis;
    XLA lowers the parameter update to reduce-scatter(grad) + sharded update +
    all-gather(param) (the TPU-native form of the reference's reduce-to-owner
    + broadcast, multi_devices_graph_pass.cc:412-418,445-453).
    ReduceScatter: the explicit comm-optimized pipeline ("Automatic
    Cross-Replica Sharding of Weight Update in Data-Parallel Training",
    PAPERS.md): the step runs as per-shard SPMD code over the data axis,
    every gradient is psum_scatter'd so it is NEVER materialized unsharded,
    optimizer math runs on the local shard only, and the updated shards are
    all-gathered. Structurally asserted: no all-reduce carries gradient
    bytes (tests/test_comm_structure.py). Composes with
    BuildStrategy.quant_comm for quantized transfers.
    """
    AllReduce = 0
    Reduce = 1
    ReduceScatter = 2


class GradientScaleStrategy(enum.Enum):
    """≙ BuildStrategy::GradientScaleStrategy. CoeffNumDevice divides loss
    grad by device count (reference scale_loss_grad_op_handle); under SPMD a
    global `mean` already averages over the full global batch, so One is the
    default and CoeffNumDevice is only for parity with programs that sum."""
    CoeffNumDevice = 0
    One = 1


@dataclass
class BuildStrategy:
    reduce_strategy: ReduceStrategy = ReduceStrategy.AllReduce
    # CoeffNumDevice is rejected at ParallelExecutor construction (the SPMD
    # global-batch mean makes it unnecessary); One is the only implemented
    # mode.
    gradient_scale_strategy: GradientScaleStrategy = GradientScaleStrategy.One
    # RESERVED (accepted, not yet consumed): debug program dumps.
    debug_graphviz_path: str = ""
    # Legacy remat knob (transpiler.memory_optimize); superseded by the
    # static memory planner below — kept accepted for API parity.
    memory_optimize: bool = False
    # --- static memory planner (framework/memory_plan.py) ---------------
    # Apply memory_plan_pass to the program AS RUN (after the tp/dp-comm/
    # pipeline rewrites): liveness-minimizing op scheduling, interference-
    # graph buffer-slot coloring (proven race-free by the r13
    # buffer-reuse detectors on every sanitized apply), and the
    # remat-vs-stash search that segments the backward region under
    # jax.checkpoint when the predicted memory return fits the time
    # budget. Runtime kill switch: PTPU_MEMORY_PLAN=0 (in the executor's
    # compile cache key, so a flip recompiles unplanned).
    memory_plan: bool = False
    # Mandate the remat recompute (jax.checkpoint prevent_cse=True): the
    # searched plan's segments are really recomputed in the backward and
    # the time budget below GATES candidates by their roofline recompute
    # seconds. Default False = CSE-able mode: the recompute is a
    # liveness hint XLA may fold back wherever it would cost wall-clock
    # (measured time-neutral; the budget then only documents the upper
    # bound — no candidate is rejected on time).
    memory_plan_prevent_cse: bool = False
    # The mandated-recompute search's step-time budget: predicted
    # recompute seconds must stay within this fraction of the reference
    # step time (the program's roofline step by default; benches pass
    # the measured step via memory_plan_time_budget_s for CPU-mesh runs
    # where dispatch dominates the roofline).
    memory_plan_time_frac: float = 0.02
    # Optional MEASURED step-time budget in seconds (0 = derive from the
    # roofline via memory_plan_time_frac). On a CPU mesh the roofline
    # underestimates the step by orders of magnitude (dispatch
    # dominates), so a strict roofline budget rejects every remat plan;
    # benches measure the unplanned step once and pass
    # memory_plan_time_frac x measured seconds here.
    memory_plan_time_budget_s: float = 0.0
    enable_sequence_parallel: bool = False
    # --- communication-optimized gradient pipeline (parallel/grad_comm.py) --
    # Wire dtype for gradient collectives: "" = fp32 (off), "int8" =
    # block-scaled symmetric quantization (≙ EQuARX, PAPERS.md), "bf16" =
    # half-width cast. Setting this switches the executor to the explicit
    # per-shard gradient pipeline (like ReduceScatter). Runtime kill switch:
    # PTPU_QUANT_COMM=0 forces fp32 wire regardless of this field.
    quant_comm: str = ""
    # One f32 scale per this many gradient values on the int8 wire.
    quant_comm_block: int = 256
    # Per-replica error feedback: each shard accumulates its quantization
    # residual and adds it to the next step's contribution (state rides the
    # executor's donated carry; see docs/data_parallel.md).
    comm_error_feedback: bool = False
    # Coalesce small gradients into flat transfer buckets of at most this
    # many bytes before the collective (≙ the reference's fuse_all_reduce
    # capability, build_strategy.h fuse_all_reduce_ops_). 0 disables
    # bucketing (one collective per gradient — the probe_overlap A/B side).
    comm_bucket_bytes: int = 4 << 20
    # --- program-level pipeline parallelism (framework/passes.py
    # pipeline_partition_pass + parallel/pipeline.py schedule engine,
    # ≙ the reference's pipeline_trainer section splitting) --------------
    # Number of pipeline stages K. 0/1 = off; K >= 2 cuts the op DAG into K
    # cost-balanced contiguous stages over the mesh's `pp` axis (whose size
    # must equal K). Runtime kill switch: PTPU_PIPELINE=0 runs the program
    # unpartitioned (SPMD, replicated over pp) regardless of this field.
    pipeline_stages: int = 0
    # Microbatches M per step: the global batch must be divisible by
    # dp * M. Bubble fraction is (K-1)/(M+K-1) for both schedules — raise M
    # to amortize the fill/drain bubble.
    num_microbatches: int = 1
    # 'gpipe' (all forwards, then all backwards — activation stash grows
    # with M) or '1f1b' (warmup / 1-forward-1-backward steady state /
    # drain — stash bounded at <= K in-flight microbatches; the default).
    pipeline_schedule: str = "1f1b"
    # --- host-offload tier (framework/offload.py) ------------------------
    # ZeRO-offload optimizer state: the Reduce/ReduceScatter accumulator
    # shards live in the pinned host pool between steps and round-trip
    # per step on the shared transfer stream (restore before the step,
    # spill after), overlapped behind forward/backward compute. HBM held
    # by optimizer state drops to ~one in-flight bucket; costs.predict's
    # `offload` section prices the PCIe round-trip against the overlap
    # window so the planner can refuse it when the transfer cannot hide.
    # Runtime kill switch: PTPU_OFFLOAD=0 keeps state device-resident
    # regardless of this field.
    offload_optimizer_state: bool = False
    # Let the memory planner's remat-vs-stash search also consider
    # stashing checkpointed activations to the host tier (third
    # candidate class beside recompute and device stash), priced on the
    # same PCIe roofline. On the CPU mesh the stash executes in
    # ADVISORY mode (decision recorded + priced, transfer not lowered —
    # same discipline as the planner's pp stage decisions); the TPU
    # lowering is ROADMAP item 5(a).
    memory_plan_stash_to_host: bool = False
    # --- auto-parallel planner (framework/auto_parallel.py) --------------
    # Let the framework CHOOSE the parallelism: on first prepare the
    # executor runs the cost-model-guided search over the dp x pp x tp
    # strategy space (mesh factorization, reduce mode, pipeline
    # schedule/microbatches, comm buckets, memory plan) and adopts the
    # chosen knobs + mesh. The fields above then serve as the BASE the
    # planner overwrites; knobs that change training numerics
    # (quant_comm, comm_error_feedback) are never flipped implicitly —
    # they stay exactly as set here (auto_parallel.
    # numerics_preserving_space). On elastic restore to a CHANGED world
    # size the planner re-plans and adopts the re-plan only when its
    # predicted step time beats keeping the restored strategy
    # (parallel/elastic.py restore_train_state). Runtime kill switch:
    # PTPU_AUTO_PARALLEL=0 (in the executor's compile cache key) runs
    # the strategy/mesh exactly as constructed.
    auto_parallel: bool = False


@dataclass
class ExecutionStrategy:
    # ≙ num_iteration_per_drop_scope (scope_buffered_ssa_graph_executor.h:37):
    # how many steps between host syncs/scope cleanups. Under jit this only
    # controls how often we block_until_ready for error surfacing.
    num_iteration_per_drop_scope: int = 100
    use_experimental_executor: bool = False
    num_threads: int = 0               # accepted for API parity; XLA schedules
