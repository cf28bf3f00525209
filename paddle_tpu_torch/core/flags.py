"""Global typed flag registry.

≙ paddle_tpu/core/flags.py, trimmed to the flags the ported slices read.
Flags are typed, documented, and can be set from the environment with the
``PTPU_`` prefix, e.g. ``PTPU_CHECK_NAN_INF=1``.

No flag here routes CUDA tensors away from a kernel: a kernel wrapper takes
its plain PyTorch version only for tensors that lie on the CPU, and an
executor on a CUDA device raises when `fuse_decode_attention` is off and its
program holds a decode-attention chain, or when `fuse_recurrent_cells` is off
and it holds a fusable `dynamic_lstm` / `dynamic_gru` (framework/passes.py
`apply_fusion_passes`). Those flags are for comparing the fused and unfused
programs on the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict

from .enforce import AlreadyExistsError, NotFoundError


@dataclass
class _FlagSpec:
    name: str
    default: Any
    parser: Callable[[str], Any]
    help: str
    value: Any


_REGISTRY: Dict[str, _FlagSpec] = {}

_ENV_PREFIX = "PTPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def _define(name: str, default: Any, parser, help: str) -> None:
    if name in _REGISTRY:
        raise AlreadyExistsError(f"flag {name!r} already defined")
    value = default
    env = os.environ.get(_ENV_PREFIX + name.upper())
    if env is not None:
        value = parser(env)
    _REGISTRY[name] = _FlagSpec(name, default, parser, help, value)


def define_bool(name: str, default: bool, help: str = "") -> None:
    _define(name, default, _parse_bool, help)


def define_int(name: str, default: int, help: str = "") -> None:
    _define(name, default, int, help)


def get_flag(name: str) -> Any:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise NotFoundError(f"unknown flag {name!r}")
    return spec.value


def set_flag(name: str, value: Any) -> None:
    spec = _REGISTRY.get(name)
    if spec is None:
        raise NotFoundError(f"unknown flag {name!r}")
    spec.value = value


def vlog(level: int, msg: str, *args) -> None:
    """Verbose logging gated on the `vlog` flag (enable with PTPU_VLOG=N)."""
    if get_flag("vlog") >= level:
        import sys
        print(f"[VLOG{level}] " + (msg % args if args else msg),
              file=sys.stderr)


define_bool("check_nan_inf", False,
            "Scan every op's floating outputs for NaN/Inf during execution "
            "and raise naming the op and variable.")
define_int("vlog", 0, "Verbose logging level.")
define_bool("use_bf16_matmul", True,
            "Run the matmuls of layers that opt in (use_bf16=True) on "
            "bfloat16 inputs with float32 accumulation and a bfloat16 "
            "output. Off: those matmuls run in float32.")
define_bool("fuse_decode_attention", True,
            "Executor-time fuse_decode_attention_pass: rewrite the "
            "cached-decode QK^T->+bias->softmax->V op chain into one "
            "fused_decode_attention op per layer "
            "(paddle_tpu_torch/fusion/decode_attention.py). Off is for the "
            "CPU only: an executor on a CUDA device raises on a program "
            "whose decode chain it leaves unfused.")
define_bool("fuse_recurrent_cells", True,
            "Executor-time fuse_recurrent_cell_pass: rewrite dynamic_lstm / "
            "dynamic_gru with the default activations to fused_lstm / "
            "fused_gru, the whole recurrence in one kernel launch "
            "(paddle_tpu_torch/fusion/recurrent.py). Off is for the CPU "
            "only: an executor on a CUDA device raises on a program whose "
            "fusable recurrent op it leaves unfused.")
define_int("sparse_dense_apply_max_bytes", 1 << 30,
           "Lazy sparse adam updates of an is_sparse embedding table: a "
           "table of at most this many bytes takes the dense-masked apply "
           "(a [height, width] scatter of the raw rows, then the update "
           "under a touched-row mask, no sort); a larger one the "
           "merged-rows path (sort, merge, and an in-place index_copy_ of "
           "the distinct rows). Both give the same lazy semantics. Set 0 to "
           "take the merged-rows path at any size.")
define_bool("pipeline", True,
            "Allow the program-level pipeline-parallel executor mode when "
            "the BuildStrategy requests it (pipeline_stages >= 2). Kill "
            "switch: PTPU_PIPELINE=0 runs the program unpartitioned "
            "(replicated over the pp axis). Read when ParallelExecutor "
            "prepares a program (parallel/pipeline.py pipeline_config).")
define_bool("auto_parallel", True,
            "Allow the auto-parallel planner (framework/auto_parallel.py) "
            "when the BuildStrategy requests it (auto_parallel=True): "
            "cost-model-guided search over the dp x pp x tp strategy "
            "space that chooses ParallelExecutor's BuildStrategy knobs and "
            "mesh factorization. Kill switch: PTPU_AUTO_PARALLEL=0 runs "
            "the user's strategy and mesh untouched.")
define_bool("tp_shard", True,
            "Allow the static sharding-propagation rewrite (framework/"
            "sharding.py tp_shard_pass) that makes tp-annotated parameters "
            "executable by ParallelExecutor on a mesh with a tp axis. Kill "
            "switch: PTPU_TP_SHARD=0 skips the rewrite, and a tp-sharded "
            "program is then rejected instead of rewritten.")
define_bool("quant_comm", True,
            "Allow quantized gradient collectives when the BuildStrategy "
            "requests them (quant_comm='int8'/'bf16'). Kill switch: "
            "PTPU_QUANT_COMM=0 forces float32 gradient transfers while "
            "keeping the explicit reduce-scatter pipeline "
            "(parallel/grad_comm.py).")
define_bool("quant_params", True,
            "Allow weight-only quantized serving when an engine requests it "
            "(quant='int8'/'int4'): quantize_params_pass rewrites a serving "
            "program's persistable f32 weights into block-scaled (payload, "
            "scales) pairs consumed by qmatmul/qlookup (framework/passes.py, "
            "parallel/collective.py quantize_blocks_2d). Kill switch: "
            "PTPU_QUANT_PARAMS=0 serves full f32 weights — the escape hatch "
            "if quantization ever hurts decode quality in production.")
define_bool("kv_sanitize", False,
            "Shadow-state KV sanitizer (serving/sanitizer.py): mirror "
            "every BlockPool/KVPager/host-tier mutation into the abstract "
            "ownership model (framework/ownership.py) and raise "
            "SanitizerDivergence naming the op, block, and invariant on "
            "the first drift. Off by default (the shadow bookkeeping costs "
            "a few percent of the host tick loop); tests/conftest.py pins "
            "it on for the test suite through PTPU_KV_SANITIZE=1. Read at "
            "KVPager construction (attach-or-None).")
define_bool("trace", True,
            "Structured step tracing (observability/tracing.py): typed "
            "nested spans (compile/step/tick/admission/dispatch/request/"
            "feed_fetch/speculate/verify/offload) recorded into the "
            "in-process ring buffer, exportable as a Chrome trace or "
            "aggregate tables. Kill switch: PTPU_TRACE=0 makes every span "
            "a no-op.")
define_int("trace_ring", 65536,
           "Capacity of the span ring buffer (observability/tracing.py). "
           "Oldest spans are overwritten; the buffer is preallocated so "
           "recording never allocates on the hot path.")
define_bool("memory_plan", True,
            "Allow the static memory planner (framework/memory_plan.py) "
            "when the BuildStrategy requests it (memory_plan=True): "
            "liveness-minimizing op scheduling, interference-graph "
            "buffer-slot coloring (checked race-free by the buffer-reuse "
            "detectors on every apply), and the remat-vs-stash search that "
            "segments the backward region under torch.utils.checkpoint. "
            "ParallelExecutor plans the program as rewritten (after the tp, "
            "dp-comm and pipeline passes); on one card the flag is part of "
            "the executor's "
            "plan-cache key (framework/executor.py _fusion_flags_key). The "
            "executor's release of each transient at its last use runs in "
            "every plan and does not read it.")
