"""Print the port's public API surface as stable one-line signatures.

≙ tools/print_signatures.py: the same modules (the JAX package's list,
mapped to the port) and the same one-line form as `API.spec`, the JAX
package's frozen surface. `--check` holds the port against that file:
every `API.spec` line, with `paddle_tpu` read as `paddle_tpu_torch` and
the TPU names as their CUDA counterparts (`RENAMED`), must equal the
port's line for the same path, unless the path is deliberately not
ported (`EXCLUDED`) or its difference is named with a reason in
`SIGNATURE_DIFFERENCES`. `API.spec` belongs to the JAX package: this
tool only reads it (there is no `--update`).

    python -m paddle_tpu_torch.tools.print_signatures          # print
    python -m paddle_tpu_torch.tools.print_signatures --check  # exit 1
                                                # on an unnamed difference
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import os
import re
import sys
from typing import Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
API_SPEC = os.path.join(ROOT, "API.spec")

# modules whose public (non-underscore) callables/classes form the API
PUBLIC_MODULES = [
    "paddle_tpu_torch",
    "paddle_tpu_torch.layers",
    "paddle_tpu_torch.layers.control_flow",
    "paddle_tpu_torch.layers.sequence",
    "paddle_tpu_torch.layers.io",
    "paddle_tpu_torch.layers.detection",
    "paddle_tpu_torch.layers.learning_rate_scheduler",
    "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.initializer",
    "paddle_tpu_torch.regularizer",
    "paddle_tpu_torch.clip",
    "paddle_tpu_torch.metrics",
    "paddle_tpu_torch.average",
    "paddle_tpu_torch.evaluator",
    "paddle_tpu_torch.io",
    "paddle_tpu_torch.profiler",
    "paddle_tpu_torch.trainer",
    "paddle_tpu_torch.inferencer",
    "paddle_tpu_torch.serving",
    "paddle_tpu_torch.serving.kv_pager",
    "paddle_tpu_torch.serving.sanitizer",
    "paddle_tpu_torch.serving_engine",
    "paddle_tpu_torch.nets",
    "paddle_tpu_torch.concurrency",
    "paddle_tpu_torch.transpiler",
    "paddle_tpu_torch.distributed",
    "paddle_tpu_torch.framework.analysis",
    "paddle_tpu_torch.framework.auto_parallel",
    "paddle_tpu_torch.framework.costs",
    "paddle_tpu_torch.framework.dataflow",
    "paddle_tpu_torch.framework.memory_plan",
    "paddle_tpu_torch.framework.ownership",
    "paddle_tpu_torch.framework.sharding",
    "paddle_tpu_torch.observability",
    "paddle_tpu_torch.observability.tracing",
    "paddle_tpu_torch.observability.metrics",
    "paddle_tpu_torch.observability.ledger",
    "paddle_tpu_torch.observability.flight_recorder",
    "paddle_tpu_torch.observability.memory",
    "paddle_tpu_torch.parallel",
    "paddle_tpu_torch.parallel.collective",
    "paddle_tpu_torch.parallel.elastic",
    "paddle_tpu_torch.parallel.grad_comm",
    "paddle_tpu_torch.parallel.pipeline",
    "paddle_tpu_torch.parallel.process_world",
    "paddle_tpu_torch.parallel.reshard",
    "paddle_tpu_torch.data",
    "paddle_tpu_torch.fusion",
]

# API.spec names the port spells with CUDA where the JAX package says TPU
RENAMED = {"TPUPlace": "CUDAPlace",
           "is_compiled_with_tpu": "is_compiled_with_cuda"}
# deliberately not ported: the dataset downloader and its md5 cache (the
# port needs no network; data/common.py keeps tokenize and build_word_dict)
EXCLUDED = {"paddle_tpu.data.download", "paddle_tpu.data.md5file"}

_ADDR = re.compile(r" at 0x[0-9a-fA-F]+")
_OWN = "paddle_tpu_torch"
_PLUMBING = ("paddle_tpu_torch.core.enforce", "paddle_tpu_torch.core.dtypes",
             "paddle_tpu_torch.core.unique_name")


def _sig(obj) -> str:
    try:
        s = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    # default values repr'ing with memory addresses are not stable
    return _ADDR.sub("", s)


def iter_api():
    for modname in PUBLIC_MODULES:
        mod = importlib.import_module(modname)
        names = getattr(mod, "__all__", None) or [
            n for n in vars(mod) if not n.startswith("_")]
        for name in sorted(set(names)):
            obj = getattr(mod, name, None)
            if obj is None or inspect.ismodule(obj):
                continue
            # only symbols defined inside the package
            owner = getattr(obj, "__module__", "") or ""
            if owner != _OWN and not owner.startswith(_OWN + "."):
                continue
            # internal plumbing re-exported by accident is not public API
            if owner in _PLUMBING:
                continue
            if inspect.isclass(obj):
                yield f"{modname}.{name}{_sig(obj.__init__)}"
                for m_name, m in sorted(vars(obj).items()):
                    if m_name.startswith("_") or not callable(m):
                        continue
                    yield f"{modname}.{name}.{m_name}{_sig(m)}"
            elif callable(obj):
                yield f"{modname}.{name}{_sig(obj)}"


def _path(line: str) -> str:
    return line.split("(")[0].split()[0]


def _port_path(spec_path: str) -> str:
    """An `API.spec` path as the port spells it."""
    parts = spec_path.split(".")
    return ".".join([_OWN] + [RENAMED.get(p, p) for p in parts[1:]])


def _tail(line: str) -> str:
    """The signature after the path, with the port's package name read as
    the JAX package's (a class in an annotation or a default names its
    module)."""
    return line[len(_path(line)):].replace(_OWN + ".", "paddle_tpu.")


def _paths(*names: str, under=("paddle_tpu",)) -> List[str]:
    return [f"{m}.{n}" for m in under for n in names]


_EXE_MODULES = ("paddle_tpu", "paddle_tpu.io", "paddle_tpu.trainer",
                "paddle_tpu.inferencer")
_MESH_MODULES = ("paddle_tpu.parallel", "paddle_tpu.parallel.collective",
                 "paddle_tpu.parallel.pipeline")
_ENGINE_MODULES = ("paddle_tpu.serving", "paddle_tpu.serving.kv_pager",
                   "paddle_tpu.serving_engine")
_UNARY = ("abs", "ceil", "cos", "exp", "floor", "gelu", "log", "logsigmoid",
          "reciprocal", "relu", "relu6", "round", "rsqrt", "sigmoid", "sign",
          "silu", "sin", "softplus", "softsign", "sqrt", "square", "tanh",
          "tanh_shrink")

# (reason, API paths as API.spec spells them)
_REASONS = [
    ("takes `place=`: the port's entry points run on CUDAPlace(0) unless "
     "the caller asks for the CPU",
     _paths("Predictor.from_exported", "load_inference_model", "load_params",
            "load_persistables", "load_vars")
     + _paths("load_inference_model", "load_params", "load_persistables",
              "load_vars", "load_exported_model", under=("paddle_tpu.io",))
     + ["paddle_tpu.inferencer.Predictor.from_exported",
        "paddle_tpu.inferencer.ExportedPredictor",
        "paddle_tpu.layers.io.PyReader", "paddle_tpu.layers.io.py_reader"]
     + _paths("ContinuousBatchingEngine", "PagedKVEngine",
              under=_ENGINE_MODULES)),
    ("`place=` for jax's `device=`, and no `sharding=`: a batch is split "
     "over a mesh by ParallelExecutor, not by the prefetcher",
     ["paddle_tpu.data.DevicePrefetcher"]),
    ("returns torch devices, not jax devices", ["paddle_tpu.devices"]),
    ("joins a torch.distributed world: `place` picks NCCL (a card) or gloo "
     "(the CPU), `store_path` a file store for a world of local processes "
     "(distributed.launch)",
     ["paddle_tpu.distributed.init_parallel_env"]),
    ("None reads the H100's constants from framework/costs.py; the JAX "
     "defaults are TPU v5e numbers",
     ["paddle_tpu.framework.auto_parallel.plan",
      "paddle_tpu.framework.costs.mfu",
      "paddle_tpu.framework.costs.predicted_step_seconds"]),
    ("the default dtype is torch.float32 for jnp.float32",
     ["paddle_tpu.fusion.dequantize_kv_time_blocks"]),
    ("takes the step's `fetch_list`: the census runs one step on copies of "
     "the state and reads torch's allocator (no compiled executable to "
     "read a memory analysis from)",
     _paths("Executor.memory_census", under=_EXE_MODULES)
     + ["paddle_tpu.observability.memory.device_memory_census"]),
    ("measures one step's allocator peak (executor, program, feed, "
     "fetch_list, scope): there is no AOT executable to read XLA's memory "
     "analysis from",
     ["paddle_tpu.observability.memory.executable_memory"]),
    ("counts the tensors on a device (the executor's, or `device`), where "
     "jax lists its live arrays",
     ["paddle_tpu.observability.memory.live_array_census"]),
    ("the return annotation is written unquoted; the parameters are the "
     "same", _paths("Executor.prepare", under=_EXE_MODULES)),
    ("`platforms` defaults to None: one torch.export archive for the "
     "device the scope's state lives on, not ('cpu', 'tpu'); returns the "
     "archives written", ["paddle_tpu.io.export_inference_model"]),
    ("annotated return (the archive paths written); the same parameters",
     ["paddle_tpu.io.export_train_program"]),
    ("the unary layers share one builder that passes `**kwargs` on as op "
     "attributes; the named parameters are the JAX package's",
     _paths(*_UNARY, under=("paddle_tpu.layers",))),
    ("`input` unannotated; the same names and defaults",
     ["paddle_tpu.layers.concat", "paddle_tpu.layers.sums"]),
    ("a mesh over torch.distributed ranks (one process a card), not over "
     "jax devices: `ranks` for `devices`",
     _paths("DeviceMesh", under=_MESH_MODULES)
     + ["paddle_tpu.parallel.make_mesh"]),
    ("returns the port's `Placement` (a mesh axis, or None, per dim) for "
     "jax's NamedSharding / PartitionSpec",
     _paths("DeviceMesh.batch_sharding", "DeviceMesh.pspec",
            "DeviceMesh.replicated", "DeviceMesh.sharding",
            under=_MESH_MODULES)
     + ["paddle_tpu.parallel.ParallelExecutor.state_sharding"]),
    ("`use_cuda` for `use_tpu` (fluid's own keyword)",
     ["paddle_tpu.parallel.ParallelExecutor"]),
    ("enum.Enum's inherited __init__, which API.spec's Python printed as "
     "(self, /, *args, **kwargs); the members are the JAX package's",
     ["paddle_tpu.parallel.ReduceStrategy",
      "paddle_tpu.parallel.grad_comm.ReduceStrategy"]),
    ("returns this rank's index along the axis as a host int (a process a "
     "card), where jax returns a traced value",
     ["paddle_tpu.parallel.collective.axis_index",
      "paddle_tpu.parallel.grad_comm.current_dp_index",
      "paddle_tpu.parallel.pipeline.current_pp_index"]),
    ("`mesh` annotated as the port's DeviceMesh; the same parameters",
     ["paddle_tpu.parallel.collective.shard_map",
      "paddle_tpu.parallel.pipeline.shard_map"]),
    ("the torch lowering context: a device, an int seed and a torch "
     "generator for jax's rng key, with the plan's constants, fetch names "
     "and remat / export state",
     ["paddle_tpu.parallel.pipeline.LowerCtx"]),
    ("returns an int seed for torch's generator, not a jax PRNG key",
     ["paddle_tpu.parallel.pipeline.LowerCtx.next_key"]),
    ("the region runs the staged ops its attrs hold; the JAX version takes "
     "the segment indices and block of its trace",
     ["paddle_tpu.parallel.pipeline.run_pp_region"]),
    ("records the bytes each rank reads (`rank_reads`), which a restore "
     "reports", ["paddle_tpu.parallel.reshard.VariablePlan"]),
]

#: API path (as `API.spec` spells it) -> why the port's signature differs
SIGNATURE_DIFFERENCES: Dict[str, str] = {
    path: reason for reason, paths in _REASONS for path in paths}


def spec_lines() -> List[str]:
    with open(API_SPEC) as f:
        return [ln.rstrip("\n") for ln in f if ln.strip()]


def differences() -> Dict[str, tuple]:
    """`API.spec` path -> (its line, the port's line or None) for every
    path outside `EXCLUDED` whose port signature is not the same."""
    port = {_path(ln): ln for ln in iter_api()}
    out = {}
    for line in spec_lines():
        path = _path(line)
        if path in EXCLUDED:
            continue
        mine = port.get(_port_path(path))
        if mine is None or _tail(mine) != _tail(line):
            out[path] = (line, mine)
    return out


def check() -> int:
    diffs = differences()
    unnamed = sorted(p for p in diffs if p not in SIGNATURE_DIFFERENCES)
    stale = sorted(p for p in SIGNATURE_DIFFERENCES if p not in diffs)
    for p in unnamed:
        line, mine = diffs[p]
        print(f"UNNAMED  {line}\n    port {mine}")
    for p in stale:
        print(f"STALE    {p}: named a difference, but the signatures are "
              f"the same")
    n = len(spec_lines())
    print(f"print_signatures: {n} API.spec lines, {len(EXCLUDED)} "
          f"excluded, {len(diffs)} differ ({len(diffs) - len(unnamed)} "
          f"named), {len(unnamed)} unnamed, {len(stale)} stale")
    return 1 if unnamed or stale else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--check", action="store_true",
                   help="hold the port's surface against API.spec; exit 1 "
                        "on a difference SIGNATURE_DIFFERENCES does not "
                        "name")
    args = p.parse_args(argv)
    if args.check:
        return check()
    print("\n".join(sorted(set(iter_api()))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
