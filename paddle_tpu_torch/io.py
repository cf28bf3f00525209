"""Model persistence: save/load variables, parameters, persistables,
inference models and training programs.

≙ paddle_tpu/io.py (reference python/paddle/fluid/io.py: save/load_vars:89,
save/load_params, save/load_persistables:252,464, save_inference_model:561,
load_inference_model:677), in the JAX package's on-disk format, so a
directory either package writes loads in the other:

- one `<name>.npy` per variable (≙ save_op), or every variable in one
  `.npz` (≙ save_combine; the inference model's `__params__.npz`);
- bfloat16 values as their uint16 bit patterns under `<name>@BF16` (numpy
  has no bfloat16); `save_as_bf16` stores float32 values so, and loading
  converts each value to its variable's declared dtype;
- programs as the JSON of `Program.to_json` (`__model__` with the feed and
  fetch names, `__train_program__` with the startup program).

Loaded values land in the scope as tensors on the executor's device (or on
`place`; the default place is CUDAPlace(0), which raises without a card).
`load_numpy_params` carries a dict of numpy arrays across the same way.

A `filename` ending in `.pts` goes through the native tensor container
(data/tensor_store.py, the JAX package's format), and
`save_persistables(sharded=True)` / `load_persistables(sharded=True)`
through sharded_checkpoint.py.

Export (≙ the JAX package's StableHLO exports): `export_inference_model`
writes the inference function as a `torch.export` archive per device,
`load_exported_model` loads it cold, and `export_train_program` writes one
train step; the native programs in csrc/native/ (`native.py` builds them)
run both without Python.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .core.dtypes import convert_dtype
from .core.enforce import InvalidArgumentError, NotFoundError, enforce
from .core.places import Place, resolve_device
from .framework.executor import Executor, as_numpy  # noqa: F401
from .framework.program import (Parameter, Program, Variable,
                                default_main_program, default_startup_program)
from .framework.scope import Scope, global_scope

INFERENCE_PROGRAM_FILE = "__model__"
PARAMS_COMBINED_FILE = "__params__.npz"
TRAIN_PROGRAM_FILE = "__train_program__"
BF16_TAG = "@BF16"

def _is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _is_persistable(var: Variable) -> bool:
    return bool(var.persistable)


def _select_vars(program: Program, predicate) -> List[Variable]:
    out, seen = [], set()
    for b in program.blocks:
        for v in b.vars.values():
            if v.name not in seen and predicate(v):
                seen.add(v.name)
                out.append(v)
    return sorted(out, key=lambda v: v.name)


def _to_store(name: str, t: torch.Tensor, save_as_bf16: bool):
    """(stored name, numpy array) for one value: bfloat16 (a bfloat16
    tensor, or float32 under save_as_bf16) as its uint16 bits under the
    tagged name."""
    t = t.detach()
    if save_as_bf16 and t.dtype == torch.float32:
        t = t.to(torch.bfloat16)
    if t.dtype == torch.bfloat16:
        return name + BF16_TAG, t.cpu().view(torch.int16).numpy().view(
            np.uint16)
    return name, t.cpu().numpy()


def _from_store(name: str, store) -> torch.Tensor:
    """The value stored under `name` (or its bfloat16-tagged name) in a
    name -> array mapping, as a CPU tensor."""
    if name in store:
        return torch.from_numpy(np.array(store[name]))
    tagged = name + BF16_TAG
    if tagged in store:
        bits = np.array(store[tagged]).view(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16)
    raise NotFoundError(f"{name!r} missing from saved store")


def _device(executor: Optional[Executor], place: Optional[Place]):
    return executor.device if executor is not None else resolve_device(place)


def _global_value(scope: Scope, name: str):
    """The global value of var `name`: where a ParallelExecutor split it
    in `scope` (ZeRO-1 accumulators, tp blocks, error-feedback
    residuals), this rank's block gathered over the placement's axes —
    a collective every rank of the executor's mesh calls."""
    from .parallel.parallel_executor import gather_global, split_state
    value = scope.get(name)
    entry = split_state(scope).get(name)
    if (entry is not None and isinstance(value, torch.Tensor)
            and tuple(value.shape) != entry[2]):
        mesh, placement, _ = entry
        value = gather_global(value, mesh, placement)
    return value


def _writes(scope: Scope) -> bool:
    """Does this process write a save of `scope`? In a world where a
    ParallelExecutor split the scope, the first rank of its mesh alone
    (every rank gathered the same global values); else every caller."""
    from .parallel.parallel_executor import split_state
    reg = split_state(scope)
    if not reg:
        return True
    mesh = next(iter(reg.values()))[0]
    return not mesh.joined or mesh.rank == mesh.ranks[0]


def save_vars(executor: Optional[Executor], dirname: str,
              main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None,
              scope: Optional[Scope] = None,
              save_as_bf16: bool = False):
    """≙ fluid.io.save_vars (reference io.py:89). Values come from the
    scope, each copied to the host once; a var a ParallelExecutor split
    is saved whole (its blocks gathered: every rank of the executor's
    mesh calls this, and its first rank writes). A `filename` ending in
    `.pts` writes the native tensor container (data/tensor_store.py),
    bfloat16 in its own dtype code. Returns the saved names."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        enforce(predicate is not None, "need vars or predicate",
                exc=InvalidArgumentError)
        vars = _select_vars(program, predicate)
    from .framework.offload import restore_offloaded
    restore_offloaded(scope)
    values: Dict[str, torch.Tensor] = {}
    for v in vars:
        if not scope.has_var(v.name):
            raise NotFoundError(
                f"variable {v.name!r} not found in scope — run the startup "
                f"program before saving")
        values[v.name] = _global_value(scope, v.name)
    if not _writes(scope):
        return sorted(values)
    os.makedirs(dirname, exist_ok=True)
    if filename is not None and filename.endswith(".pts"):
        # the native container (≙ save_combine_op.cc): streamed,
        # CRC-checked, O(1) name lookup
        from .data.tensor_store import save_tensors
        save_tensors(os.path.join(dirname, filename), {
            n: (t.detach().to(torch.bfloat16)
                if save_as_bf16 and t.dtype == torch.float32 else t)
            for n, t in values.items()})
        return sorted(values)
    stored: Dict[str, np.ndarray] = {}
    for name, t in values.items():
        key, arr = _to_store(name, t, save_as_bf16)
        stored[key] = arr
    if filename is None:
        for key, arr in stored.items():
            np.save(os.path.join(dirname, key + ".npy"), arr)
    else:
        np.savez(os.path.join(dirname, filename), **stored)
    return sorted(values)


def load_vars(executor: Optional[Executor], dirname: str,
              main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None,
              scope: Optional[Scope] = None, place: Optional[Place] = None):
    """≙ fluid.io.load_vars (reference io.py:317). Each value is checked
    against its variable's shape, converted to its declared dtype and set
    in the scope on the executor's device (or `place`). Returns the loaded
    names."""
    from .framework.offload import restore_offloaded
    program = main_program or default_main_program()
    scope = scope or global_scope()
    restore_offloaded(scope)
    device = _device(executor, place)
    if vars is None:
        enforce(predicate is not None, "need vars or predicate",
                exc=InvalidArgumentError)
        vars = _select_vars(program, predicate)
    store = native = None
    if filename is not None and filename.endswith(".pts"):
        from .data.tensor_store import load_tensors
        native = load_tensors(os.path.join(dirname, filename),
                              [v.name for v in vars])
    elif filename is not None:
        with np.load(os.path.join(dirname, filename)) as data:
            store = {k: data[k] for k in data.files}
    loaded = []
    for v in vars:
        if native is not None:
            t = native[v.name]
        elif store is not None:
            t = _from_store(v.name, store)
        else:
            path = os.path.join(dirname, v.name + ".npy")
            tagged = os.path.join(dirname, v.name + BF16_TAG + ".npy")
            if os.path.exists(path):
                t = _from_store(v.name, {v.name: np.load(path)})
            elif os.path.exists(tagged):
                t = _from_store(v.name, {v.name + BF16_TAG: np.load(tagged)})
            else:
                raise NotFoundError(f"{path} does not exist")
        if v.shape is not None and -1 not in v.shape:
            enforce(tuple(t.shape) == tuple(v.shape),
                    f"shape mismatch loading {v.name!r}: file "
                    f"{tuple(t.shape)} vs var {tuple(v.shape)}",
                    exc=InvalidArgumentError)
        scope.set_var(v.name, t.to(device=device,
                                   dtype=convert_dtype(v.dtype)))
        loaded.append(v.name)
    return sorted(loaded)


def save_params(executor=None, dirname: str = "", main_program=None,
                filename=None, scope=None, save_as_bf16=False):
    """≙ fluid.io.save_params — trainable parameters only."""
    return save_vars(executor, dirname, main_program=main_program,
                     predicate=_is_parameter, filename=filename, scope=scope,
                     save_as_bf16=save_as_bf16)


def load_params(executor=None, dirname: str = "", main_program=None,
                filename=None, scope=None, place=None):
    return load_vars(executor, dirname, main_program=main_program,
                     predicate=_is_parameter, filename=filename, scope=scope,
                     place=place)


def save_persistables(executor=None, dirname: str = "", main_program=None,
                      filename=None, scope=None, save_as_bf16=False,
                      sharded: bool = False):
    """≙ fluid.io.save_persistables (reference io.py:252) — parameters AND
    optimizer state and step counters: everything needed to resume.

    sharded=True: each process writes only its own blocks plus a manifest
    (sharded_checkpoint.save_sharded): in a world where a
    ParallelExecutor split the scope, ZeRO-1 / tp state is written
    without a gather, and a load can cut it onto another mesh."""
    if sharded:
        enforce(filename is None and not save_as_bf16,
                "sharded=True does not combine with filename/save_as_bf16 "
                "(shards go to per-process .pts containers in the native "
                "dtypes of the tensors)", exc=InvalidArgumentError)
        return _save_sharded(dirname, main_program, scope)
    return save_vars(executor, dirname, main_program=main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, save_as_bf16=save_as_bf16)


def load_persistables(executor=None, dirname: str = "", main_program=None,
                      filename=None, scope=None, sharded: bool = False,
                      place=None):
    if sharded:
        enforce(filename is None, "sharded=True does not combine with "
                "filename", exc=InvalidArgumentError)
        return _load_sharded(executor, dirname, main_program, scope, place)
    return load_vars(executor, dirname, main_program=main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, place=place)


def _save_sharded(dirname, main_program, scope):
    from .parallel.parallel_executor import split_state
    from .sharded_checkpoint import save_sharded
    from .framework.offload import restore_offloaded
    program = main_program or default_main_program()
    scope = scope or global_scope()
    restore_offloaded(scope)
    arrays = {}
    for v in _select_vars(program, _is_persistable):
        if not scope.has_var(v.name):
            raise NotFoundError(
                f"variable {v.name!r} not found in scope — run the "
                f"startup program before saving")
        arrays[v.name] = scope.get(v.name)
    reg = split_state(scope)
    mesh = next(iter(reg.values()))[0] if reg else None
    if mesh is None or not mesh.joined:
        save_sharded(dirname, arrays)
        return sorted(arrays)
    shapes = {n: tuple(reg[n][2]) if n in reg else tuple(
        arrays[n].shape) for n in arrays}
    save_sharded(dirname, arrays, process_index=mesh.ranks.index(mesh.rank),
                 world_size=mesh.num_devices, mesh=mesh,
                 placements={n: e[1] for n, e in reg.items()},
                 shapes=shapes)
    return sorted(arrays)


def _load_sharded(executor, dirname, main_program, scope, place):
    """Each var's block for this rank: where a ParallelExecutor split the
    scope, under its placement (only the intersecting chunks are read);
    else whole. Converted to the declared dtype on the executor's
    device."""
    from .parallel.parallel_executor import split_state
    from .sharded_checkpoint import ShardedCheckpoint, restore_array
    from .framework.offload import restore_offloaded
    program = main_program or default_main_program()
    scope = scope or global_scope()
    restore_offloaded(scope)
    device = _device(executor, place)
    reg = split_state(scope)
    ckpt = ShardedCheckpoint(dirname)
    loaded = []
    try:
        for v in _select_vars(program, _is_persistable):
            mesh, placement, _ = reg.get(v.name, (None, None, None))
            t = restore_array(ckpt, v.name, placement, mesh)
            scope.set_var(v.name, t.to(device=device,
                                       dtype=convert_dtype(v.dtype)))
            loaded.append(v.name)
    finally:
        ckpt.close()
    return sorted(loaded)


def save_inference_model(dirname: str,
                         feeded_var_names: Sequence[str],
                         target_vars: Sequence[Variable],
                         executor: Optional[Executor] = None,
                         main_program: Optional[Program] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None,
                         save_as_bf16: bool = False,
                         export: bool = False,
                         native: bool = False):
    """≙ fluid.io.save_inference_model (reference io.py:561): prune the
    program to the fetch targets, switch it to test mode, and write the
    program's JSON with the feed and fetch names, and its persistables.
    `export=True` also writes the torch.export archive
    (`export_inference_model`), `native=True` that and the native
    programs' meta."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    target_names = [t.name if isinstance(t, Variable) else t
                    for t in target_vars]
    inference_program = program.clone(for_test=True).prune(target_names)
    blk = inference_program.global_block()
    for name in feeded_var_names:
        enforce(blk.has_var(name),
                f"feeded var {name!r} not present in pruned program "
                f"(not on the path to targets?)", exc=InvalidArgumentError)
    os.makedirs(dirname, exist_ok=True)
    meta = {"program": json.loads(inference_program.to_json()),
            "feed_names": list(feeded_var_names),
            "fetch_names": target_names}
    with open(os.path.join(dirname, model_filename or
                           INFERENCE_PROGRAM_FILE), "w") as f:
        json.dump(meta, f)
    save_vars(executor, dirname, main_program=inference_program,
              vars=_select_vars(inference_program, _is_persistable),
              filename=params_filename or PARAMS_COMBINED_FILE, scope=scope,
              save_as_bf16=save_as_bf16)
    if export or native:
        export_inference_model(
            dirname, feeded_var_names, target_names, inference_program,
            scope=scope, native=native,
            platforms=None if executor is None else [executor.device.type])
    return target_names


def load_inference_model(dirname: str,
                         executor: Optional[Executor] = None,
                         model_filename: Optional[str] = None,
                         params_filename: Optional[str] = None,
                         scope: Optional[Scope] = None,
                         place: Optional[Place] = None):
    """≙ fluid.io.load_inference_model (reference io.py:677). Returns
    (program, feed_names, fetch_names); the parameters are loaded into the
    scope."""
    scope = scope or global_scope()
    path = os.path.join(dirname, model_filename or INFERENCE_PROGRAM_FILE)
    if not os.path.exists(path):
        raise NotFoundError(f"no inference model at {path}")
    with open(path) as f:
        meta = json.load(f)
    program = Program.from_json(json.dumps(meta["program"]))
    load_vars(executor, dirname, main_program=program,
              vars=_select_vars(program, _is_persistable),
              filename=params_filename or PARAMS_COMBINED_FILE, scope=scope,
              place=place)
    return program, list(meta["feed_names"]), list(meta["fetch_names"])


EXPORTED_ARTIFACT_FILE = "__exported__.pt2"
EXPORTED_META_FILE = "__exported__.json"
NATIVE_META_FILE = "__exported_native__.meta"
NATIVE_TRAIN_ARTIFACT_FILE = "__exported_train__.pt2"
NATIVE_TRAIN_META_FILE = "__exported_train__.meta"

#: the JAX package's platform names -> the device type each is traced on
_PLATFORMS = {"cpu": "cpu", "tpu": "cuda", "gpu": "cuda", "cuda": "cuda"}


def _platform_devices(platforms, scope, names):
    """[(platform, device)] to trace on: each platform named (JAX names
    mapped: "tpu" -> "cuda"), or else the device the scope's state lives
    on."""
    if platforms is None:
        dev = next((scope.get(n).device for n in names
                    if isinstance(scope.get(n), torch.Tensor)), None)
        platforms = [dev.type if dev is not None else "cuda"]
    out = []
    for p in platforms:
        kind = _PLATFORMS.get(str(p).lower())
        enforce(kind is not None, f"unknown export platform {p!r}; known: "
                f"{sorted(_PLATFORMS)}", exc=InvalidArgumentError)
        if kind not in [k for k, _ in out]:
            out.append((kind, resolve_device(Place(kind, 0))))
    return out


def _archive_file(base: str, platform: str, first: bool) -> str:
    """The archive of one platform: `base` for the first platform named,
    `<stem>.<platform>.pt2` for the others."""
    return base if first else base.replace(".pt2", f".{platform}.pt2")


def _tf32():
    return (int(torch.backends.cuda.matmul.allow_tf32),
            int(torch.backends.cudnn.allow_tf32))


#: the batch an export traces at: 2 or more, so that the tracer's 0/1
#: specialisation does not pin the symbolic batch
_TRACE_BATCH = 2


def _feed_samples(block, feed_names, device):
    """Example feeds (zeros: the exporter traces them as fake tensors)
    and their dynamic shapes: every feed's leading -1 is ONE shared batch
    Dim (the JAX package's feed contract, paddle_tpu/io.py:341-351), each
    other -1 a Dim of its own."""
    batch = _TRACE_BATCH
    bdim = torch.export.Dim("b", min=1)
    samples, specs = [], []
    for i, name in enumerate(feed_names):
        v = block.var(name)
        shape, spec = [], {}
        for j, d in enumerate(v.shape):
            if d == -1:
                spec[j] = bdim if j == 0 else torch.export.Dim(
                    f"d{i}_{j}", min=1)
                shape.append(batch if j == 0 else batch + 1)
            else:
                shape.append(d)
        samples.append(torch.zeros(shape, dtype=convert_dtype(v.dtype),
                                   device=device))
        specs.append(spec or None)
    return samples, specs


class _Traced(torch.nn.Module):
    """`fn(feeds, state)` as a module: the state as buffers (the exported
    program's weights), the feeds as its inputs."""

    def __init__(self, fn, state):
        super().__init__()
        self._fn = fn
        self._n = len(state)
        for i, t in enumerate(state):
            self.register_buffer(f"s{i}", t)

    def forward(self, *feeds):
        return self._fn(feeds, [getattr(self, f"s{i}")
                                for i in range(self._n)])


def _plan_fn(plan, device, fetch_names, is_test, exporting=False):
    """The plan's run over (feeds, ro + rw state) -> the named values,
    with a LowerCtx of its own (no memo shared with eager runs: a tensor
    made while tracing must not outlive the trace)."""
    from .framework.lowering import run_plan
    from .framework.registry import LowerCtx
    state_names = list(plan.ro_names) + list(plan.rw_names)

    def fn(feeds, state):
        ctx = LowerCtx(device=device, constants={},
                       fetch_names=tuple(plan.fetch_names),
                       read_names=plan.read_names, is_test=is_test,
                       exporting=exporting,
                       extras={"program": plan.program})
        env: Dict[str, object] = dict(zip(state_names, state))
        env.update(zip(plan.feed_names, feeds))
        run_plan(plan.ops, env, ctx, plan.release)
        return tuple(env[n] for n in fetch_names)
    return fn


def _meta_line(kind, name, t, spec=None) -> str:
    """An `in` / `out` line of the JAX meta format: name, dtype and dims,
    -1 for a symbolic one (`spec`'s dims, or a SymInt). bfloat16 values
    travel as their uint16 bit patterns in .npy files (as `_to_store`
    writes them); the programs hand bfloat16 outputs back as float32."""
    from .core.dtypes import dtype_name
    dims = " ".join("-1" if (spec and j in spec) or not isinstance(d, int)
                    else str(d) for j, d in enumerate(t.shape))
    return f"{kind} {name} {dtype_name(t.dtype)} {dims}".rstrip()


def _output_vals(ep):
    out = next(n for n in ep.graph.nodes if n.op == "output")
    return [a.meta["val"] for a in out.args[0]]


def _schema_version() -> str:
    from torch._export.serde.schema import SCHEMA_VERSION
    return f"{SCHEMA_VERSION[0]}.{SCHEMA_VERSION[1]}"


def export_inference_model(dirname: str,
                           feeded_var_names: Sequence[str],
                           target_names: Sequence[str],
                           inference_program: Program,
                           scope: Optional[Scope] = None,
                           platforms: Optional[Sequence[str]] = None,
                           native: bool = False) -> Dict[str, object]:
    """Write the pruned inference function as a `torch.export` archive
    next to the JSON program (≙ paddle_tpu/io.py:323, whose artifact is
    serialized StableHLO): parameters baked in as the program's weights,
    loadable COLD by `load_exported_model` / `Predictor.from_exported` and
    by the native `ptpu_predict` (csrc/native/) with no program, no op
    registry and no tracer.

    The plan is the one `Executor.run` builds (the fusion passes, so the
    hand-written kernels K1-K6 appear as their `ptpu::` ops on a CUDA
    trace), run in test mode. Feed contract as the JAX package's: every
    feed's leading -1 is one shared symbolic batch, so one archive serves
    any batch; other -1 dims are symbolic each on their own.

    A torch.export graph fixes its device, so each platform named
    ("cpu", and "cuda" or the JAX package's "tpu") is traced on its own
    device into its own archive: `__exported__.pt2` for the first, then
    `__exported__.<platform>.pt2`; the default is the device the scope's
    state lives on (save_inference_model passes its executor's). `__exported__.json` holds `feed_names`, `fetch_names`,
    `platforms` and each platform's archive. `native=True` also writes
    `__exported_native__.meta` (the JAX line format: version, nin / in,
    nout / out, plus each archive and the TF32 settings the export ran
    under), which `ptpu_predict` checks feeds against.

    Returns {"seconds", "nodes"} of the last platform's export."""
    import time
    from .framework.executor import Executor
    from .core.places import CPUPlace, CUDAPlace

    scope = scope or global_scope()
    feed_names = list(feeded_var_names)
    target_names = [t.name if isinstance(t, Variable) else t
                    for t in target_names]
    block = inference_program.global_block()
    state_names = sorted({n for b in inference_program.blocks
                          for op in b.ops for n in op.input_names()
                          if scope.has_var(n) and n not in feed_names})
    os.makedirs(dirname, exist_ok=True)
    archives, info, lines = {}, {}, []
    for i, (kind, device) in enumerate(_platform_devices(
            platforms, scope, state_names)):
        exe = Executor(CPUPlace() if kind == "cpu" else
                       CUDAPlace(device.index or 0))
        plan = exe._build_plan(inference_program, scope, feed_names,
                               target_names)
        state = [scope.get(n).detach().to(device)
                 for n in list(plan.ro_names) + list(plan.rw_names)]
        samples, specs = _feed_samples(block, feed_names, device)
        t0 = time.perf_counter()
        with torch.no_grad():
            ep = torch.export.export(
                _Traced(_plan_fn(plan, device, target_names, True), state),
                tuple(samples), dynamic_shapes=(tuple(specs),),
                strict=False)
        info = {"seconds": time.perf_counter() - t0,
                "nodes": len(ep.graph.nodes)}
        fname = _archive_file(EXPORTED_ARTIFACT_FILE, kind, i == 0)
        torch.export.save(ep, os.path.join(dirname, fname))
        archives[kind] = fname
        if not lines:
            lines = ([f"version {_schema_version()}",
                      f"nin {len(feed_names)}"]
                     + [_meta_line("in", n, t, spec) for n, t, spec in
                        zip(feed_names, samples, specs)]
                     + [f"nout {len(target_names)}"]
                     + [_meta_line("out", n, v) for n, v in
                        zip(target_names, _output_vals(ep))])
    with open(os.path.join(dirname, EXPORTED_META_FILE), "w") as f:
        json.dump({"feed_names": feed_names, "fetch_names": target_names,
                   "platforms": list(archives), "archives": archives}, f)
    if native:
        lines += [f"archive {k} {f}" for k, f in archives.items()]
        lines.append("tf32 %d %d" % _tf32())
        with open(os.path.join(dirname, NATIVE_META_FILE), "w") as f:
            f.write("\n".join(lines) + "\n")
    return info


def _register_kernel_ops():
    """The `ptpu::` ops a loaded archive may call, with their CUDA
    implementations (each kernel module registers its own on import)."""
    from . import kernel_ops  # noqa: F401
    from .fusion import decode_attention, recurrent  # noqa: F401
    from .ops import flash_attention  # noqa: F401


def load_exported_model(dirname: str, place: Optional[Place] = None):
    """Load the archive `export_inference_model` wrote for `place`'s
    device type (default CUDAPlace(0), which raises without a card).
    Returns (module, feed_names, fetch_names): `module(*feeds)` runs the
    exported graph on that device and returns the fetches, with no
    program, no registry and no tracer (≙ paddle_tpu/io.py:437)."""
    device = resolve_device(place)
    path = os.path.join(dirname, EXPORTED_META_FILE)
    if not os.path.exists(path):
        raise NotFoundError(f"no exported artifact at {path}")
    with open(path) as f:
        meta = json.load(f)
    fname = meta["archives"].get(device.type)
    if fname is None:
        raise NotFoundError(
            f"{dirname} holds no archive for {device.type} (exported for "
            f"{meta['platforms']}): a torch.export graph fixes its device")
    _register_kernel_ops()
    ep = torch.export.load(os.path.join(dirname, fname))
    return ep.module(), list(meta["feed_names"]), list(meta["fetch_names"])


def export_train_program(dirname: str,
                         feeded_var_names: Sequence[str],
                         loss_names: Sequence,
                         main_program: Optional[Program] = None,
                         scope: Optional[Scope] = None) -> List[str]:
    """Export ONE train step, `(feeds..., state...) -> (losses...,
    updated state...)`, as `__exported_train__.pt2` for the native
    `ptpu_train` (≙ paddle_tpu/io.py:456, whose unit is StableHLO).
    Parameters and optimizer accumulators are real inputs, so the runner
    carries the updated state across steps.

    The step is the plan `Executor.run` builds (`_analyze_state` gives
    state_in = ro + rw and state_out = rw | write-only, as the JAX
    exporter builds them), traced with `make_fx(tracing_mode="symbolic")`
    through the autograd region, then exported with the feeds' shared
    batch Dim. Its random draws come from the process's default generator
    (`LowerCtx.exporting`): the runner seeds it with the step's
    `__seed__`, which is the meta's first input but no graph input.

    `__exported_train__.meta`, in the JAX line format: version, nfetch,
    `in __seed__ int32`, an `in` line per feed and state input, an `out`
    line per loss and updated state, `carry <out> <in>` (feed the output
    back as that input next step), `init <in> train_state_<in>.npy` (each
    state input's starting value, written beside it), then the archive
    and the TF32 settings. Returns the loss names."""
    from torch.fx.experimental.proxy_tensor import make_fx
    from .framework.executor import Executor

    program = main_program or default_main_program()
    scope = scope or global_scope()
    feed_names = list(feeded_var_names)
    fetch_names = [f.name if isinstance(f, Variable) else f
                   for f in loss_names]
    (kind, device), = _platform_devices(None, scope,
                                        sorted(n for n in scope._vars))
    exe = Executor(Place(kind, device.index or 0))
    plan = exe._build_plan(program, scope, feed_names, fetch_names)
    state_in = list(plan.ro_names) + list(plan.rw_names)
    state_out = list(plan.state_out_names)
    state = [scope.get(n).detach().to(device) for n in state_in]
    samples, specs = _feed_samples(program.global_block(), feed_names,
                                   device)
    step = _plan_fn(plan, device, fetch_names + state_out, False,
                    exporting=True)
    nf = len(feed_names)
    with torch.no_grad():
        graph = make_fx(lambda *a: step(a[:nf], a[nf:]),
                        tracing_mode="symbolic")(*samples, *state)
    ep = torch.export.export(graph, tuple(samples + state),
                             dynamic_shapes=tuple(specs + [None] * len(
                                 state)), strict=False)
    os.makedirs(dirname, exist_ok=True)
    torch.export.save(ep, os.path.join(dirname, NATIVE_TRAIN_ARTIFACT_FILE))

    in_names = ["__seed__"] + feed_names + state_in
    lines = [f"version {_schema_version()}", f"nfetch {len(fetch_names)}",
             "in __seed__ int32"]
    lines += [_meta_line("in", n, t, spec) for n, t, spec in zip(
        feed_names + state_in, samples + state, specs + [None] * len(state))]
    lines += [_meta_line("out", n, v) for n, v in zip(
        fetch_names + state_out, _output_vals(ep))]
    for out_idx, name in enumerate(fetch_names + state_out):
        if name in state_out and name in plan.rw_names:
            lines.append(f"carry {out_idx} {in_names.index(name)}")
    for name, t in zip(state_in, state):
        idx = in_names.index(name)
        fname = f"train_state_{idx}.npy"
        np.save(os.path.join(dirname, fname), _stored_array(t))
        lines.append(f"init {idx} {fname}")
    lines.append(f"archive {kind} {NATIVE_TRAIN_ARTIFACT_FILE}")
    lines.append("tf32 %d %d" % _tf32())
    with open(os.path.join(dirname, NATIVE_TRAIN_META_FILE), "w") as f:
        f.write("\n".join(lines) + "\n")
    return fetch_names


def _stored_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def save_program(dirname: str,
                 main_program: Optional[Program] = None,
                 startup_program: Optional[Program] = None,
                 feed_names: Optional[Sequence[str]] = None,
                 fetch_names: Optional[Sequence] = None):
    """Serialize a training program pair (main + startup) so that a
    script without the model-building code can train it. Parameters are not saved: the
    startup program initializes them."""
    main_program = main_program or default_main_program()
    startup_program = startup_program or default_startup_program()
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "main_program": json.loads(main_program.to_json()),
        "startup_program": json.loads(startup_program.to_json()),
        "feed_names": list(feed_names or []),
        "fetch_names": [f.name if isinstance(f, Variable) else f
                        for f in (fetch_names or [])],
    }
    with open(os.path.join(dirname, TRAIN_PROGRAM_FILE), "w") as f:
        json.dump(meta, f)


def load_program(dirname: str):
    """Load a program pair saved by save_program. Returns
    (main_program, startup_program, feed_names, fetch_names)."""
    path = os.path.join(dirname, TRAIN_PROGRAM_FILE)
    if not os.path.exists(path):
        raise NotFoundError(f"no saved training program at {path}")
    with open(path) as f:
        meta = json.load(f)
    return (Program.from_json(json.dumps(meta["main_program"])),
            Program.from_json(json.dumps(meta["startup_program"])),
            meta["feed_names"], meta["fetch_names"])


def load_numpy_params(params: Dict[str, np.ndarray],
                      scope: Optional[Scope] = None,
                      place: Optional[Place] = None) -> Scope:
    """Set each `name -> numpy array` of `params` in `scope` (default: the
    global scope) as a tensor on `place` (default: CUDAPlace(0); raises
    without a card unless a place is given). float64 arrays load as
    float32, as the JAX package runs them. Returns the scope.

    The two packages build the same programs with the same `unique_name`
    sequence, so a parameter has the same name in both (tok_emb,
    l{i}_attn_{q,k,v,o}.w_0, ...): this carries a JAX scope's values
    across."""
    scope = scope if scope is not None else global_scope()
    device = resolve_device(place)
    for name, value in params.items():
        t = torch.from_numpy(np.array(value))      # a private copy
        if t.dtype == torch.float64:
            t = t.float()
        scope.set_var(name, t.to(device))
    return scope
