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

Not ported (ROADMAP.md §1 item 4, export and native): the StableHLO
exports `export_inference_model`, `load_exported_model` and
`export_train_program` (their counterpart is `torch.export`).
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

_EXPORT = ("StableHLO export is a JAX mechanism; its counterpart, "
           "torch.export, is not ported: ROADMAP.md §1 item 4 (export and "
           "native)")


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
    program = main_program or default_main_program()
    scope = scope or global_scope()
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
    program = main_program or default_main_program()
    scope = scope or global_scope()
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
    program = main_program or default_main_program()
    scope = scope or global_scope()
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
    program's JSON with the feed and fetch names, and its persistables."""
    if export or native:
        raise NotImplementedError(_EXPORT)
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


def export_inference_model(*args, **kwargs):
    raise NotImplementedError(_EXPORT)


def load_exported_model(*args, **kwargs):
    raise NotImplementedError(_EXPORT)


def export_train_program(*args, **kwargs):
    raise NotImplementedError(_EXPORT)


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
