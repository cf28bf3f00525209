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

Not ported (ROADMAP.md §1 item 4, export and native): the StableHLO
exports `export_inference_model`, `load_exported_model` and
`export_train_program` (their counterpart is `torch.export`), the native
`.pts` tensor container, and sharded checkpoints.
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
_NATIVE = ("the native .pts tensor container is not ported: ROADMAP.md §1 "
           "item 4 (export and native)")
_SHARDED = ("sharded checkpoints are not ported: ROADMAP.md §1 item 4 "
            "(multi-GPU parallelism, sharded_checkpoint.py)")


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


def save_vars(executor: Optional[Executor], dirname: str,
              main_program: Optional[Program] = None,
              vars: Optional[Sequence[Variable]] = None,
              predicate=None, filename: Optional[str] = None,
              scope: Optional[Scope] = None,
              save_as_bf16: bool = False):
    """≙ fluid.io.save_vars (reference io.py:89). Values come from the
    scope, each copied to the host once. Returns the saved names."""
    program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        enforce(predicate is not None, "need vars or predicate",
                exc=InvalidArgumentError)
        vars = _select_vars(program, predicate)
    if filename is not None and filename.endswith(".pts"):
        raise NotImplementedError(_NATIVE)
    os.makedirs(dirname, exist_ok=True)
    stored: Dict[str, np.ndarray] = {}
    for v in vars:
        if not scope.has_var(v.name):
            raise NotFoundError(
                f"variable {v.name!r} not found in scope — run the startup "
                f"program before saving")
        key, arr = _to_store(v.name, scope.get(v.name), save_as_bf16)
        stored[key] = arr
    if filename is None:
        for key, arr in stored.items():
            np.save(os.path.join(dirname, key + ".npy"), arr)
    else:
        np.savez(os.path.join(dirname, filename), **stored)
    return sorted(v.name for v in vars)


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
    if filename is not None and filename.endswith(".pts"):
        raise NotImplementedError(_NATIVE)
    store = None
    if filename is not None:
        with np.load(os.path.join(dirname, filename)) as data:
            store = {k: data[k] for k in data.files}
    loaded = []
    for v in vars:
        if store is not None:
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
    optimizer state and step counters: everything needed to resume."""
    if sharded:
        raise NotImplementedError(_SHARDED)
    return save_vars(executor, dirname, main_program=main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, save_as_bf16=save_as_bf16)


def load_persistables(executor=None, dirname: str = "", main_program=None,
                      filename=None, scope=None, sharded: bool = False,
                      place=None):
    if sharded:
        raise NotImplementedError(_SHARDED)
    return load_vars(executor, dirname, main_program=main_program,
                     predicate=_is_persistable, filename=filename,
                     scope=scope, place=place)


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
