"""≙ paddle_tpu/contrib/memory_usage_calc.py, line for line (dtypes by
name: the port's variables carry torch dtypes).

Estimate a program's device-memory footprint before running it.

≙ reference python/paddle/fluid/contrib/memory_usage_calc.py (memory_usage),
which sums var sizes to bracket GPU memory. TPU translation: the estimate
covers parameters + optimizer state (persistent across steps) and the
activation set (live inside one compiled step, before XLA's buffer reuse and
any rematerialization from transpiler.memory_optimize — so it is an upper
bound on activations, exact on state).
"""

from __future__ import annotations

from typing import Optional

from ..framework.program import Program, default_main_program

_DTYPE_BYTES = {"float32": 4, "float64": 8, "int32": 4, "int64": 8,
                "uint8": 1, "int8": 1, "bool": 1, "bfloat16": 2,
                "float16": 2, "int16": 2, "uint32": 4, "uint64": 8}


def _nbytes(var, batch_size: int) -> int:
    if var.shape is None:
        return 0
    numel = 1
    for d in var.shape:
        numel *= batch_size if int(d) == -1 else max(int(d), 1)
    from ..core.dtypes import dtype_name
    name = dtype_name(var.dtype)
    return numel * _DTYPE_BYTES.get(name, 4)


def memory_usage(program: Optional[Program] = None, batch_size: int = 1):
    """Returns a dict with byte counts:

    - ``parameters``: trainable + persistable state (params, moments,
      moving stats) — resident for the whole job
    - ``activations``: every non-persistable var the main block produces —
      an upper bound on one step's intermediate footprint (XLA reuses dead
      buffers; memory_optimize remat shrinks this further)
    - ``total`` and human-readable ``summary``
    """
    program = program or default_main_program()
    params = 0
    activations = 0
    seen = set()
    for block in program.blocks:
        for name, var in block.vars.items():
            if name in seen:
                continue
            seen.add(name)
            if getattr(var, "persistable", False):
                params += _nbytes(var, batch_size)
            elif not getattr(var, "is_data", False):
                activations += _nbytes(var, batch_size)
    total = params + activations

    def fmt(n):
        for unit in ("B", "KB", "MB", "GB", "TB"):
            if n < 1024 or unit == "TB":
                return f"{n:.2f} {unit}"
            n /= 1024.0

    return {"parameters": params, "activations": activations,
            "total": total,
            "summary": (f"state {fmt(float(params))}, activations <= "
                        f"{fmt(float(activations))}, total <= "
                        f"{fmt(float(total))} at batch_size={batch_size}")}
