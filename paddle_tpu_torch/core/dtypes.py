"""Dtype names ↔ torch dtypes.

≙ paddle_tpu/core/dtypes.py. Program variables carry a `torch.dtype`;
programs serialize dtypes by name ("float32", "bfloat16", "int64", ...),
the same names the JAX package writes, so a program serialized by either
package loads in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from .enforce import InvalidArgumentError

_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp32": torch.float32,
    "fp64": torch.float64,
}

_DTYPE_TO_NAME = {}
for _name, _dt in _NAME_TO_DTYPE.items():
    _DTYPE_TO_NAME.setdefault(_dt, _name)


def convert_dtype(dtype) -> torch.dtype:
    """Normalize a name / torch dtype / numpy dtype to a torch dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if not isinstance(dtype, str):
        dtype = np.dtype(dtype).name
    if dtype not in _NAME_TO_DTYPE:
        raise InvalidArgumentError(f"unknown dtype {dtype!r}")
    return _NAME_TO_DTYPE[dtype]


def dtype_name(dtype) -> str:
    return _DTYPE_TO_NAME[convert_dtype(dtype)]

