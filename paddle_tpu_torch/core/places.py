"""Places: where the port's tensors live.

≙ paddle_tpu/core/places.py. The default place is the first CUDA card.
When no card is present the default place raises: the port never drops to
the CPU on its own. Pass `CPUPlace()` to run on the CPU, as the tests do.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch

from .enforce import InvalidArgumentError, OutOfRangeError, UnavailableError


@dataclass(frozen=True)
class Place:
    """A logical device slot: backend kind + index (≙ platform::Place)."""
    kind: str  # "cpu" | "cuda"
    device_id: int = 0

    def __repr__(self):
        return f"{self.kind.upper()}Place({self.device_id})"


def CPUPlace(device_id: int = 0) -> Place:  # noqa: N802  (fluid API name)
    return Place("cpu", device_id)


def CUDAPlace(device_id: int = 0) -> Place:  # noqa: N802
    return Place("cuda", device_id)


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def devices(kind: Optional[str] = None) -> List[torch.device]:
    """The visible devices of a kind (≙ the JAX package's `devices`):
    the CUDA cards by default ("cuda" or "gpu"), or the one CPU device for
    "cpu"."""
    if kind == "cpu":
        return [torch.device("cpu")]
    if kind not in (None, "cuda", "gpu"):
        raise InvalidArgumentError(f"unknown device kind {kind!r}")
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_count(kind: Optional[str] = None) -> int:
    return len(devices(kind))


def default_place() -> Place:
    """`CUDAPlace(0)`; raises when no CUDA card is visible."""
    if not torch.cuda.is_available():
        raise UnavailableError(
            "no CUDA device is visible; pass place=CPUPlace() to run on "
            "the CPU")
    return CUDAPlace(0)


def place_to_device(place: Place) -> torch.device:
    if place.kind == "cpu":
        return torch.device("cpu")
    if place.kind != "cuda":
        raise InvalidArgumentError(f"unknown place kind {place.kind!r}")
    if not torch.cuda.is_available():
        raise UnavailableError(f"{place!r} requested but no CUDA device "
                               f"is visible")
    n = torch.cuda.device_count()
    if place.device_id >= n:
        raise OutOfRangeError(f"device_id {place.device_id} out of range "
                              f"for {n} CUDA devices")
    return torch.device("cuda", place.device_id)


def resolve_device(place) -> torch.device:
    """`place` (a Place, or None for the default place) → torch.device."""
    return place_to_device(place if place is not None else default_place())
