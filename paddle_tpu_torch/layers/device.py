"""Device layer helpers (≙ paddle_tpu/layers/device.py, reference
python/paddle/fluid/layers/device.py)."""

from __future__ import annotations

import torch

from ..core.places import CPUPlace, CUDAPlace


def get_places(device_count=None, device_type=None):
    """≙ reference layers.device.get_places (ParallelDo-era code): the
    visible device Places. device_type None lists the CUDA cards (the CPU
    when there is none), "CPU" the CPU, "GPU" / "CUDA" the cards; at most
    device_count of them."""
    cards = [CUDAPlace(i) for i in range(torch.cuda.device_count())]
    if device_type == "CPU":
        places = [CPUPlace()]
    elif device_type in ("GPU", "CUDA"):
        places = cards
    else:
        places = cards or [CPUPlace()]
    return places[:device_count] if device_count else places
