"""≙ paddle_tpu/average.py (reference python/paddle/fluid/average.py,
WeightedAverage)."""

from __future__ import annotations

import numpy as np

from .core.enforce import InvalidArgumentError, enforce


class WeightedAverage:
    """Running weighted average of scalar-ish metrics
    (≙ reference average.py WeightedAverage: add(value, weight), eval())."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight=1):
        value = np.asarray(value, dtype=np.float64)
        enforce(np.isfinite(value).all(),
                "WeightedAverage.add got non-finite value",
                exc=InvalidArgumentError)
        self.numerator += float(value.mean()) * float(weight)
        self.denominator += float(weight)

    def eval(self):
        enforce(self.denominator > 0,
                "WeightedAverage.eval before any add",
                exc=InvalidArgumentError)
        return self.numerator / self.denominator
