"""ParamAttr — per-parameter configuration.

≙ reference python/paddle/fluid/param_attr.py (ParamAttr, WeightNormParamAttr).
"""

from __future__ import annotations

from typing import Optional


class ParamAttr:
    def __init__(self, name: Optional[str] = None, initializer=None,
                 learning_rate: float = 1.0, regularizer=None,
                 trainable: bool = True, gradient_clip=None,
                 sharding_spec=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        # PartitionSpec-style tuple of mesh axis names (or None) per dim —
        # consumed by ParallelExecutor to place this parameter sharded
        # (TP/EP; NEW capability, no reference analogue — SURVEY §2.3).
        self.sharding_spec = sharding_spec

    @staticmethod
    def _to_attr(arg) -> Optional["ParamAttr"]:
        """Normalize the many accepted spellings (None/False/str/Initializer/
        ParamAttr) like the reference's ParamAttr._to_attr."""
        if arg is None:
            return ParamAttr()
        if arg is False:
            return None
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        # assume initializer
        return ParamAttr(initializer=arg)
