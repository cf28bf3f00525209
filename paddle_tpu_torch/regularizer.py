"""Weight-decay regularizers appended as program ops.

≙ paddle_tpu/regularizer.py (reference python/paddle/fluid/regularizer.py:
L1DecayRegularizer, L2DecayRegularizer appended during optimizer.minimize),
op for op: grad + coeff * param (L2) or grad + coeff * sign(param) (L1),
as `scale` / `sign` / `sum` ops.
"""

from __future__ import annotations

from .core.dtypes import dtype_name
from .layer_helper import LayerHelper


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l2_decay")
        decay = helper.create_tmp_variable(dtype=dtype_name(param.dtype),
                                           shape=param.shape,
                                           stop_gradient=True)
        block.append_op("scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff, "bias": 0.0,
                               "bias_after_scale": True})
        new_grad = helper.create_tmp_variable(dtype=dtype_name(grad.dtype),
                                              shape=grad.shape,
                                              stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [new_grad]})
        return new_grad


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def __call__(self, param, grad, block):
        helper = LayerHelper("l1_decay")
        sign = helper.create_tmp_variable(dtype=dtype_name(param.dtype),
                                          shape=param.shape,
                                          stop_gradient=True)
        block.append_op("sign", inputs={"X": [param]},
                        outputs={"Out": [sign]})
        decay = helper.create_tmp_variable(dtype=dtype_name(param.dtype),
                                           shape=param.shape,
                                           stop_gradient=True)
        block.append_op("scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff, "bias": 0.0,
                               "bias_after_scale": True})
        new_grad = helper.create_tmp_variable(dtype=dtype_name(grad.dtype),
                                              shape=grad.shape,
                                              stop_gradient=True)
        block.append_op("sum", inputs={"X": [grad, decay]},
                        outputs={"Out": [new_grad]})
        return new_grad


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer


def append_regularization_ops(params_grads, regularization=None):
    """≙ reference regularizer.py append_regularization_ops."""
    out = []
    for param, grad in params_grads:
        reg = param.regularizer or regularization
        if reg is None:
            out.append((param, grad))
            continue
        block = grad.block
        out.append((param, reg(param, grad, block)))
    return out
