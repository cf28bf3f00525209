"""Sampled and hierarchical loss ops: NCE and the hierarchical sigmoid.

≙ paddle_tpu/ops/loss_ops.py (reference operators/nce_op.cc,
operators/hsigmoid_op.cc + operators/math/matrix_bit_code.h). Gradients
come from torch.autograd in the executor's vjp region.
"""

from __future__ import annotations

import math

import torch

from ..framework.registry import register_op
from .elementwise import softplus


def hsigmoid_code_length(num_classes: int) -> int:
    """The longest root-to-leaf path of the complete binary tree the
    hierarchical sigmoid walks (shared by the lowering and the layer, so
    the declared PreOut shape is the one made)."""
    return int(math.ceil(math.log2(num_classes))) + 1


@register_op("nce")
def _nce(ctx, ins, attrs):
    """Noise-contrastive estimation with a uniform negative sampler (≙
    nce_op.cc, sampler=uniform). The negatives are drawn from the run's
    generator (torch's Philox: not the JAX package's draws); the logit
    correction log(S / C) makes the objective a consistent estimator of
    softmax cross-entropy."""
    x = ins["Input"][0]                           # [N, D]
    label = ins["Label"][0].reshape(-1).to(torch.long)
    w = ins["Weight"][0]                          # [C, D]
    num_total = attrs["num_total_classes"]
    num_neg = attrs.get("num_neg_samples", 10)
    bias = ins["Bias"][0].reshape(-1) if ins.get("Bias") else None
    neg = torch.randint(0, num_total, (x.shape[0], num_neg),
                        generator=ctx.generator(attrs.get("seed", 0)),
                        device=x.device)
    cls = torch.cat([label[:, None], neg], dim=1)  # [N, 1 + S]
    logits = torch.einsum("nd,nsd->ns", x, w[cls])
    if bias is not None:
        logits = logits + bias[cls]
    corr = math.log(num_neg / num_total)           # log expected count
    pos_cost = softplus(-(logits[:, 0] - corr))
    neg_cost = softplus(logits[:, 1:] - corr).sum(-1)
    cost = (pos_cost + neg_cost).reshape(-1, 1)
    if ins.get("SampleWeight"):
        cost = cost * ins["SampleWeight"][0].reshape(-1, 1)
    return {"Cost": [cost], "SampleLogits": [logits],
            "SampleLabels": [cls]}


@register_op("hierarchical_sigmoid")
def _hsigmoid(ctx, ins, attrs):
    """SimpleCodeTable (operators/math/matrix_bit_code.h): a label's code
    is label + num_classes in a complete binary tree; bit j (from the
    least significant) is the target of internal node (code >> (j+1)) - 1.
    A fixed path length with a mask, so the shapes are static."""
    x = ins["X"][0]                               # [N, D]
    label = ins["Label"][0].reshape(-1).to(torch.long)
    w = ins["W"][0]                               # [C-1, D]
    num_classes = attrs["num_classes"]
    js = torch.arange(hsigmoid_code_length(num_classes), device=x.device)
    code = label + num_classes
    node = (code[:, None] >> (js[None, :] + 1)) - 1        # [N, L]
    bit = (code[:, None] >> js[None, :]) & 1
    valid = node >= 0
    node = torch.where(valid, node, 0)
    logits = torch.einsum("nd,nld->nl", x, w[node])
    if ins.get("Bias"):
        logits = logits + ins["Bias"][0].reshape(-1)[node]
    ce = softplus(logits) - bit.to(x.dtype) * logits
    return {"Out": [torch.where(valid, ce, 0.0).sum(1, keepdim=True)],
            "PreOut": [logits]}
