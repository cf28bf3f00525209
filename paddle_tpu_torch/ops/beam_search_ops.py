"""Beam-search decode ops.

≙ paddle_tpu/ops/beam_search_ops.py (reference operators/beam_search_op.*
and beam_search_decode_op.*). The beam dimension is fixed ([B, K]
everywhere), as in the JAX package: `beam_search` grows every beam by one
token and keeps the K best continuations of each row, and `gather_tree`
backtracks the parent pointers into whole sequences at the end. Both run
on the device; neither reads a value on the host.
"""

from __future__ import annotations

import torch

from ..framework.registry import register_op
from .reduce_ops import top_k_lower_first
from .tensor_ops import fill_value, index_in_range

_NEG_INF = -1e9


@register_op("beam_search")
def _beam_search(ctx, ins, attrs):
    """One beam-growth step (≙ beam_search_op.cc).

    PreIds [B, K] (the tokens selected last step), PreScores [B, K] (the
    accumulated log-probs; beams 1..K-1 start at a large negative so the
    first step expands beam 0 only), Scores [B, K, V] this step's
    log-probs; attr end_id. A finished beam (PreIds == end_id) survives
    unchanged: its only continuation is end_id at its accumulated score.
    The K best of the [B, K·V] totals win, the lower flat index first
    among equal totals (as jax.lax.top_k). Outputs SelectedIds,
    SelectedScores and ParentIdx, each [B, K]."""
    pre_ids = ins["PreIds"][0]
    pre_scores = ins["PreScores"][0]
    scores = ins["Scores"][0]
    end_id = attrs["end_id"]
    b, k, v = scores.shape
    finished = pre_ids == end_id                         # [B, K]
    total = pre_scores[:, :, None] + scores              # [B, K, V]
    onehot_end = torch.arange(v, device=scores.device) == end_id
    frozen = torch.where(onehot_end[None, None, :], pre_scores[:, :, None],
                         _NEG_INF)
    total = torch.where(finished[:, :, None], frozen, total)
    top_scores, top_idx = top_k_lower_first(total.reshape(b, k * v), k)
    return {"SelectedIds": [top_idx % v],
            "SelectedScores": [top_scores],
            "ParentIdx": [top_idx // v]}


@register_op("gather_tree")
def _gather_tree(ctx, ins, attrs):
    """Backtrack the beams' parent pointers into sequences (≙
    beam_search_decode_op.cc; XLA/TF gather_tree). Ids / Parents [B, T, K]
    -> Out [B, T, K], Out[b, :, k] the k-th final beam's tokens. The walk
    goes over the T steps backwards on the device (the JAX package's
    reverse scan); a parent outside [-K, K) gives a filled token from
    there on, as jnp.take_along_axis fills."""
    ids = ins["Ids"][0]
    parents = ins["Parents"][0]
    b, t, k = ids.shape
    # the JAX package gathers int32 ids: its fill is int32's least value
    fill = fill_value(torch.int32)
    beam = torch.arange(k, device=ids.device).expand(b, k)
    filled = torch.zeros((b, k), dtype=torch.bool, device=ids.device)
    toks = [None] * t
    for step in range(t - 1, -1, -1):
        idx, out = index_in_range(beam, k)
        filled = filled | out
        toks[step] = ids[:, step].gather(1, idx).masked_fill(filled, fill)
        beam = parents[:, step].gather(1, idx)
    return {"Out": [torch.stack(toks, 1).to(torch.int64)]}
