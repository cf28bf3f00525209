"""State categories of the memory census.

≙ paddle_tpu/framework/costs.py, trimmed to `state_category`: the serving
engines' byte accounting (`params_bytes_f32` / `params_bytes_quantized`,
the speculative draft's `draft_param_bytes`) reads it. The cost model and
the predicted memory walk wait for ROADMAP.md §1 item 4.
"""

from __future__ import annotations


def state_category(v, name: str) -> str:
    """The state-category classifier (≙ the JAX package's, line for line).
    `v` may be None (an undeclared scope var): other_state."""
    if v is not None and (getattr(v, "dp_replica_state", False)
                          or name.startswith("dp_comm_err")):
        return "ef_residual"
    if v is not None and (getattr(v, "is_optimizer_state", False)
                          or getattr(v, "accumulator_of", None)):
        return "optimizer_state"
    if name.startswith("draft_") and (
            name.endswith("@qparam") or name.endswith("@qscale")
            or (v is not None and getattr(v, "trainable", False))):
        # speculative-decoding draft-model weights (serving/speculative.py
        # copies target weights under the reserved `draft_` prefix); the
        # prefix check precedes the suffix check — a quantized draft
        # weight `draft_*@qparam` is params_draft, not params_quantized
        return "params_draft"
    if name.endswith("@qparam") or name.endswith("@qscale"):
        # quantize_params_pass payload/scale pairs, classified by NAME
        # suffix (the pass's census contract)
        return "params_quantized"
    if v is not None and getattr(v, "trainable", False):
        return "params"
    return "other_state"
