"""Sequence layers.

≙ paddle_tpu/layers/sequence.py, trimmed to `get_seqlen` and
`sequence_mask` (the padded LM batch's loss mask). A padded sequence is a
dense [B, T] variable with a companion `<name>@SEQLEN` length variable
(the static-shape translation of the reference's LoD).
"""

from __future__ import annotations

from ..core.enforce import NotFoundError, enforce
from ..layer_helper import LayerHelper


def get_seqlen(var):
    """Resolve the companion sequence-length variable of a padded sequence."""
    sl = getattr(var, "seqlen_var", None)
    if sl is not None:
        return sl
    v = var.block.vars.get(var.name + "@SEQLEN")
    enforce(v is not None,
            f"variable {var.name!r} has no sequence-length companion; "
            f"declare it with layers.data(..., lod_level=1) or propagate "
            f"seqlen_var", exc=NotFoundError)
    return v


def sequence_mask(x, maxlen, dtype="float32", name=None):
    """[B] lengths -> [B, maxlen] 0/1 mask (≙ reference sequence_mask).
    maxlen is static."""
    helper = LayerHelper("sequence_mask", name=name)
    out = helper.create_tmp_variable(dtype=dtype,
                                     shape=[x.shape[0], int(maxlen)])
    helper.append_op(type="sequence_mask", inputs={"X": [x]},
                     outputs={"Y": [out]}, attrs={"maxlen": int(maxlen)})
    return out
