"""The scale layer and the declared-shape broadcast rule.

≙ paddle_tpu/layers/math_ops.py, trimmed to the serving slice.
"""

from __future__ import annotations

from ..core.dtypes import dtype_name
from ..layer_helper import LayerHelper


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_tmp_variable(dtype=dtype_name(x.dtype), shape=x.shape)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def _broadcast_shape(sa, sb):
    """Declared shape of a trailing-aligned elementwise result. The old
    rule ("higher-rank operand wins") under-declared broadcast dims of the
    equal-rank case — e.g. [1, 1, T] < [S, 1, 1] really yields [S, 1, T] —
    which the static analyzer (framework/analysis.py) flags as a
    declared-shape lie. -1 (batch) dims broadcast like any size but stay
    symbolic in the result."""
    if not sa or not sb:
        return sa if sa else sb
    ra, rb = len(sa), len(sb)
    out = []
    for i in range(max(ra, rb)):
        da = sa[ra - 1 - i] if i < ra else 1
        db = sb[rb - 1 - i] if i < rb else 1
        if da == db:
            out.append(da)
        elif da == 1:
            out.append(db)
        elif db == 1:
            out.append(da)
        elif -1 in (da, db):
            out.append(-1)
        else:
            out.append(da)    # incompatible: runtime raises; keep a's view
    out.reverse()
    return tuple(out)

