"""Moving weights into the port's scope.

`load_numpy_params` carries parameters across from the JAX package: the two
packages build the same programs with the same `unique_name` sequence, so a
parameter has the same name in both (tok_emb, l{i}_attn_{q,k,v,o}.w_0,
l{i}_ln{1,2}.{scale,bias}, l{i}_ffn_fc{1,2}.w_{0,1}, lm_head.w_{0,1}, ...).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .core.places import Place, resolve_device
from .framework.scope import Scope, global_scope


def load_numpy_params(params: Dict[str, np.ndarray],
                      scope: Optional[Scope] = None,
                      place: Optional[Place] = None) -> Scope:
    """Set each `name -> numpy array` of `params` in `scope` (default: the
    global scope) as a tensor on `place` (default: CUDAPlace(0); raises
    without a card unless a place is given). float64 arrays load as
    float32, as the JAX package runs them. Returns the scope."""
    scope = scope if scope is not None else global_scope()
    device = resolve_device(place)
    for name, value in params.items():
        t = torch.from_numpy(np.array(value))      # a private copy
        if t.dtype == torch.float64:
            t = t.float()
        scope.set_var(name, t.to(device))
    return scope
