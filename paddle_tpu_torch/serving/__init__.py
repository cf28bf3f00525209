"""Serving (≙ paddle_tpu/serving), with the JAX package's exports:

- `transport`  — the request/response RPC layer (`PredictorServer` /
  `PredictorClient`, vectored frames; the JAX package's wire format);
- `engine`     — the continuous-batching generation engine
  (`ContinuousBatchingEngine`) and its server (`EngineServer` /
  `EngineClient`, /metrics and /healthz);
- `kv_pager`   — the paged KV cache: block pool, block tables, prefix
  sharing, `PagedKVEngine` (with the pinned host tier, `host_tier=`)
  and `paged_beam_search`;
- `sanitizer`  — the shadow-state sanitizer over the paged KV stack
  (`PTPU_KV_SANITIZE=1`);
- `speculative` — speculative decoding over either engine.
"""

from __future__ import annotations

# -- transport -------------------------------------------------------------
from .transport import (  # noqa: F401
    PredictorClient,
    PredictorServer,
    _BatchingWriter,
    _RecvBufferPool,
    _byte_views,
    _encode_msg,
    _recv_exact,
    _recv_exact_into,
    _recv_msg,
    _send_msg,
    _sendall_vec,
)

# -- engine ----------------------------------------------------------------
from .engine import (  # noqa: F401
    ContinuousBatchingEngine,
    EngineClient,
    EngineServer,
    GenRequest,
    SlotAllocator,
    scrape_healthz,
    scrape_metrics,
)

# -- speculative decoding --------------------------------------------------
from .speculative import (  # noqa: F401
    SpecConfig,
    SpeculativeDecoder,
    rejection_sample,
)

# -- paged KV cache --------------------------------------------------------
from .kv_pager import (  # noqa: F401
    BlockPool,
    BlockTable,
    HostTierConfig,
    KVPager,
    PagedKVEngine,
    RadixPrefixIndex,
    paged_beam_search,
)

# -- shadow-state sanitizer ------------------------------------------------
from .sanitizer import (  # noqa: F401
    KVSanitizer,
    SanitizerDivergence,
)
