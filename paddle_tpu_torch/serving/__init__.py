"""Serving (≙ paddle_tpu/serving): the slot engine, the paged KV engine
with prefix sharing and beam search, weight-quantized serving and
speculative decoding. The server and transport are still to be ported
(ROADMAP.md §1 item 2)."""

from .engine import (ContinuousBatchingEngine, GenRequest,  # noqa: F401
                     SlotAllocator)
from .kv_pager import (BlockPool, BlockTable, KVPager,  # noqa: F401
                       PagedKVEngine, RadixPrefixIndex, paged_beam_search)
from .speculative import (SpecConfig, SpeculativeDecoder,  # noqa: F401
                          rejection_sample)
