"""Compat shim (≙ paddle_tpu/serving_engine.py): the continuous-batching
engine lives in the serving package (`paddle_tpu_torch.serving.engine`);
this module keeps the `serving_engine` import path of the JAX package."""

from __future__ import annotations

from .serving.engine import (  # noqa: F401
    ContinuousBatchingEngine,
    EngineClient,
    EngineServer,
    GenRequest,
    SlotAllocator,
    _MetricsHTTPServer,
    scrape_healthz,
    scrape_metrics,
)
from .serving.kv_pager import PagedKVEngine  # noqa: F401
