"""Operational observability (≙ paddle_tpu/observability): the metrics
registry (Prometheus text exposition, served over /metrics by
`EngineServer`), the span ring (`tracing`) the executor and the serving
engines record into, and the memory watermarks behind the
`ptpu_memory_*` gauges (`memory`). The JAX package's ledger, flight
recorder and device-memory census are ROADMAP.md §1 item 4."""

from . import memory, metrics, tracing  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, MultiRegistry, default_registry)
from .tracing import (SPAN_KINDS, Span, aggregate,  # noqa: F401
                      export_chrome_trace, record_counter, record_span,
                      scoped_tags, span, spans)
