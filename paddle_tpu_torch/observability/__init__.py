"""Operational observability (≙ paddle_tpu/observability): the metrics
registry (Prometheus text exposition, served over /metrics by
`EngineServer`), the span ring (`tracing`) the executor and the serving
engines record into, the memory watermarks, MFU and the measured memory
census (`memory`), the predicted-against-measured cost ledger (`ledger`)
and the flight recorder's beacons and dossiers (`flight_recorder`), and
tracing's `rank_scope`, the tag triple of a multi-process world."""

from . import flight_recorder, ledger, memory, metrics, tracing  # noqa: F401
from .ledger import CostLedger, LedgerRow  # noqa: F401
from .metrics import (Counter, Gauge, Histogram,  # noqa: F401
                      MetricsRegistry, MultiRegistry, default_registry)
from .tracing import (SPAN_KINDS, Span, aggregate,  # noqa: F401
                      export_chrome_trace, rank_scope, record_counter,
                      record_span, scoped_tags, span, spans)
