"""Tracing for the port's serving stack and fit (see `trace`) and its exporters
(see `export`): Chrome-trace/Perfetto JSON, JSONL and a Prometheus text
snapshot of the aggregate stats, as the reference package has them."""
from repro_torch.serve.observability.export import (
    export_chrome,
    export_jsonl,
    prometheus_text,
    to_chrome,
)
from repro_torch.serve.observability.trace import (
    NULL_TRACER,
    TraceEvent,
    TraceRecorder,
    active,
    recording,
)

__all__ = [
    "NULL_TRACER",
    "TraceEvent",
    "TraceRecorder",
    "active",
    "export_chrome",
    "export_jsonl",
    "prometheus_text",
    "recording",
    "to_chrome",
]
