"""Tracing for the port's serving tick (see `trace`)."""
from repro_torch.serve.observability.trace import (  # noqa: F401
    NULL_TRACER,
    TraceEvent,
    TraceRecorder,
)
