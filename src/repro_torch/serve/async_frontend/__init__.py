"""Deadline-aware async serving front end over `repro_torch.serve.circuits`.

Per-tenant request queues (`queue`), a pure deadline/batching scheduler
that decides when each shard's launch fires (`scheduler`), and the
asyncio-friendly `AsyncCircuitServer` facade that wires both onto a
synchronous `CircuitServer` (`frontend`), under one lock that guards every
read of scheduler state.
"""
from repro_torch.serve.async_frontend.frontend import AsyncCircuitServer
from repro_torch.serve.async_frontend.queue import (
    AdmissionError,
    DeadlineExceededError,
    Request,
    RequestQueue,
)
from repro_torch.serve.async_frontend.scheduler import DeadlineScheduler, FireDecision

__all__ = [
    "AdmissionError",
    "AsyncCircuitServer",
    "DeadlineExceededError",
    "DeadlineScheduler",
    "FireDecision",
    "Request",
    "RequestQueue",
]
