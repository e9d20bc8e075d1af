"""Per-tenant request queues for the deadline-aware serving front end.

A `Request` is one admitted unit of work: a block of float-feature rows
for one tenant, an absolute deadline in the front end's clock domain, and
a `concurrent.futures.Future` the caller holds.  `RequestQueue` is the
FIFO behind one tenant; it knows how to expire requests whose deadline
has passed and how to drain whole requests up to a row budget (a request
is never split across launches — its rows decode as one block).

A queue has no lock of its own and is not thread-safe: the front end's
lock (`AsyncCircuitServer._lock`) guards **every** access, reads included.
`rows()` and `earliest_deadline()` iterate the deque, and a push from
another thread in the middle of that iteration raises ``RuntimeError:
deque mutated during iteration`` — so nothing outside the front end reads
a queue, and the front end reads one only under its lock (its locked
accessors `queue_rows`, `latency_est` and `pending_requests` are what
other threads call).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from concurrent.futures import Future

import numpy as np


class DeadlineExceededError(TimeoutError):
    """The request's deadline passed before it could be served."""


class AdmissionError(RuntimeError):
    """The request was rejected at submit (deadline already in the past)."""


@dataclasses.dataclass
class Request:
    """One admitted request: rows for a tenant, a deadline, a future."""

    tenant_id: str
    features: np.ndarray   # float32[rows, n_features]
    deadline: float        # absolute, in the front end's clock domain
    future: Future
    submitted_at: float
    trace_id: int = 0      # async-span correlation id (0 = untraced)
    seq: int = 0           # front-end request id — the handle late label
    #                        feedback joins back on (submit_feedback)

    @property
    def rows(self) -> int:
        return int(self.features.shape[0])


class RequestQueue:
    """FIFO of `Request`s for one tenant (guarded by the front end's lock)."""

    def __init__(self, tenant_id: str):
        self.tenant_id = tenant_id
        self._q: deque[Request] = deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> None:
        self._q.append(req)

    def rows(self) -> int:
        return sum(r.rows for r in self._q)

    def earliest_deadline(self) -> float | None:
        """Deadlines are per-request, not FIFO-ordered — scan the queue."""
        return min((r.deadline for r in self._q), default=None)

    def oldest_arrival(self) -> float | None:
        return self._q[0].submitted_at if self._q else None

    def expire(self, now: float) -> list[Request]:
        """Remove and return every request whose deadline is <= now."""
        expired = [r for r in self._q if r.deadline <= now]
        if expired:
            self._q = deque(r for r in self._q if r.deadline > now)
        return expired

    def take(self, max_rows: int) -> list[Request]:
        """Drain whole requests FIFO until the next would exceed
        ``max_rows``.  Always takes at least one (an oversized request
        still has to be served — alone)."""
        out: list[Request] = []
        taken = 0
        while self._q:
            nxt = self._q[0]
            if out and taken + nxt.rows > max_rows:
                break
            out.append(self._q.popleft())
            taken += nxt.rows
        return out
