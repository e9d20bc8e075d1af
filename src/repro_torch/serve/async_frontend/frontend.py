"""AsyncCircuitServer: asyncio-friendly, deadline-aware serving facade.

Wraps a synchronous `CircuitServer` and inverts who drives launches: the
caller enqueues requests with deadlines and gets a future; a
`DeadlineScheduler` decides when the next fire happens; one
`CircuitServer.step()` executes it (one spans launch per plan shard with
work, through the shard's span-launch unit on the card).  Three ways to
drive:

  * ``await frontend.submit(tenant, x, deadline_s=...)`` from a coroutine
    (with the background scheduler thread started — ``start()``/``stop()``
    or ``with``/``async with``);
  * ``frontend.enqueue(...)`` from plain threaded code, returning a
    `concurrent.futures.Future`;
  * ``frontend.pump(now)`` for deterministic single-step scheduling under
    an injected fake clock (how the tests drive it).

Admission control rejects requests whose deadline has already passed at
submit; the scheduler sheds queued requests whose deadline passes before
a launch can carry them (their future fails with
`DeadlineExceededError`).  `FrontendStats` counts both as deadline
misses, alongside per-request latency percentiles, queue depth, and
batch fill.

Locking: the scheduler and its queues have no lock of their own; the
front end's ``_lock`` guards every access to them, reads included.  Other
threads (the autoscale controller, a caller of `stop`) read scheduler
state only through the locked accessors `queue_rows`, `latency_est` and
`pending_requests`, and latency observations and EWMA rebinds take the
same lock — so a push from a submitting thread can never land in the
middle of an iteration over a queue.

Devices: the scheduler thread never relies on its current CUDA device.
Every launch goes to the device `CircuitServer.device_for` names for its
shard, an explicit `torch.device`, and the kernel wrappers enter that
device around the launch.
"""
from __future__ import annotations

import asyncio
import threading
import time
import traceback
import warnings
from concurrent.futures import Future
from typing import Awaitable, Callable

import numpy as np

from repro_torch.serve.async_frontend.queue import (
    AdmissionError,
    DeadlineExceededError,
    Request,
)
from repro_torch.serve.async_frontend.scheduler import DeadlineScheduler, FireDecision
from repro_torch.serve.circuits.metrics import FrontendStats
from repro_torch.serve.circuits.registry import DEFAULT_QOS
from repro_torch.serve.circuits.server import CircuitServer


class AsyncCircuitServer:
    """Deadline-aware front end over one synchronous `CircuitServer`."""

    def __init__(
        self,
        server: CircuitServer,
        *,
        clock: Callable[[], float] = time.monotonic,
        idle_poll_s: float = 0.050,
        latency_est_s: float = 0.0,
    ):
        self.server = server
        self.clock = clock
        self.idle_poll_s = float(idle_poll_s)
        self.scheduler = DeadlineScheduler(
            self._qos_for, shard_of=self._shard_of,
            latency_est_s=latency_est_s,
        )
        self.stats = FrontendStats(backend=server.backend.name)
        # one timeline across the stack: the front end traces onto
        # whatever recorder the wrapped server was constructed with
        self.tracer = server.tracer
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # online-evolution hookup (attach_evolution): completion
        # observations + the label-feedback channel route through here
        self.evolution = None
        self._seq = 0

    def _qos_for(self, tenant: str):
        """Registry QoS, falling back to defaults for tenants removed with
        requests still queued (their requests must still fire so the
        server can fail them individually)."""
        try:
            return self.server.registry.qos(tenant)
        except KeyError:
            return DEFAULT_QOS

    def _shard_of(self, tenant: str) -> int:
        """Compiled-plan shard a tenant's launches ride — the scheduler
        keys per-shard fire times and latency EWMAs on this, so one
        shard's backlog cannot miss another shard's deadlines."""
        return self.server.shard_of(tenant)

    # -- locked reads of scheduler state (for other threads) -------------
    def queue_rows(self) -> int:
        """Rows queued across every tenant, read under the front-end lock."""
        with self._lock:
            return self.scheduler.queue_rows()

    def latency_est(self, shard: int = 0) -> float:
        """One shard's launch-latency EWMA, read under the front-end lock."""
        with self._lock:
            return self.scheduler.latency_est(shard)

    def pending_requests(self) -> int:
        """Requests queued across every tenant, read under the front-end
        lock."""
        with self._lock:
            return self.scheduler.pending_requests()

    def rebind_shards(self, carry: "dict[int, int]", n_shards: int) -> None:
        """Carry the scheduler's per-shard latency EWMAs across a plan
        swap (see `DeadlineScheduler.rebind_shards`) — called by the
        autoscale controller right after `CircuitServer.swap_plan`, under
        the front-end lock so a concurrent poll sees either the old or
        the new estimates, never a mix."""
        with self._lock:
            self.scheduler.rebind_shards(carry, n_shards)

    def _launched_shards(self, decision: FireDecision) -> tuple:
        """Every shard the batch is about to launch on: the fired shards
        plus any holding an ensemble member of a batch tenant."""
        shards = set(decision.shards)
        placement = self.server.plan().placement
        for req in decision.batch:
            for ref in placement.get(req.tenant_id, ()):
                shards.add(ref.shard)
        return tuple(sorted(shards))

    # -- request interface --------------------------------------------
    def enqueue(
        self,
        tenant: str,
        x: np.ndarray,
        *,
        deadline_s: float | None = None,
        deadline: float | None = None,
    ) -> Future:
        """Admit rows for one tenant; returns a `concurrent.futures.Future`
        resolving to class ids.

        ``deadline`` is absolute (front-end clock domain); ``deadline_s``
        is relative to now; neither falls back to the tenant's QoS
        ``default_deadline_s``.  Raises `AdmissionError` if the deadline
        has already passed, `KeyError`/`ValueError` for unknown tenants or
        wrong feature width — load shedding at the door, before the
        request can cost an encode or a queue slot."""
        now = self.clock()
        qos = self.server.registry.qos(tenant)  # KeyError for unknown tenant
        x = np.atleast_2d(np.asarray(x, np.float32))
        want = self.server.registry.get(tenant).encoder.n_features
        if x.shape[1] != want:
            raise ValueError(
                f"tenant {tenant!r} expects {want} features, got {x.shape[1]}"
            )
        if deadline is None:
            deadline = now + (
                qos.default_deadline_s if deadline_s is None else deadline_s
            )
        if deadline <= now:
            self.stats.record_rejected()
            self.tracer.instant(
                "request.rejected", cat="request", tenant=tenant,
                deadline=float(deadline),
            )
            raise AdmissionError(
                f"tenant {tenant!r}: deadline {deadline:.6f} already passed "
                f"at submit (now={now:.6f})"
            )
        fut: Future = Future()
        # async (b/.../e) span: the request's lifecycle crosses from this
        # submit thread to the scheduler thread, correlated by id
        trace_id = self.tracer.next_id() if self.tracer.enabled else 0
        with self._lock:
            self._seq += 1
            seq = self._seq
        req = Request(
            tenant_id=tenant, features=x, deadline=float(deadline),
            future=fut, submitted_at=now, trace_id=trace_id, seq=seq,
        )
        # callers that will submit_feedback later read the id off the
        # future they already hold
        fut.request_id = seq
        if trace_id:
            self.tracer.async_begin(
                "request", trace_id, cat="request", tenant=tenant,
                rows=req.rows, deadline_in_s=round(deadline - now, 6),
            )
        with self._lock:
            self.scheduler.push(req)
            self.stats.record_submitted()
        self._wake.set()
        return fut

    def submit(
        self,
        tenant: str,
        x: np.ndarray,
        *,
        deadline_s: float | None = None,
        deadline: float | None = None,
    ) -> "Awaitable[np.ndarray]":
        """asyncio facade: ``ids = await frontend.submit(tenant, x)``.

        Must be called with a running event loop; admission errors raise
        immediately (not through the awaitable)."""
        fut = self.enqueue(tenant, x, deadline_s=deadline_s, deadline=deadline)
        return asyncio.wrap_future(fut)

    # -- scheduling ----------------------------------------------------
    def pump(self, now: float | None = None) -> FireDecision:
        """One deterministic scheduler step: shed, then fire if due.

        The manual-drive alternative to the background thread — tests call
        this with a fake clock; a caller embedding the front end in its
        own loop can call it instead of ``start()``."""
        now = self.clock() if now is None else now
        with self._lock:
            decision = self.scheduler.poll(now)
            self.stats.record_poll(decision.queue_rows)
        self.tracer.counter(
            "queue.rows", decision.queue_rows, cat="scheduler",
            track="scheduler",
        )
        self._complete(decision, now)
        return decision

    def _complete(self, decision: FireDecision, now: float) -> None:
        for req in decision.expired:
            self.stats.record_shed(1)
            if req.trace_id:
                self.tracer.async_end(
                    "request", req.trace_id, cat="request", outcome="shed",
                    queued_s=round(now - req.submitted_at, 6),
                )
            req.future.set_exception(DeadlineExceededError(
                f"tenant {req.tenant_id!r}: deadline passed after "
                f"{now - req.submitted_at:.6f}s in queue"
            ))
        if not decision.batch:
            return
        self.tracer.instant(
            "scheduler.fire", cat="scheduler", track="scheduler",
            reason=decision.reason,
            shards=list(decision.shards),
            shard_reasons=[f"{s}:{r}" for s, r in decision.shard_reasons],
            requests=len(decision.batch),
        )
        for req in decision.batch:
            if req.trace_id:
                self.tracer.async_instant(
                    "request", req.trace_id, cat="request", state="fired",
                    reason=decision.reason,
                    queued_s=round(now - req.submitted_at, 6),
                )
        try:
            # read the placement before the step: this is the plan the
            # step is about to launch on, and reading it afterwards could
            # compile a *newer* plan (concurrent registry mutation) whose
            # compile time would also pollute the latency measurement
            launched = self._launched_shards(decision)
            outs = self.server.step(
                [(r.tenant_id, r.features) for r in decision.batch]
            )
        except Exception as err:  # noqa: BLE001 — a failed launch must fail
            # its own requests' futures, never strand them (or, from the
            # background thread, kill it)
            for r in decision.batch:
                if r.trace_id:
                    self.tracer.async_end(
                        "request", r.trace_id, cat="request",
                        outcome="error", error=type(err).__name__,
                    )
                r.future.set_exception(err)
            raise
        done = self.clock()
        with self._lock:
            # one wall-clock measurement covers every shard that rode this
            # step — including shards the scheduler did not fire but that
            # launched anyway because an ensemble tenant in the batch has
            # members placed there; each folds it into its own EWMA
            for shard in launched or (0,):
                self.scheduler.observe_latency(done - now, shard=shard)
            self.stats.record_fire(
                decision.reason, self.scheduler.batch_fill(decision.batch),
                shards=launched,
                reasons=[r for _, r in decision.shard_reasons],
            )
        for req, out in zip(decision.batch, outs):
            self.stats.record_request(
                done - req.submitted_at, late=done > req.deadline
            )
            if req.trace_id:
                failed = isinstance(out, Exception)
                self.tracer.async_end(
                    "request", req.trace_id, cat="request",
                    outcome=("error" if failed
                             else "late" if done > req.deadline else "ok"),
                    latency_s=round(done - req.submitted_at, 6),
                )
            if isinstance(out, Exception):
                req.future.set_exception(out)
            else:
                req.future.set_result(out)
                if self.evolution is not None:
                    try:
                        self.evolution.observe(
                            req.tenant_id, req.seq, req.features, out
                        )
                    except Exception:  # noqa: BLE001 — telemetry must
                        # never fail a request that already resolved
                        pass

    # -- online evolution ----------------------------------------------
    def attach_evolution(self, manager) -> None:
        """Register an evolution manager: served requests flow to its
        completion hook (``observe``) and `submit_feedback` routes to it."""
        self.evolution = manager

    def submit_feedback(self, tenant: str, request_id: int, labels) -> int:
        """Deliver late ground truth for a previously served request
        (``request_id`` is ``future.request_id`` from `enqueue`).
        Returns the number of labeled rows accepted."""
        if self.evolution is None:
            raise RuntimeError(
                "no EvolutionManager attached — construct one over this "
                "front-end (it calls attach_evolution) before submitting "
                "feedback"
            )
        return self.evolution.submit_feedback(tenant, request_id, labels)

    # -- background scheduler thread ------------------------------------
    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                decision = self.pump()
            except Exception:  # noqa: BLE001 — the scheduler thread must
                # survive a failed launch; the batch's futures already
                # carry the error (see _complete), so callers see it
                warnings.warn(
                    "async serving launch failed; affected request futures "
                    f"carry the error:\n{traceback.format_exc()}",
                    RuntimeWarning, stacklevel=1,
                )
                continue
            if decision.batch or decision.expired:
                continue  # re-poll immediately: leftovers may be due
            now = self.clock()
            if decision.next_wake is None:
                wait = self.idle_poll_s
            else:
                wait = max(decision.next_wake - now, 0.0)
            self._wake.wait(wait)
            self._wake.clear()

    def start(self) -> "AsyncCircuitServer":
        """Start the scheduler thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="circuit-serve-scheduler", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 5.0) -> None:
        """Stop the scheduler thread.  With ``drain`` (default), pending
        requests get one final poll at +inf deadline pressure — i.e. they
        are either served now or shed — so no future is left unresolved.
        The pending count is read under the lock: submitting threads may
        still be pushing while the drain runs."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        if drain:
            while self.pending_requests():
                decision = self.pump()
                if not (decision.batch or decision.expired):
                    # nothing due yet — force the stragglers out now
                    self._drain_now()
                    break

    def _drain_now(self) -> None:
        with self._lock:
            batch = self.scheduler.drain_all()
        if batch:
            self._complete(
                FireDecision(batch, [], "drain", None, 0), self.clock()
            )

    # -- context managers ----------------------------------------------
    def __enter__(self) -> "AsyncCircuitServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    async def __aenter__(self) -> "AsyncCircuitServer":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await asyncio.to_thread(self.stop)
