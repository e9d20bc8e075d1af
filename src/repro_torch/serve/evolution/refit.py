"""Background re-evolution of drifted circuits (PyTorch port).

When a tenant's `DriftDetector` trips, the loop does not retrain in the
serving thread — it hands a `RefitJob` to the `RefitWorker`, which
re-runs the paper's 1+λ search on a recent window of labeled traffic
(the tenant's `ReplayBuffer`), **seeded from the live genome**
(`evolve_packed(..., seed_genome=...)`), in its own process.  The live
circuit keeps serving untouched; the result comes back through a
callback and enters the shadow/canary pipeline (`promote`).

Design points:

  * **Rate-limited** — at most one running job per tenant, and a
    ``min_interval_s`` cool-down between accepted jobs per tenant, so a
    noisy detector cannot saturate the host with searches.
  * **Cancellable** — a queued job is dropped outright; a running job's
    result is discarded on delivery (cancellation is at job granularity,
    which the small online generation budgets keep short).
  * **Encoder refresh** — under covariate shift the stale thresholds are
    usually the problem, so by default the refit refits the encoder on
    the replay window too (same strategy/bits → same bit width → the
    live genome still seeds cleanly and the spec is unchanged).
  * **Deterministic** — the search's generator is seeded from the tenant
    name and the per-tenant refit counter, so a replayed scenario
    reproduces the same candidate.

Departure from the reference: `RefitConfig` takes ``device`` where the
reference takes ``backend``.  ``None`` is the card (the search's packed
data and masks live there and `eval_program` launches the kernel), and
raises `NoCudaDeviceError` without one; ``"cpu"`` runs the plain
versions.  The search's draws come from a `torch.Generator`, which cannot
reproduce the reference's threefry stream, so a candidate equals the
reference's only when the reference's draws are replayed into it.
`RefitWorker` increments ``completed`` and ``discarded`` under its lock;
the reference increments them on the worker thread without it, as it does
the manager's counters (see `manager`).  A background `RefitWorker` runs
each search in a child interpreter of its own (`refit_process`), where the
reference runs it on the worker thread: the reference's search is one
jitted call that holds no interpreter lock, the port's is a Python loop of
torch calls that would share one with the serving loop.  `start()` returns
once the child is ready, and raises if it cannot start; a job whose child
dies fails with a warning, and nothing runs the search on the thread
instead.  The child's kernel launches are tallied in
``RefitWorker.remote_launches`` (launch counts are per process).
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue as queue_mod
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import encoding as E
from repro_torch.core.api import ServableCircuit
from repro_torch.core.evolve import EvolveConfig, evolve_packed
from repro_torch.core.genome import Genome
from repro_torch.device import resolve_device
from repro_torch.serve.evolution.drift import bit_activation_stats
from repro_torch.serve.evolution.refit_process import RefitProcess, RefitProcessError
from repro_torch.serve.observability.trace import NULL_TRACER, TraceRecorder


@dataclasses.dataclass(frozen=True)
class RefitConfig:
    """Online search budget — deliberately far below the offline §5.4
    settings: a refit races live decay, and the seed genome means it
    starts near a solution instead of from noise.  ``device`` is where
    the search runs (``None``: the card)."""

    lam: int = 4
    p: "float | None" = None
    gamma: float = 0.01
    kappa: int = 80
    max_gens: int = 400
    val_fraction: float = 0.5
    min_replay_rows: int = 128
    min_interval_s: float = 0.0
    seed_from_live: bool = True
    refit_encoder: bool = True
    device: "str | torch.device | None" = None

    def evolve_config(self) -> EvolveConfig:
        return EvolveConfig(
            lam=self.lam, p=self.p, gamma=self.gamma, kappa=self.kappa,
            max_gens=self.max_gens,
        )


class ReplayBuffer:
    """Bounded recent-window store of labeled rows for one tenant.

    Feedback appends ``(x, y)`` blocks; the buffer keeps the most recent
    ``capacity_rows`` rows (oldest blocks evicted whole).  `snapshot`
    returns contiguous arrays for the packer.  Thread-safe: feedback
    arrives on caller threads, snapshots on the refit thread."""

    def __init__(self, capacity_rows: int = 4096):
        if capacity_rows < 1:
            raise ValueError(f"capacity_rows must be >= 1, got "
                             f"{capacity_rows}")
        self.capacity_rows = capacity_rows
        self._lock = threading.Lock()
        self._blocks: list[tuple[np.ndarray, np.ndarray]] = []
        self._rows = 0

    def extend(self, x: np.ndarray, y: np.ndarray) -> int:
        x = np.atleast_2d(np.asarray(x, np.float32))
        y = np.asarray(y, np.int64).reshape(-1)
        if x.shape[0] != y.shape[0]:
            raise ValueError(
                f"rows/labels mismatch: {x.shape[0]} vs {y.shape[0]}"
            )
        if x.shape[0] == 0:
            return self._rows
        with self._lock:
            self._blocks.append((x, y))
            self._rows += x.shape[0]
            while self._rows > self.capacity_rows and len(self._blocks) > 1:
                bx, _ = self._blocks.pop(0)
                self._rows -= bx.shape[0]
            return self._rows

    def __len__(self) -> int:
        with self._lock:
            return self._rows

    def snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        with self._lock:
            blocks = list(self._blocks)
        if not blocks:
            return (np.zeros((0, 0), np.float32), np.zeros(0, np.int64))
        return (np.concatenate([b[0] for b in blocks]),
                np.concatenate([b[1] for b in blocks]))


class RefitResult(NamedTuple):
    """One finished background search."""

    tenant: str
    candidate: ServableCircuit   # carries lineage + fresh ref_stats
    parent_hash: str
    val_fitness: float
    generations: int
    replay_rows: int
    seeded: bool
    duration_s: float


def _refit_key(tenant: str, refit_index: int) -> torch.Generator:
    """Deterministic per-(tenant, attempt) generator of the search, seeded
    as the reference seeds its key."""
    digest = hashlib.sha256(f"{tenant}:{refit_index}".encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:4], "big"))


def refit_circuit(
    tenant: str,
    live: ServableCircuit,
    x: np.ndarray,
    y: np.ndarray,
    cfg: RefitConfig = RefitConfig(),
    *,
    refit_index: int = 0,
) -> RefitResult:
    """One synchronous refit: re-evolve ``live`` on the labeled window.

    The pure core the worker's process runs — also the hook for tests and
    benchmarks that want determinism without threads.  The search runs
    on ``cfg.device``; the candidate's genome comes back to the host."""
    from repro_torch.serve.planning import circuit_digest  # cycle-free at call

    t0 = time.perf_counter()
    x = np.atleast_2d(np.asarray(x, np.float32))
    y = np.asarray(y, np.int64).reshape(-1)
    if x.shape[0] < 2:
        raise ValueError(f"tenant {tenant!r}: refit needs >= 2 rows")
    if cfg.refit_encoder:
        enc = E.fit_encoder(
            x, E.EncodingConfig(live.encoder.strategy, live.encoder.bits)
        )
    else:
        enc = live.encoder
    bits = E.encode(enc, x)
    data = E.pack_dataset(bits, y, live.n_classes, live.spec.n_outputs,
                          device=cfg.device)
    w = data.x_words.shape[1]
    mtr, mva = E.split_masks(
        x.shape[0], w, cfg.val_fraction, seed=refit_index, device=cfg.device
    )
    parent_hash = circuit_digest(live)
    final = evolve_packed(
        _refit_key(tenant, refit_index), live.spec, cfg.evolve_config(),
        data, mtr, mva,
        seed_genome=live.genome if cfg.seed_from_live else None,
    )
    parent_lineage = live.lineage or {}
    candidate = ServableCircuit(
        spec=live.spec, genome=Genome(*(a.cpu() for a in final.best)),
        encoder=enc, n_classes=live.n_classes,
        lineage={
            "parent_hash": parent_hash,
            "refit_generation": int(
                parent_lineage.get("refit_generation", 0)) + 1,
            "replay_rows": int(x.shape[0]),
            "val_fitness": float(final.best_val),
            "search_generations": int(final.gen),
            "seeded": bool(cfg.seed_from_live),
        },
        ref_stats=bit_activation_stats(enc, x),
    )
    return RefitResult(
        tenant=tenant, candidate=candidate, parent_hash=parent_hash,
        val_fitness=float(final.best_val), generations=int(final.gen),
        replay_rows=int(x.shape[0]), seeded=cfg.seed_from_live,
        duration_s=time.perf_counter() - t0,
    )


@dataclasses.dataclass
class _Job:
    tenant: str
    live: ServableCircuit
    buffer: ReplayBuffer
    on_done: Callable[[RefitResult], None]
    refit_index: int
    cancelled: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )


class RefitWorker:
    """One background thread draining a queue of refit jobs.

    ``request`` enqueues (False when rate-limited, the tenant already
    has a job in flight, or the replay buffer is still too thin);
    ``cancel`` drops a queued job or marks a running one so its result
    is discarded.  With ``synchronous=True`` the job runs inline in
    `request` — the deterministic mode tests and fake-clock benchmarks
    drive.  The configuration's device is resolved here, so a worker
    asked for the card on a host without one raises at construction.

    A background worker's searches run in its child process (`start`
    spawns it and waits for it to be ready); the worker thread sends each
    job there and blocks on the reply."""

    def __init__(
        self,
        cfg: RefitConfig = RefitConfig(),
        *,
        clock: Callable[[], float] = time.monotonic,
        tracer: "TraceRecorder | None" = None,
        synchronous: bool = False,
    ):
        resolve_device(cfg.device)
        self.cfg = cfg
        self.clock = clock
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.synchronous = synchronous
        self._lock = threading.Lock()
        self._queue: "queue_mod.Queue[_Job | None]" = queue_mod.Queue()
        self._inflight: dict[str, _Job] = {}
        self._last_accept: dict[str, float] = {}
        self._counts: dict[str, int] = {}
        self.completed = 0
        self.discarded = 0
        # kernel launches the child's searches made, by kernel name
        self.remote_launches: dict[str, int] = {}
        self._child: "RefitProcess | None" = None
        self._thread: "threading.Thread | None" = None
        self._stop = threading.Event()

    # -- submission ----------------------------------------------------
    def request(
        self,
        tenant: str,
        live: ServableCircuit,
        buffer: ReplayBuffer,
        on_done: Callable[[RefitResult], None],
    ) -> bool:
        """Schedule a background refit.  Returns False when rejected
        (rate limit / already in flight / thin replay buffer)."""
        now = self.clock()
        with self._lock:
            if tenant in self._inflight:
                return False
            last = self._last_accept.get(tenant)
            if (last is not None
                    and now - last < self.cfg.min_interval_s):
                return False
            if len(buffer) < self.cfg.min_replay_rows:
                return False
            idx = self._counts.get(tenant, 0)
            self._counts[tenant] = idx + 1
            self._last_accept[tenant] = now
            job = _Job(tenant, live, buffer, on_done, idx)
            self._inflight[tenant] = job
        self.tracer.instant(
            "evolution.refit_scheduled", cat="evolution", track="evolution",
            tenant=tenant, refit_index=idx, replay_rows=len(buffer),
        )
        if self.synchronous:
            self._run_job(job)
            return True
        try:
            self.start()
        except BaseException:
            with self._lock:
                del self._inflight[tenant]
            raise
        self._queue.put(job)
        return True

    def cancel(self, tenant: str) -> bool:
        """Cancel the tenant's in-flight job (queued → dropped, running
        → result discarded on delivery).  Returns whether one existed."""
        with self._lock:
            job = self._inflight.get(tenant)
            if job is None:
                return False
            job.cancelled.set()
        return True

    def busy(self, tenant: "str | None" = None) -> bool:
        with self._lock:
            return (bool(self._inflight) if tenant is None
                    else tenant in self._inflight)

    # -- execution -----------------------------------------------------
    def _run_job(self, job: _Job) -> None:
        try:
            if job.cancelled.is_set():
                return
            x, y = job.buffer.snapshot()
            with self.tracer.span(
                "evolution.refit", cat="evolution", track="evolution",
                tenant=job.tenant, rows=int(x.shape[0]),
            ):
                if self.synchronous:
                    result = refit_circuit(
                        job.tenant, job.live, x, y, self.cfg,
                        refit_index=job.refit_index,
                    )
                else:
                    result = self._remote_refit(job, x, y)
            if job.cancelled.is_set():
                with self._lock:
                    self.discarded += 1
                return
            with self._lock:
                self.completed += 1
            job.on_done(result)
        finally:
            with self._lock:
                if self._inflight.get(job.tenant) is job:
                    del self._inflight[job.tenant]

    def _remote_refit(self, job: _Job, x, y) -> RefitResult:
        """The job's search in the child process (the wait releases the
        interpreter lock); its launches join ``remote_launches``."""
        with self._lock:
            child = self._child
        if child is None or not child.alive():
            code = None if child is None else child.proc.poll()
            raise RefitProcessError(
                f"the refit process is not running (exit code {code})")
        result, launches = child.refit(job.tenant, job.live, x, y, self.cfg,
                                       job.refit_index)
        with self._lock:
            for name, n in launches.items():
                self.remote_launches[name] = self.remote_launches.get(name, 0) + n
        return result

    def _run(self) -> None:
        while not self._stop.is_set():
            job = self._queue.get()
            if job is None:
                break
            try:
                self._run_job(job)
            except Exception:  # noqa: BLE001 — a failed search must not
                # kill the worker thread; the tenant just keeps serving
                # its live circuit and the detector stays tripped
                import traceback
                import warnings
                warnings.warn(
                    f"background refit for {job.tenant!r} failed:\n"
                    f"{traceback.format_exc()}",
                    RuntimeWarning, stacklevel=1,
                )

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "RefitWorker":
        """Start the child process (unless one is running: a dead child is
        replaced) and the worker thread.  Returns once the child is
        ready; raises `RefitProcessError` when it cannot start."""
        with self._lock:
            child = self._child
        if child is None or not child.alive():
            if child is not None:
                child.close(timeout=1.0)
            child = RefitProcess(self.cfg.device)
            with self._lock:
                self._child = child
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="circuit-refit-worker", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        with self._lock:
            child, self._child = self._child, None
        if child is not None:
            child.close(timeout)

    def join(self, timeout: float = 60.0) -> bool:
        """Block until no job is in flight (tests/benchmarks)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    return True
            time.sleep(0.005)
        return False
