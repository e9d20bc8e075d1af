"""Circuit serving under an open loop: requests arrive at a fixed rate to
`AsyncCircuitServer.enqueue`, with its scheduler thread running, whether or
not the server keeps up.

Each seed gets the same requests: the same multiset of gaps between arrivals
(exponential, at stratified quantiles, so that they sum to the window), of
row counts (lognormal, at stratified quantiles, clipped) and of tenants (in
Zipf proportions), in an order and at table offsets drawn from the seed.  A
request is timed from when it was due to when its future resolved; one that
is rejected, shed or fails counts as failed and misses every limit.  After
the window every answer that came is compared, row by row, with the
reference's.
"""
from __future__ import annotations

import math
import statistics
import time
from concurrent.futures import wait

import numpy as np

from perfbench import devtrace, work
from perfbench.drivers import common
from perfbench.harness import Run
from perfbench.reference import circuits as ref

STREAM_TENANTS, STREAM_WINDOW, STREAM_WARM = 11, 12, 13


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    nd = statistics.NormalDist()
    return np.array([nd.inv_cdf(float(q)) for q in p])


def schedule(tr: dict, rate: float, seconds: float, r: np.random.RandomState,
             table_rows: int) -> dict:
    """The requests of a window of ``seconds`` at ``rate`` a second: due
    times, tenants, row counts and table offsets, in due order."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q)
    gaps = r.permutation(gaps * (seconds / gaps.sum()))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    size = np.exp(np.log(tr["rows_median"]) + tr["rows_sigma"] * _norm_ppf(q))
    size = r.permutation(np.clip(np.rint(size), tr["rows_min"], tr["rows_max"]).astype(np.int64))
    k = tr["tenants"]
    share = 1.0 / np.arange(1, k + 1) ** tr["zipf_s"]
    share = share / share.sum() * n
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(-(share - counts))[: n - counts.sum()]] += 1
    tenant = r.permutation(np.repeat(np.arange(k), counts))
    size = np.minimum(size, table_rows)
    offset = (r.rand(n) * (table_rows - size + 1)).astype(np.int64)
    return {"due": due, "tenant": tenant, "rows": size, "offset": offset}


class _Window:
    """Offers a schedule to the front end on the host clock and records
    when each request was due, was offered, and resolved."""

    def __init__(self, fe, names, x, sched, deadline_s: float):
        self.fe, self.names, self.x, self.s = fe, names, x, sched
        n = len(sched["due"])
        self.deadline_s = deadline_s
        self.due = np.zeros(n)
        self.offered = np.zeros(n)
        self.done = np.full(n, np.nan)
        self.futures = [None] * n
        self.rejected = 0

    def _resolved(self, i: int) -> None:
        self.done[i] = time.monotonic()

    def offer_all(self) -> None:
        """Offer every request at its due time."""
        from repro_torch.serve.async_frontend import AdmissionError
        s = self.s
        t0 = time.monotonic()
        for i in range(len(s["due"])):
            due = t0 + s["due"][i]
            lag = due - time.monotonic()
            if lag > 0:
                time.sleep(lag)
            self.due[i] = due
            self.offered[i] = time.monotonic()
            lo = s["offset"][i]
            try:
                fut = self.fe.enqueue(self.names[s["tenant"][i]], self.x[lo:lo + s["rows"][i]],
                                      deadline=due + self.deadline_s)
            except AdmissionError:
                self.rejected += 1
                self.done[i] = self.offered[i]
                continue
            self.futures[i] = fut
            fut.add_done_callback(lambda _, i=i: self._resolved(i))

    def settle(self, timeout: float) -> None:
        wait([f for f in self.futures if f is not None], timeout=timeout)


def run(ctx) -> Run:
    import torch

    from repro_torch.serve.async_frontend import AsyncCircuitServer, DeadlineExceededError
    from repro_torch.serve.circuits import CircuitRegistry, CircuitServer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    rate = float(tr["rate_per_s"])
    x, _ = common.table(ctx)
    rows = x.shape[0]
    enc = common.encoding(cfg)
    edges = ref.quantile_edges(x, enc["bits"])
    n_in = edges.shape[0] * enc["bits"]
    r = common.rng(ctx, STREAM_TENANTS)
    genomes = [common.seeded_genome(r, n_in, cfg) for _ in range(tr["tenants"])]
    names = [f"tenant{t}" for t in range(tr["tenants"])]
    registry = CircuitRegistry()
    for name, g in zip(names, genomes):
        registry.add(name, common.servable(g, edges, cfg))
    server = CircuitServer(registry, device=ctx.device)
    reports = []
    tick = server.tick

    def recorded_tick():
        report = tick()
        reports.append(report)
        return report

    server.tick = recorded_tick  # each front-end fire is one tick
    fe = AsyncCircuitServer(server)
    deadline_s = tr["deadline_ms"] / 1e3

    fe.start()
    try:
        # every span bucket a request can make: up to rows_max rows a tenant
        spans = [1 << i for i in range(work.n_words(tr["rows_max"]).bit_length())]
        server.prewarm_plan(server.plan(), spans=spans)
        warm = _Window(fe, names, x, schedule(tr, rate, tr["warmup_s"],
                                              common.rng(ctx, STREAM_WARM), rows), deadline_s)
        warm.offer_all()
        warm.settle(tr["wait_after_s"])
        if ctx.device == "cuda":
            torch.cuda.synchronize()

        win = _Window(fe, names, x, schedule(tr, rate, ctx.seconds,
                                             common.rng(ctx, STREAM_WINDOW), rows), deadline_s)
        phases0 = dict(server.stats.phase_totals)
        n_reports = len(reports)
        setup_s = time.perf_counter() - ctx.t_start
        with devtrace.Profile(ctx.trace) as prof:
            win.offer_all()
            win.settle(tr["wait_after_s"])
        window_s = ctx.seconds
        lateness = win.offered - win.due
    finally:
        fe.stop()
    ticks = [rep for rep in reports[n_reports:] if not rep.empty]

    out = Run(setup_s=setup_s, window_s=window_s, attempted=len(win.due),
              kernel="eval_program_spans_kernel", trace=prof.trace,
              device=common.device_record(ctx.device))
    served, shed, errors, unanswered = [], 0, 0, 0
    lat = win.done - win.due
    for i, fut in enumerate(win.futures):
        if fut is None:
            lat[i] = math.inf  # rejected at the door
        elif not fut.done():
            unanswered += 1
            lat[i] = math.inf
        elif fut.exception() is not None:
            shed += isinstance(fut.exception(), DeadlineExceededError)
            errors += not isinstance(fut.exception(), DeadlineExceededError)
            lat[i] = math.inf
        else:
            served.append(i)
    out.failed = win.rejected + shed + errors + unanswered
    out.latencies_s = lat.tolist()
    out.counters = {"requests": len(win.due), "served": len(served), "rejected": win.rejected,
                    "shed": shed, "errors": errors, "ticks": len(ticks),
                    "rows": sum(rep.rows for rep in ticks),
                    "late_p50_ms": float(np.median(lateness)) * 1e3,
                    "late_max_ms": float(lateness.max()) * 1e3}
    out.phases = {k: v - phases0.get(k, 0.0) for k, v in server.stats.phase_totals.items()}
    if prof.trace is not None:
        tenant_work = {name: common.live(cfg, g, n_in) for name, g in zip(names, genomes)}
        n_out = common.n_outputs(cfg)
        for rep in ticks:
            slots = [(tenant_work[t][0], len(tenant_work[t][1]), work.n_words(n))
                     for t, n in rep.tenant_rows]
            nbytes, ops = work.spans_work(slots, n_out)
            out.launch_bounds_s.append(work.bound_s(nbytes, ops))
            out.ops += ops
    del server, fe, registry
    out.checks = check(cfg, x, edges, genomes, win, served, unanswered)
    out.control = lambda: check(cfg, x, edges, genomes, win, served, unanswered, "bfloat16")
    return out


def check(cfg, x, edges, genomes, win, served, unanswered: int,
          encode_dtype: str = "float32") -> dict:
    """Every served request's ids against the reference's for its rows,
    and the requests whose future never resolved.  ``encode_dtype=
    "bfloat16"`` puts the reference, encoding in bfloat16, in the program's
    place: the control."""
    enc = common.encoding(cfg)
    rows = x.shape[0]
    x_words = ref.pack(ref.encode(x, edges, enc["bits"]))
    want = [common.reference_ids(cfg, g, x_words, rows) for g in genomes]
    if encode_dtype != "float32":
        low = ref.pack(ref.encode(x, edges, enc["bits"], encode_dtype))
        got_all = [common.reference_ids(cfg, g, low, rows) for g in genomes]
    s = win.s
    wrong = 0
    for i in served:
        t, lo, n = s["tenant"][i], s["offset"][i], s["rows"][i]
        got = (got_all[t][lo:lo + n] if encode_dtype != "float32"
               else np.asarray(win.futures[i].result()))
        wrong += int(np.count_nonzero(got != want[t][lo:lo + n])) if got.shape == (n,) else n
    return {"wrong_rows": common.check(wrong, 0), "unanswered": common.check(unanswered, 0)}
