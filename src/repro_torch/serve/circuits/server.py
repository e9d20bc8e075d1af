"""Micro-batching inference engine over compiled launch plans.

Request flow (one `tick()`):

  1. snapshot every tenant's pending float-feature rows;
  2. refresh the compiled plan (the `PlanCompiler` recompiles only when
     the registry generation moved; each shard's live-gate program is
     compiled and uploaded once, cached by shard content hash, so an
     unchanged shard never re-uploads);
  3. per tenant, run the encode→bit-pack pipeline once per ensemble
     member over all its pending requests (host numpy);
  4. fuse each plan shard's work into its own padded
     ``u32[I_max, S·span]`` word buffer — slot k owns the word span
     ``[k·span, (k+1)·span)`` — copy it and one small int32 buffer of
     launch slots, offsets and live flags to the shard's device and
     enqueue **one fused `eval_population_spans` launch per shard**, with
     the slot gather inside the kernel (all launches are enqueued before
     any output is read back);
  5. read back, decode each member's live output bits to class ids,
     majority-vote ensemble members, and scatter results to the
     originating requests.

On ``device="cuda"`` every launch is the hand-written spans kernel; a
kernel that fails to build or launch fails the tick.  Shard ``s`` runs on
``cuda:{s % torch.cuda.device_count()}`` (all on ``cuda:0`` with one
card).  ``device="cpu"`` runs the plain version, only when asked for.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import encoding as E
from repro_torch.core.api import decode_predictions
from repro_torch.kernels.program import compile_program
from repro_torch.serve.circuits.metrics import TICK_PHASES, ServerStats, TickReport
from repro_torch.serve.circuits.registry import CircuitRegistry
from repro_torch.serve.observability.trace import NULL_TRACER, TraceRecorder
from repro_torch.serve.planning import (
    DEFAULT_POLICY,
    CompiledPlan,
    PlacementPolicy,
    PlanCompiler,
    ensemble_vote,
)


@dataclasses.dataclass
class _Pending:
    ticket: int
    x: np.ndarray  # float32[r, F_tenant]


class CircuitServer:
    """Synchronous micro-batching server over a `CircuitRegistry`.

    ``submit()`` enqueues rows and returns a ticket; ``tick()`` serves every
    pending row in one fused launch per plan shard; ``result()`` collects
    predictions.  ``device=None`` serves on the card (and raises without
    one); ``device="cpu"`` serves through the plain versions.  ``policy``
    is the declarative placement: shard count, slot assignment, and span
    alignment.  ``stable_shapes`` pads every launch to its shard's full
    slot count (idle slots masked off with ``in_width=0``), so a launch's
    shape depends only on the span bucket and the plan.
    """

    def __init__(
        self,
        registry: CircuitRegistry,
        *,
        device: "str | torch.device | None" = None,
        policy: PlacementPolicy = DEFAULT_POLICY,
        stable_shapes: bool = True,
        tracer: TraceRecorder | None = None,
    ):
        self.registry = registry
        self.device = runtime.resolve_device(device)
        self.backend = runtime.backend_for(self.device)
        self.policy = policy
        self.compiler = PlanCompiler(self.backend, policy)
        self.span_align = self.compiler.span_align
        self.stable_shapes = bool(stable_shapes)
        self.tracer = NULL_TRACER if tracer is None else tracer
        # launches dispatch through the instrumented proxy so each
        # kernel-level eval carries its own trace span
        self._exec = self.backend.instrument(self._launch_span)
        self.stats = ServerStats(backend=self.backend.name)
        self._lock = threading.Lock()
        # serializes whole launches: a step() must observe its own tick
        # serving its tickets (RLock: step's tick nests inside)
        self._serve_lock = threading.RLock()
        self._pending: dict[str, list[_Pending]] = {}
        self._results: dict[int, "np.ndarray | Exception"] = {}
        self._next_ticket = 0
        # compiled-plan cache (generation-tagged) + each shard's live-gate
        # program and input widths on its device, keyed by content hash
        self._plan_lock = threading.Lock()
        self._compiled: CompiledPlan | None = None
        self._dev: dict[str, tuple] = {}

    def _launch_span(self, kind: str, **meta):
        """Launch hook handed to `EvalBackend.instrument` — one trace span
        per kernel-level eval call (no-op while tracing is off)."""
        return self.tracer.span(f"backend.{kind}", cat="kernel", **meta)

    def device_for(self, shard: int) -> torch.device:
        """The device shard ``shard`` launches on."""
        if self.device.type == "cuda" and self.device.index is None:
            return torch.device("cuda", shard % torch.cuda.device_count())
        return self.device

    # -- request interface ---------------------------------------------
    def submit(self, tenant: str, x: np.ndarray) -> int:
        """Enqueue rows for one tenant; returns a result ticket."""
        if tenant not in self.registry:
            raise KeyError(f"unknown tenant {tenant!r}")
        x = np.atleast_2d(np.asarray(x, np.float32))
        want = self.registry.get(tenant).encoder.n_features
        if x.shape[1] != want:
            raise ValueError(
                f"tenant {tenant!r} expects {want} features, got {x.shape[1]}"
            )
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending.setdefault(tenant, []).append(_Pending(ticket, x))
        return ticket

    def result(self, ticket: int) -> np.ndarray:
        """Class ids for a served ticket (KeyError if not yet ticked).

        Re-raises per-request serving errors (e.g. the tenant was removed
        or hot-swapped incompatibly between submit and tick)."""
        out = self._results.pop(ticket)
        if isinstance(out, Exception):
            raise out
        return out

    def predict(self, tenant: str, x: np.ndarray) -> np.ndarray:
        """submit + tick + result in one call (single-tenant convenience)."""
        ticket = self.submit(tenant, x)
        self.tick()
        return self.result(ticket)

    def step(
        self, work: "list[tuple[str, np.ndarray]]"
    ) -> "list[np.ndarray | Exception]":
        """Single-launch hook for external schedulers.

        Submits the given ``(tenant, rows)`` work items, runs exactly one
        fused tick, and returns each item's class ids — or its per-request
        serving error (bad tenant, hot remove, width mismatch) as an
        Exception instance instead of raising — in input order.  Atomic
        against concurrent `tick()`/`predict()` on the same server."""
        with self._serve_lock:
            tickets: list = []
            for tenant, x in work:
                try:
                    tickets.append(self.submit(tenant, x))
                except (KeyError, ValueError) as err:  # per-item isolation
                    tickets.append(err)
            self.tick()
            out = []
            for t in tickets:
                if not isinstance(t, Exception):
                    t = self._results.pop(t)
                out.append(t)
            return out

    # -- the compiled plan ---------------------------------------------
    def _refresh_plan(self) -> tuple[CompiledPlan, dict]:
        """Compiled plan for the current registry generation plus its
        device-side programs, as one consistent snapshot (a
        concurrent recompile cannot pull tensors out from under a tick in
        flight).  Uploads are cached by shard content hash, so hot-swapping
        one tenant re-uploads only the shards it changed.  The fast path is
        one int comparison."""
        with self._plan_lock:
            if (self._compiled is not None
                    and self._compiled.generation == self.registry.generation):
                return self._compiled, self._dev
            cat = self.registry.catalog()
            # incremental once a plan exists: unchanged tenants keep their
            # shard and slot order, so only touched shards change hash
            compiled = self.compiler.recompile(cat, self._compiled)
            dev = {
                shard.content_hash: (
                    self._dev.get(shard.content_hash)
                    or self._upload_shard(shard)
                )
                for shard in compiled.shards
            }
            self._compiled = compiled
            self._dev = dev  # stale shard tensors are dropped here
            return compiled, dev

    def _upload_shard(self, shard) -> tuple:
        """A shard's resident launch inputs on its device: the live-gate
        program of its slots and their input widths."""
        device = self.device_for(shard.shard)
        program = compile_program(shard.opcodes, shard.edge_src,
                                  shard.out_src, shard.n_inputs_max)
        in_width = torch.tensor(shard.in_width, dtype=torch.int32, device=device)
        return program.to(device), in_width

    def plan(self) -> CompiledPlan:
        """The current compiled plan (compiling if stale) — inspectable:
        shards, placement, content hashes, span alignment."""
        return self._refresh_plan()[0]

    def span_bucket(self, words: int) -> int:
        """The launch span for ``words`` words: the next power of two, then
        padded to the plan's span alignment (a bounded set of shapes)."""
        span = 1 << (max(int(words), 1) - 1).bit_length()
        return -(-span // self.span_align) * self.span_align

    # -- the fused tick ------------------------------------------------
    def tick(self) -> TickReport:
        """Serve every pending request in one launch per active shard."""
        with self._serve_lock:
            perf = time.perf_counter
            t0 = perf()
            phase = dict.fromkeys(TICK_PHASES, 0.0)
            # snapshot pending BEFORE the plan: a tenant that reached the
            # queue was registered at submit time, so the refreshed plan
            # can only miss it if a concurrent remove won
            with self._lock:
                batch = [(t, r) for t, r in self._pending.items() if r]
                self._pending = {}
            self.tracer.begin("tick", cat="tick")
            try:
                report = self._tick(t0, perf, phase, batch)
            finally:
                self.tracer.end("tick", cat="tick")
            self.stats.record(report)
            return report

    def _tick(self, t0, perf, phase, batch) -> TickReport:
        tracer = self.tracer
        plan, dev = self._refresh_plan()

        # Encode each tenant's pending rows once per ensemble member.
        entries = []
        shard_work: dict[int, list] = {}  # shard → [(slot, packed, entry, m)]
        n_requests = 0
        for tenant, reqs in batch:
            n_requests += len(reqs)
            refs = plan.placement.get(tenant)
            # removed, or hot-swapped to another feature width, between
            # submit and tick: fail those requests individually
            members = plan.members(tenant) if refs else ()
            if not refs or any(
                p.x.shape[1] != members[0].encoder.n_features for p in reqs
            ):
                why = ("removed" if not refs
                       else "hot-swapped to a different feature width")
                err = KeyError(
                    f"tenant {tenant!r} was {why} with requests pending"
                )
                for p in reqs:
                    self._results[p.ticket] = err
                continue
            xs = [p.x for p in reqs]
            n_rows = sum(x.shape[0] for x in xs)
            if n_rows == 0:  # zero-row requests complete immediately
                for p in reqs:
                    self._results[p.ticket] = np.zeros(0, np.int64)
                continue
            entry = {
                "tenant": tenant, "reqs": reqs, "rows": n_rows,
                "offsets": None, "n_classes": int(members[0].n_classes),
                "member_ids": [None] * len(refs),
            }
            w_t = E.n_words(n_rows)
            with tracer.span("tick.encode_pack", cat="tick",
                             tenant=tenant, rows=n_rows):
                for m, (ref, sc) in enumerate(zip(refs, members)):
                    t1 = perf()
                    bits, offsets = E.encode_batched(sc.encoder, xs)
                    t2 = perf()
                    entry["offsets"] = offsets
                    packed = E.pack_bits_rows(bits, w_t)
                    phase["encode"] += t2 - t1
                    phase["pack"] += perf() - t2
                    shard_work.setdefault(ref.shard, []).append(
                        (ref.slot, packed, entry, m)
                    )
            entries.append(entry)

        if not shard_work:
            return TickReport(
                generation=plan.generation, tenants=0, requests=n_requests,
                rows=0, launches=0, span_words=0,
                latency_s=perf() - t0, occupancy=0.0,
                plan_shards=plan.n_shards, phase_s=phase,
            )

        # Fuse per shard: slot k owns words [k*span, (k+1)*span).  Pad slots
        # run slot 0's program with live = 0, so their inputs are fully
        # masked and their outputs never read.  Each shard is one kernel
        # launch (the slot gather is inside it), and every shard's launch
        # is enqueued before any output is read back.
        launches = []  # (shard_idx, span, items, out tensor)
        max_span = 0
        pad_cells = 0
        shard_stats = []  # per launch: (shard, slot-rows, padded bit-lanes)
        for shard_idx in sorted(shard_work):
            shard = plan.shards[shard_idx]
            items = shard_work[shard_idx]
            span = self.span_bucket(max(E.n_words(e["rows"]) for _, _, e, _ in items))
            k_active = len(items)
            k_pad = shard.n_slots if self.stable_shapes else k_active
            t1 = perf()
            x_buf = np.zeros((shard.n_inputs_max, k_pad * span), np.uint32)
            for k, (_, packed, _, _) in enumerate(items):
                x_buf[: packed.shape[0],
                      k * span: k * span + packed.shape[1]] = packed
            # launch slot k: its plan slot, word offset and live flag, one
            # buffer; pad slots run slot 0 with live = 0 (inputs masked)
            meta = np.zeros((3, k_pad), np.int32)
            meta[0, :k_active] = [it[0] for it in items]
            meta[1] = np.arange(k_pad) * span
            meta[2, :k_active] = 1
            program, in_w = dev[shard.content_hash]
            device = self.device_for(shard_idx)
            phase["pack"] += perf() - t1  # fused-buffer fill
            t1 = perf()
            with tracer.span("tick.device_put", cat="tick", shard=shard_idx):
                x_dev = torch.from_numpy(x_buf.view(np.int32)).to(device)
                meta_dev = torch.from_numpy(meta).to(device)
            t2 = perf()
            with tracer.span("tick.launch", cat="tick", shard=shard_idx,
                             span_words=span, slots=k_active):
                out = self._exec.eval_program_spans(
                    program, x_dev, meta_dev[0], meta_dev[1], in_w,
                    meta_dev[2], span_words=span,
                )
            phase["device_put"] += t2 - t1
            phase["launch"] += perf() - t2
            launches.append((shard_idx, span, items, out))
            max_span = max(max_span, span)
            pad_cells += k_pad * span
            shard_stats.append((
                shard_idx,
                sum(it[2]["rows"] for it in items),
                k_pad * span * E.WORD,
            ))

        # Read back and decode: member class ids first, then the vote.
        for shard_idx, span, items, out in launches:
            shard = plan.shards[shard_idx]
            t1 = perf()
            with tracer.span("tick.readback", cat="tick", shard=shard_idx):
                words = out.cpu().numpy().view(np.uint32)  # [K_pad, O_max, span]
            t2 = perf()
            for k, (slot, _, entry, m) in enumerate(items):
                o_t = int(shard.out_width[slot])
                entry["member_ids"][m] = decode_predictions(
                    words[k, :o_t], entry["rows"], entry["n_classes"]
                )
            phase["readback"] += t2 - t1
            phase["decode"] += perf() - t2

        t1 = perf()
        with tracer.span("tick.decode", cat="tick"):
            for entry in entries:
                ids = ensemble_vote(
                    np.stack(entry["member_ids"]), entry["n_classes"]
                )
                offsets = entry["offsets"]
                for p, lo, hi in zip(entry["reqs"], offsets[:-1], offsets[1:]):
                    self._results[p.ticket] = ids[lo:hi]
        phase["decode"] += perf() - t1

        total_rows = sum(e["rows"] for e in entries)
        tracer.counter("tick.rows", total_rows, cat="tick")
        return TickReport(
            generation=plan.generation,
            tenants=len(entries),
            requests=n_requests,
            rows=total_rows,
            launches=len(launches),
            span_words=max_span,
            latency_s=perf() - t0,
            occupancy=total_rows / (pad_cells * E.WORD),
            plan_shards=plan.n_shards,
            max_slots_per_launch=max(len(items) for _, _, items, _ in launches),
            shard_stats=tuple(shard_stats),
            tenant_rows=tuple((e["tenant"], e["rows"]) for e in entries),
            phase_s=phase,
        )
