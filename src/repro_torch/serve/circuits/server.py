"""Micro-batching inference engine over compiled launch plans.

Request flow (one `tick()`):

  1. snapshot every tenant's pending float-feature rows;
  2. refresh the compiled plan (the `PlanCompiler` recompiles only when
     the registry generation moved; a shard's device state is cached by
     its content hash, so an unchanged shard is never rebuilt);
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
     majority-vote ensemble members (shadow members aside), and scatter
     results to the originating requests.

On ``device="cuda"`` every launch goes through a span-launch unit
(`runtime/aot.py` `SpanLaunch`, one per shard content hash, span bucket
and device): the shard's live-gate program resident on the card and the
launch resolved once, so a tick's launch checks only its words and
launch slots and calls the hand-written spans kernel.  A unit that cannot
be built fails the tick; nothing drops to the plain version.  Units are
compiled at a shard's first launch, made ahead of a plan swap by
`prewarm_plan`/`swap_plan`, and stored and loaded through an
`ArtifactStore` (`export_executables`, `preload_executables`), so a cold
process boots without compiling a program.  Shard ``s`` runs on
``cuda:{s % torch.cuda.device_count()}`` (all on ``cuda:0`` with one
card).  ``device="cpu"`` runs the plain version, only when asked for,
eagerly (the reference's ``"ref"`` backend makes no executables either).
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import encoding as E
from repro_torch.core.api import decode_predictions
from repro_torch.kernels.program import compile_program
from repro_torch.runtime import aot
from repro_torch.serve.circuits.metrics import (
    TICK_PHASES,
    RebalanceEvent,
    ServerStats,
    TickReport,
)
from repro_torch.serve.circuits.registry import CircuitRegistry
from repro_torch.serve.observability.trace import NULL_TRACER, TraceRecorder
from repro_torch.serve.planning import (
    DEFAULT_POLICY,
    CompiledPlan,
    PlacementPolicy,
    PlanCompiler,
    ensemble_vote,
)
from repro_torch.sharding.specs import population_mesh

_log = logging.getLogger("repro_torch.serve.aot")


class StalePlanError(RuntimeError):
    """A plan offered to `CircuitServer.swap_plan` was compiled from a
    catalog generation the registry has since moved past — the caller
    must re-snapshot the catalog and recompile."""


@dataclasses.dataclass
class _Pending:
    ticket: int
    x: np.ndarray  # float32[r, F_tenant]


def _bucket(words: int, span_align: int) -> int:
    span = 1 << (max(int(words), 1) - 1).bit_length()
    return -(-span // span_align) * span_align


def _summary() -> dict:
    return {"loaded": 0, "compiled": 0, "trace_warmed": 0,
            "exec_warmed": 0, "load_failures": 0, "skipped": 0}


class CircuitServer:
    """Synchronous micro-batching server over a `CircuitRegistry`.

    ``submit()`` enqueues rows and returns a ticket; ``tick()`` serves every
    pending row in one fused launch per plan shard; ``result()`` collects
    predictions.  ``device=None`` serves on the card (and raises without
    one); ``device="cpu"`` serves through the plain versions.  ``policy``
    is the declarative placement: shard count, slot assignment, and span
    alignment.  ``stable_shapes`` pads every launch to its shard's full
    slot count (idle slots masked off with ``in_width=0``), so a launch's
    shape depends only on the span bucket and the plan — what lets a
    span-launch unit serve every tick of its shard.
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
        # shadow slots: tenant → (expected member count, trailing shadow
        # count).  When a tenant's launched member count matches the
        # expectation, the trailing members are excluded from the decode
        # vote and handed to `shadow_hook` instead — how a candidate
        # scores against live traffic inside the fused launch without
        # touching served output.  Keying on the expected count makes the
        # exclusion race-free across the registry mutation that installs
        # or removes the shadow member: a stale plan votes normally.
        self._shadow: dict[str, tuple[int, int]] = {}
        self.shadow_hook: "Callable | None" = None
        # compiled-plan cache (generation-tagged) + each shard's device
        # state (`_upload_shard`), keyed by content hash
        self._plan_lock = threading.Lock()
        self._compiled: CompiledPlan | None = None
        self._dev: dict[str, tuple] = {}
        # -- span-launch units ----------------------------------------
        # keyed by (shard content hash, span bucket, device index);
        # compiled at a shard's first launch, by prewarm_plan, or loaded
        # by preload_executables.  Only with stable shapes: a unit's
        # launch shape must be a pure function of (shard, span bucket).
        self._aot_lock = threading.Lock()
        self._aot: dict[tuple[str, int, int], aot.SpanLaunch] = {}
        # device state staged by prewarm_plan, consumed (and counted as
        # rebuilt) by the next swap_plan fence
        self._staged_dev: dict[str, tuple] = {}
        # launch-shape signatures eager launches already ran (no-AOT
        # backend): a repeat prewarm of the same shapes is a no-op
        self._warm_shapes: set[tuple] = set()
        self._spans_seen: set[int] = set()   # span buckets ticks produced
        self._aot_capable = bool(
            self.backend.capabilities().supports_aot
        ) and self.stable_shapes
        self.aot_stats = {
            "exec_hits": 0, "compiles": 0, "loads": 0,
            "load_failures": 0, "trace_warms": 0, "exec_warms": 0,
        }

    def _launch_span(self, kind: str, **meta):
        """Launch hook handed to `EvalBackend.instrument` — one trace span
        per kernel-level eval call (no-op while tracing is off)."""
        return self.tracer.span(f"backend.{kind}", cat="kernel", **meta)

    def device_for(self, shard: int) -> torch.device:
        """The device shard ``shard`` launches on (`population_mesh`)."""
        devices = population_mesh(shard + 1, self.device)
        return devices[shard % len(devices)]

    def reset_stats(self) -> None:
        """Fresh stats window (keeps the resolved backend tag)."""
        self.stats = ServerStats(backend=self.backend.name)

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

    def pending_rows(self) -> int:
        with self._lock:
            return sum(
                p.x.shape[0] for reqs in self._pending.values() for p in reqs
            )

    # -- the compiled plan ---------------------------------------------
    def _refresh_plan(self) -> tuple[CompiledPlan, dict]:
        """Compiled plan for the current registry generation plus its
        shards' device state, as one consistent snapshot: a concurrent
        recompile or plan swap replaces the dict and never mutates it, so
        it cannot pull state out from under a tick in flight.  Device
        state is cached by shard content hash, so hot-swapping one tenant
        rebuilds only the shards it changed.  The fast path is one int
        comparison; the snapshot is taken inside the plan lock so two
        racing refreshes cannot install an older catalog's plan over a
        newer one."""
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
                    or self._staged_dev.pop(shard.content_hash, None)
                    or self._upload_shard(shard)
                )
                for shard in compiled.shards
            }
            self._compiled = compiled
            self._dev = dev  # stale shard state is dropped here
            return compiled, dev

    def _upload_shard(self, shard) -> tuple:
        """What a shard's launches read on its device.  Eager launches: its
        live-gate program and input widths, compiled and copied here.  With
        span-launch units the unit holds them (compiled or loaded at its
        first launch, at prewarm or at preload), so a plan swap compiles
        nothing under its fence: the entry is only the shard's device."""
        device = self.device_for(shard.shard)
        if self._aot_capable:
            return (device,)
        program = compile_program(shard.opcodes, shard.edge_src,
                                  shard.out_src, shard.n_inputs_max)
        in_width = torch.tensor(shard.in_width, dtype=torch.int32, device=device)
        return program.to(device), in_width

    def plan(self) -> CompiledPlan:
        """The current compiled plan (compiling if stale) — inspectable:
        shards, placement, content hashes, span alignment."""
        return self._refresh_plan()[0]

    def peek_plan(self) -> CompiledPlan | None:
        """The last installed plan without compiling — possibly stale,
        possibly None on a never-ticked server.  What a caller feeds
        `PlanCompiler.recompile` as the stickiness hint: a stale previous
        plan only costs placement quality, never correctness."""
        with self._plan_lock:
            return self._compiled

    def shard_of(self, tenant: str) -> int:
        """Home shard of a tenant under the current compiled plan."""
        return self.plan().shard_of(tenant)

    def span_bucket(self, words: int) -> int:
        """The launch span for ``words`` words: the next power of two, then
        padded to the plan's span alignment (a bounded set of shapes) —
        the quantization `tick()` applies, so prewarm, export and the live
        launch agree on shapes."""
        return _bucket(words, self.span_align)

    def spans_seen(self) -> tuple[int, ...]:
        """Span buckets ticks have actually launched (ascending) — the
        shapes worth prewarming or exporting."""
        return tuple(sorted(self._spans_seen))

    # -- span-launch units ------------------------------------------------
    @staticmethod
    def _dev_key(device: torch.device) -> int:
        return -1 if device.index is None else int(device.index)

    def _build_unit(self, shard, span: int, device) -> aot.SpanLaunch:
        """A new unit for (shard, span) on ``device``: another span bucket
        of a unit the shard already has there (its program is reused, not
        compiled again), else the shard compiled by the backend."""
        key = (shard.content_hash, self._dev_key(device))
        with self._aot_lock:
            sibling = next((u for (h, _, d), u in self._aot.items()
                            if (h, d) == key), None)
        if sibling is not None:
            return sibling.respan(span)
        return self.backend.compile_spans(aot.shard_spec(shard, span), shard,
                                          device=device)

    def _span_launch(self, shard, span: int, device) -> aot.SpanLaunch:
        """The unit a tick launches: a cache hit, or built and cached."""
        key = (shard.content_hash, int(span), self._dev_key(device))
        with self._aot_lock:
            fn = self._aot.get(key)
            if fn is not None:
                self.aot_stats["exec_hits"] += 1
                return fn
        fn = self._build_unit(shard, span, device)
        with self._aot_lock:
            self.aot_stats["compiles"] += 1
            return self._aot.setdefault(key, fn)

    def _load_unit(self, shard, span: int, device, store, summary: dict):
        """The stored unit for (shard, span) on ``device``, or None when
        the store has none or it cannot be used (the reason is logged and
        counted; the caller compiles the shard instead, which runs the
        same kernel)."""
        kstr = aot.executable_key(self.backend.name, shard.content_hash, span)
        try:
            fn = aot.deserialize_executable(store.get_executable(kstr), device=device)
            if fn.spec != aot.shard_spec(shard, span):
                raise ValueError(f"spec {tuple(fn.spec)} is not the shard's")
        except KeyError:
            return None  # not exported for this shape
        except (OSError, ValueError) as err:
            summary["load_failures"] += 1
            self.aot_stats["load_failures"] += 1
            _log.warning("stored unit %s unusable (%s: %s); compiling the shard",
                         kstr, type(err).__name__, err)
            return None
        summary["loaded"] += 1
        self.aot_stats["loads"] += 1
        return fn

    def _dead_launch_args(self, shard, span: int, device) -> tuple:
        """A launch of the tick's exact shapes with every slot dead (live
        = 0): zero words, slot 0 everywhere, back-to-back offsets."""
        k_pad = shard.n_slots
        x = torch.zeros((shard.n_inputs_max, k_pad * span), dtype=torch.int32,
                        device=device)
        meta = torch.zeros((3, k_pad), dtype=torch.int32, device=device)
        meta[1] = torch.arange(k_pad, dtype=torch.int32, device=device) * span
        return x, meta[0], meta[1], meta[2]

    def _prewarm_shard(self, shard, spans, store, summary: dict) -> None:
        """Make every (shard, span) launch hot before it serves: load a
        stored unit, else compile one, and run it once dead; on a backend
        without units, run one dead eager launch per shape signature."""
        device = self.device_for(shard.shard)
        # stage the shard's device state now, so the swap fence reuses it
        with self._plan_lock:
            cached = self._dev.get(shard.content_hash)
            if cached is None:
                cached = self._staged_dev.get(shard.content_hash)
        if cached is None:
            cached = self._upload_shard(shard)
            with self._plan_lock:
                cached = self._staged_dev.setdefault(shard.content_hash, cached)
        for span in spans:
            span = int(span)
            if self._aot_capable:
                key = (shard.content_hash, span, self._dev_key(device))
                with self._aot_lock:
                    if key in self._aot:
                        continue
                fn = None if store is None else self._load_unit(
                    shard, span, device, store, summary)
                if fn is None:
                    fn = self._build_unit(shard, span, device)
                    summary["compiled"] += 1
                    self.aot_stats["compiles"] += 1
                with self._aot_lock:
                    fn = self._aot.setdefault(key, fn)
                # a unit's first launch pays one-time costs (the library's
                # load, the kernel's first run) — spend them on dead
                # inputs now, off the serving path
                fn(*self._dead_launch_args(shard, span, device))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                summary["exec_warmed"] += 1
                self.aot_stats["exec_warms"] += 1
            else:
                sig = (shard.n_slots, int(shard.opcodes.shape[1]),
                       int(shard.out_src.shape[1]), int(shard.n_inputs_max),
                       span, self._dev_key(device))
                if sig in self._warm_shapes:
                    continue  # these shapes already ran
                program, in_w = cached
                x, slots, woff, live = self._dead_launch_args(shard, span, device)
                self.backend.eval_program_spans(program, x, slots, woff, in_w,
                                                live, span_words=span)
                self._warm_shapes.add(sig)
                summary["trace_warmed"] += 1
                self.aot_stats["trace_warms"] += 1

    def prewarm_plan(self, compiled: CompiledPlan, *, spans=None, store=None) -> dict:
        """Make an incoming plan's launch shapes hot *before* it is
        installed — the anti-dip half of a plan swap.

        For every shard × span bucket: load the stored unit from ``store``
        when one is keyed for it, else compile one (backends with units),
        else run one dead eager launch (``"torch-ref"``).  ``spans``
        defaults to the buckets this server's ticks have produced, so a
        server that has never ticked prewarms nothing.  Runs outside the
        plan lock: serving continues on the old plan while the new one
        warms.  Returns a summary dict (loaded/compiled/trace_warmed/...).
        """
        summary = _summary()
        if not self.stable_shapes:
            # launch shapes depend on the live tenant count — nothing to warm
            summary["skipped"] = len(compiled.shards)
            _log.info("prewarm skipped: stable_shapes=False makes launch "
                      "shapes traffic-dependent")
            return summary
        # tuple(): one C-level copy, so a tick adding a bucket on another
        # thread cannot change the set in the middle of this iteration
        use = sorted({int(s) for s in (tuple(self._spans_seen) if spans is None else spans)})
        for shard in compiled.shards:
            self._prewarm_shard(shard, use, store, summary)
        return summary

    def export_executables(self, store, *, spans=None) -> list[str]:
        """Store the current plan's span-launch units in an `ArtifactStore`:
        one per shard × span bucket, keyed by ``(backend, shard content
        hash, span bucket)``.  ``spans`` defaults to the buckets ticks have
        produced (else the smallest).  A backend without units stores
        nothing and logs why.  Returns the stored keys."""
        caps = self.backend.capabilities()
        if not caps.supports_aot:
            _log.info("backend %r declares supports_aot=False: no units "
                      "exported, a boot from this store compiles", self.backend.name)
            return []
        if not self.stable_shapes:
            _log.info("stable_shapes=False: launch shapes are traffic-dependent, "
                      "no units exported")
            return []
        plan = self.plan()
        use = sorted({int(s) for s in (tuple(self._spans_seen) if spans is None else spans)}
                     ) or [self.span_bucket(1)]
        keys = []
        for shard in plan.shards:
            device = self.device_for(shard.shard)
            for span in use:
                key = (shard.content_hash, span, self._dev_key(device))
                with self._aot_lock:
                    fn = self._aot.get(key)
                if fn is None:
                    fn = self._build_unit(shard, span, device)
                    with self._aot_lock:
                        self.aot_stats["compiles"] += 1
                        fn = self._aot.setdefault(key, fn)
                kstr = aot.executable_key(self.backend.name, shard.content_hash, span)
                store.put_executable(
                    kstr, aot.serialize_executable(fn),
                    backend=self.backend.name, aot_format=caps.aot_format,
                    aot_format_version=caps.aot_format_version, spec=tuple(fn.spec),
                )
                keys.append(kstr)
        return keys

    def preload_executables(self, store) -> dict:
        """Boot-time half of `export_executables`: load every stored unit
        that matches the current plan's shard hashes (and this
        backend/format) into the launch cache — **no program compiled**
        when the store covers the plan.  Mismatched or broken entries
        compile instead, with the reason logged.  Returns the prewarm
        summary."""
        plan = self.plan()
        caps = self.backend.capabilities()
        spans_by_hash: dict[str, set[int]] = {}
        prefix = f"{self.backend.name}--"
        for kstr, entry in store.executable_entries().items():
            if entry.get("backend") != self.backend.name:
                continue
            if (entry.get("format") != caps.aot_format
                    or int(entry.get("format_version", 0)) > caps.aot_format_version):
                _log.warning(
                    "stored unit %s has format %s v%s; this backend reads "
                    "%s v<=%s — skipped (will compile)", kstr, entry.get("format"),
                    entry.get("format_version"), caps.aot_format,
                    caps.aot_format_version,
                )
                continue
            if not kstr.startswith(prefix) or "--s" not in kstr:
                continue
            body, span_s = kstr[len(prefix):].rsplit("--s", 1)
            spans_by_hash.setdefault(body, set()).add(int(span_s))
        summary = _summary()
        for shard in plan.shards:
            spans = sorted(spans_by_hash.get(shard.content_hash, ()))
            if not spans:
                continue
            self._spans_seen.update(spans)
            self._prewarm_shard(shard, spans, store, summary)
        return summary

    def swap_plan(
        self,
        compiled: CompiledPlan,
        *,
        compiler: PlanCompiler | None = None,
        action: str = "swap",
        reason: str = "",
        prewarm: bool = True,
        store=None,
    ) -> RebalanceEvent:
        """Generation-fenced atomic plan swap.

        Installs an externally compiled plan (a rebalanced, grown or
        shrunk one from `PlanCompiler.recompile`, or an exported layout
        from `compile_from_placement`) in place of the server's own.  The
        fence: the plan must have been compiled from the registry's
        *current* generation, else `StalePlanError` — the caller
        re-snapshots the catalog and recompiles, so a swap can never roll
        back a concurrent registry mutation.

        The swap is atomic against serving: a tick in flight keeps its own
        plan snapshot and device-state dict to the end; requests queued
        across the swap land on the new plan at their next tick.  Unchanged
        shards keep their device state (`RebalanceEvent.shards_reused`
        counts them).  ``compiler`` (when given) becomes the server's
        compiler, so the swapped policy — shard count, assignment, span
        alignment — also governs later generation-triggered refreshes;
        shard devices follow the shard index (`device_for`).

        ``prewarm`` (default on) makes the incoming plan's launch shapes
        hot *before* the fence on a backend with span-launch units: units
        load from ``store`` or compile while serving continues on the old
        plan, so the first post-swap tick builds nothing.  A backend
        without units warms at its first tick (or an explicit
        `prewarm_plan`) instead.
        """
        # fast-fail the fence before spending prewarm work on a plan that
        # is already stale (the lock re-checks authoritatively)
        if compiled.generation != self.registry.generation:
            raise StalePlanError(
                f"plan compiled at generation {compiled.generation}, "
                f"registry is at {self.registry.generation}"
            )
        prewarm_summary = None
        if prewarm and self._aot_capable:
            prewarm_summary = self.prewarm_plan(compiled, store=store)
        t0 = time.perf_counter()
        with self._plan_lock:
            if compiled.generation != self.registry.generation:
                raise StalePlanError(
                    f"plan compiled at generation {compiled.generation}, "
                    f"registry is at {self.registry.generation}"
                )
            prev = self._compiled
            if compiler is not None:
                self.compiler = compiler
                self.policy = compiler.policy
                self.span_align = compiler.span_align
            reused = rebuilt = 0
            dev: dict[str, tuple] = {}
            for shard in compiled.shards:
                cached = self._dev.get(shard.content_hash)
                if cached is None:
                    # a prewarm-staged entry still counts as rebuilt — the
                    # work happened for this swap, just earlier
                    rebuilt += 1
                    cached = self._staged_dev.pop(shard.content_hash, None)
                    if cached is None:
                        cached = self._upload_shard(shard)
                else:
                    reused += 1
                dev[shard.content_hash] = cached
            self._compiled = compiled
            self._dev = dev
            self._staged_dev.clear()
            with self._lock:
                inflight = sum(len(reqs) for reqs in self._pending.values())
        event = RebalanceEvent(
            action=action,
            reason=reason,
            generation=compiled.generation,
            from_shards=prev.n_shards if prev is not None else 0,
            to_shards=compiled.n_shards,
            shards_reused=reused,
            shards_rebuilt=rebuilt,
            inflight_requests=inflight,
            swap_ms=(time.perf_counter() - t0) * 1e3,
            prev_hash=prev.content_hash if prev is not None else "",
            plan_hash=compiled.content_hash,
        )
        self.stats.record_rebalance(event)
        # plan swaps land as instants on the shared timeline, next to the
        # request spans and tick phases they interleave with
        self.tracer.instant(
            "plan.swap", cat="autoscale", track="autoscale",
            action=action, reason=reason,
            from_shards=event.from_shards, to_shards=event.to_shards,
            shards_reused=reused, shards_rebuilt=rebuilt,
            inflight=inflight, swap_ms=round(event.swap_ms, 3),
            generation=event.generation,
            **({"prewarm_" + k: v for k, v in prewarm_summary.items() if v}
               if prewarm_summary else {}),
        )
        return event

    # -- shadow slots ----------------------------------------------------
    def set_shadow(self, tenant: str, n_members: int, n_shadow: int) -> None:
        """Mark the trailing ``n_shadow`` of the tenant's ``n_members``
        ensemble members as hidden shadow slots: they launch and decode
        like any member, but are excluded from the served vote and
        delivered to ``shadow_hook(tenant, shadow_ids, served_ids)``
        instead.  The exclusion only applies to launches whose member
        count equals ``n_members``, so the caller can set this *before*
        the registry mutation that adds the shadow member — a tick on the
        pre-mutation plan votes normally."""
        if not (0 < n_shadow < n_members):
            raise ValueError(
                f"need 0 < n_shadow < n_members, got ({n_shadow}, {n_members})"
            )
        self._shadow[tenant] = (int(n_members), int(n_shadow))

    def clear_shadow(self, tenant: str) -> None:
        self._shadow.pop(tenant, None)

    def shadow_of(self, tenant: str) -> "tuple[int, int] | None":
        return self._shadow.get(tenant)

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
        # plan, device state and span alignment are one snapshot: a
        # concurrent swap_plan re-points the live attributes, but this
        # tick launches entirely on what it read here
        plan, dev = self._refresh_plan()
        span_align = plan.span_align if plan.shards else self.span_align

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
            span = _bucket(max(E.n_words(e["rows"]) for _, _, e, _ in items), span_align)
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
            device = self.device_for(shard_idx)
            phase["pack"] += perf() - t1  # fused-buffer fill
            t1 = perf()
            with tracer.span("tick.device_put", cat="tick", shard=shard_idx):
                x_dev = torch.from_numpy(x_buf.view(np.int32)).to(device)
                meta_dev = torch.from_numpy(meta).to(device)
            self._spans_seen.add(span)
            t2 = perf()
            with tracer.span("tick.launch", cat="tick", shard=shard_idx,
                             span_words=span, slots=k_active):
                if self._aot_capable:
                    # the shard's unit: a cache hit, or built now — a unit
                    # that cannot be built fails the tick
                    fn = self._span_launch(shard, span, device)
                    with self._launch_span("eval_population_spans",
                                           population=k_pad, span_words=span,
                                           aot=True):
                        out = fn(x_dev, meta_dev[0], meta_dev[1], meta_dev[2])
                else:
                    program, in_w = dev[shard.content_hash]
                    out = self._exec.eval_program_spans(
                        program, x_dev, meta_dev[0], meta_dev[1], in_w,
                        meta_dev[2], span_words=span,
                    )
                    if self.stable_shapes:
                        # these shapes just ran: prewarm can skip them
                        self._warm_shapes.add((
                            shard.n_slots, int(shard.opcodes.shape[1]),
                            int(shard.out_src.shape[1]),
                            int(shard.n_inputs_max), span, self._dev_key(device),
                        ))
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
                member_ids = entry["member_ids"]
                shadow = self._shadow.get(entry["tenant"])
                n_sh = 0
                if shadow is not None and shadow[0] == len(member_ids):
                    n_sh = shadow[1]
                ids = ensemble_vote(np.stack(member_ids[:len(member_ids) - n_sh]),
                                    entry["n_classes"])
                if n_sh and self.shadow_hook is not None:
                    try:
                        self.shadow_hook(entry["tenant"],
                                         member_ids[len(member_ids) - n_sh:], ids)
                    except Exception:  # noqa: BLE001 — a scoring fault must
                        # never fail the serving path; it is logged
                        _log.exception("shadow hook failed for tenant %r",
                                       entry["tenant"])
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
