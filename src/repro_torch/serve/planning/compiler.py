"""PlanCompiler: catalog + policy + backend → immutable launch shards.

The compiler is the one place placement decisions are made.  It expands
ensemble tenants into member slots, assigns slots to shards per the
policy, stacks each shard's genomes into kernel-ready tensors (padded to
that shard's own maxima), resolves the effective span alignment against
the backend's ``capabilities().word_alignment``, and content-hashes the
result so consumers can cache by value.  Compilation is pure: same
catalog, policy and backend always produce byte-identical plans.
"""
from __future__ import annotations

import hashlib
import heapq

import numpy as np

from repro_torch import runtime
from repro_torch.core.api import ServableCircuit
from repro_torch.runtime.aot import executable_key
from repro_torch.serve.planning.plan import (
    Catalog,
    CompiledPlan,
    LaunchPlan,
    SlotRef,
    circuit_digest,
    pad_genome,
)
from repro_torch.serve.planning.policy import DEFAULT_POLICY, PlacementPolicy


def _slot_cost(sc: ServableCircuit) -> int:
    """Per-slot launch cost proxy: signals evaluated per word column."""
    return sc.spec.n_inputs + sc.spec.n_nodes


def _assign(
    policy: PlacementPolicy, costs: list[int], n_shards: int
) -> list[int]:
    """Slot index → shard index, per the policy's assignment strategy."""
    n = len(costs)
    if policy.assignment == "round_robin":
        return [i % n_shards for i in range(n)]
    if policy.assignment == "contiguous":
        # catalog order split into n_shards runs, sizes as even as possible
        per, extra = divmod(n, n_shards)
        out = []
        for s in range(n_shards):
            out.extend([s] * (per + (1 if s < extra else 0)))
        return out
    # "balanced": LPT greedy — biggest slots first onto the lightest shard;
    # ties break on shard index so compilation stays deterministic
    order = sorted(range(n), key=lambda i: (-costs[i], i))
    heap = [(0, s) for s in range(n_shards)]
    heapq.heapify(heap)
    out = [0] * n
    for i in order:
        load, s = heapq.heappop(heap)
        out[i] = s
        heapq.heappush(heap, (load + costs[i], s))
    return out


class PlanCompiler:
    """Compiles `Catalog` snapshots into `CompiledPlan`s under one policy.

    ``backend`` only contributes its capabilities descriptor here (span
    alignment); the compiler never evaluates anything.  ``span_align`` is
    the resolved effective alignment every plan from this compiler
    carries."""

    def __init__(
        self,
        backend: "str | runtime.EvalBackend" = "torch-ref",
        policy: PlacementPolicy = DEFAULT_POLICY,
    ):
        self.backend = runtime.resolve_backend(backend)
        self.policy = policy
        self.span_align = self.backend.span_alignment(policy.span_align)

    def compile(self, catalog: Catalog) -> CompiledPlan:
        slots = [
            (tenant, m, sc)
            for tenant, members in zip(catalog.tenants, catalog.members)
            for m, sc in enumerate(members)
        ]
        if not slots:
            return CompiledPlan(
                shards=(), placement={}, generation=catalog.generation,
                span_align=self.span_align, content_hash=self._hash([]),
            )
        n_shards = min(self.policy.n_shards, len(slots))
        assignment = _assign(
            self.policy, [_slot_cost(sc) for _, _, sc in slots], n_shards
        )

        per_shard: list[list[tuple[str, int, ServableCircuit]]] = [
            [] for _ in range(n_shards)
        ]
        placement: dict[str, list[SlotRef | None]] = {
            t: [None] * len(ms)
            for t, ms in zip(catalog.tenants, catalog.members)
        }
        for (tenant, m, sc), shard in zip(slots, assignment):
            placement[tenant][m] = SlotRef(shard, len(per_shard[shard]))
            per_shard[shard].append((tenant, m, sc))

        shards = tuple(
            self._build_shard(s, entries, catalog.generation)
            for s, entries in enumerate(per_shard)
        )
        return CompiledPlan(
            shards=shards,
            placement={t: tuple(refs) for t, refs in placement.items()},
            generation=catalog.generation,
            span_align=self.span_align,
            content_hash=self._hash([sh.content_hash for sh in shards]),
        )

    def recompile(
        self,
        catalog: Catalog,
        prev_plan: "CompiledPlan | None",
        policy: "PlacementPolicy | None" = None,
        *,
        weights: "dict[str, float] | None" = None,
        max_imbalance: "float | None" = None,
    ) -> CompiledPlan:
        """Incremental compile against a previous plan: maximize shard
        content-hash reuse so an online plan swap re-uploads (and
        rebuilds) only the shards that actually changed.

        Surviving ``(tenant, member)`` slots stay on their previous
        shard in their previous relative order — a shard none of whose
        slots changed keeps a byte-identical content hash, and every
        cache keyed on it (device tensors) stays warm across
        the swap.  New slots, and slots whose previous shard fell off a
        shrunk plan, go to the lightest shard (LPT).  Empty shards (a
        grown plan) always receive work; with ``max_imbalance`` the
        heaviest shard additionally sheds slots to the lightest until
        ``max_load <= max_imbalance * mean_load`` — the knob a
        telemetry-driven rebalance turns.

        ``weights`` replaces the static gate-cost model with observed
        per-tenant load (e.g. rows served over the controller's window),
        split evenly across a tenant's ensemble members — what a load
        rebalance actually wants to equalize.  A tenant absent from the
        mapping weighs zero (it served nothing in the window): mixing
        observed rows with gate-count fallbacks would compare
        incomparable units and migrate the wrong slots.  ``policy``
        overrides this compiler's policy for the new plan (how an
        autoscaler grows/shrinks ``n_shards`` without mutating the
        compiler the server still holds).
        """
        if policy is not None and policy != self.policy:
            return PlanCompiler(self.backend, policy).recompile(
                catalog, prev_plan,
                weights=weights, max_imbalance=max_imbalance,
            )
        slots = [
            (tenant, m, sc)
            for tenant, members in zip(catalog.tenants, catalog.members)
            for m, sc in enumerate(members)
        ]
        if not slots or prev_plan is None or not prev_plan.shards:
            return self.compile(catalog)
        n_shards = min(self.policy.n_shards, len(slots))

        n_members = {t: len(ms)
                     for t, ms in zip(catalog.tenants, catalog.members)}

        def cost(tenant: str, sc: ServableCircuit) -> float:
            if weights is not None:
                w = weights.get(tenant)
                return (max(float(w), 0.0) / n_members[tenant]
                        if w is not None else 0.0)
            return float(_slot_cost(sc))

        costs = [cost(t, sc) for t, _, sc in slots]
        prev_ref: dict[tuple[str, int], SlotRef] = {
            (t, m): r
            for t, refs in prev_plan.placement.items()
            for m, r in enumerate(refs)
            if r is not None
        }

        # sticky pass: surviving slots keep their shard and relative order
        per_shard: list[list[int]] = [[] for _ in range(n_shards)]
        sticky: list[list[tuple[int, int]]] = [[] for _ in range(n_shards)]
        homeless: list[int] = []
        for idx, (t, m, _) in enumerate(slots):
            r = prev_ref.get((t, m))
            if r is not None and r.shard < n_shards:
                sticky[r.shard].append((r.slot, idx))
            else:
                homeless.append(idx)
        for s in range(n_shards):
            per_shard[s] = [idx for _, idx in sorted(sticky[s])]
        loads = [sum(costs[i] for i in shard) for shard in per_shard]

        # new / orphaned slots: LPT onto the lightest shard
        for idx in sorted(homeless, key=lambda i: (-costs[i], i)):
            s = min(range(n_shards), key=lambda s: (loads[s], s))
            per_shard[s].append(idx)
            loads[s] += costs[idx]

        def move(hi: int, lo: int, idx: int) -> None:
            per_shard[hi].remove(idx)
            per_shard[lo].append(idx)
            loads[hi] -= costs[idx]
            loads[lo] += costs[idx]

        def best_pick(hi: int, lo: int) -> int:
            gap = (loads[hi] - loads[lo]) / 2
            return min(per_shard[hi],
                       key=lambda i: (abs(costs[i] - gap), i))

        # feed empty shards (a grown plan): every shard must carry work
        for _ in range(len(slots)):
            empties = [s for s in range(n_shards) if not per_shard[s]]
            donors = [s for s in range(n_shards) if len(per_shard[s]) > 1]
            if not empties or not donors:
                break
            hi = max(donors, key=lambda s: (loads[s], -s))
            move(hi, empties[0], best_pick(hi, empties[0]))

        # surgical rebalance: ONE donor (the heaviest shard), ONE
        # recipient (the lightest) — a rebalance swap rebuilds at most
        # two shards, keeping the rest of the fleet's uploads
        # warm; if that is not enough, the hysteresis loop fires
        # again next window
        if max_imbalance is not None and n_shards > 1:
            hi = max(range(n_shards), key=lambda s: (loads[s], -s))
            lo = min(range(n_shards), key=lambda s: (loads[s], s))
            for _ in range(len(slots)):
                mean = sum(loads) / n_shards
                if (hi == lo or len(per_shard[hi]) <= 1
                        or loads[hi] <= max_imbalance * mean):
                    break
                gap = (loads[hi] - loads[lo]) / 2
                pick = best_pick(hi, lo)
                # moving cost c narrows the spread iff c < hi − lo; and
                # a c far below the gap cannot meaningfully fix the
                # imbalance — it would only churn shard hashes, so stop
                # rather than shuffle crumbs
                if not (0.25 * gap <= costs[pick]
                        < loads[hi] - loads[lo]):
                    break  # no useful move remains
                move(hi, lo, pick)

        placement: dict[str, list[SlotRef | None]] = {
            t: [None] * len(ms)
            for t, ms in zip(catalog.tenants, catalog.members)
        }
        per_shard_entries: list[list[tuple[str, int, ServableCircuit]]] = []
        for s, shard_slots in enumerate(per_shard):
            entries = []
            for idx in shard_slots:
                t, m, sc = slots[idx]
                placement[t][m] = SlotRef(s, len(entries))
                entries.append((t, m, sc))
            per_shard_entries.append(entries)

        shards = tuple(
            self._build_shard(s, entries, catalog.generation)
            for s, entries in enumerate(per_shard_entries)
        )
        return CompiledPlan(
            shards=shards,
            placement={t: tuple(refs) for t, refs in placement.items()},
            generation=catalog.generation,
            span_align=self.span_align,
            content_hash=self._hash([sh.content_hash for sh in shards]),
        )

    def compile_from_placement(
        self,
        catalog: Catalog,
        placement: "dict[str, list] | None",
        n_shards: int,
    ) -> CompiledPlan:
        """Rebuild the *exact* plan an exporter was serving.

        ``placement`` maps tenant → one ``(shard, slot)`` pair per member
        (JSON round-trip friendly: lists work too) — typically the
        serialized ``plan.placement`` of a live server, which may be a
        sticky-recompiled layout no fresh `compile` would reproduce.
        Reconstructing it verbatim is what makes artifact boot exact:
        identical slot order → byte-identical shard content hashes → the
        stored span-launch units keyed on them actually match.

        Raises ValueError when the placement does not cover the catalog
        exactly (missing/extra members, non-contiguous slots) — boot
        paths treat that as "fall back to a fresh compile" and log it.
        """
        if placement is None:
            raise ValueError("no placement recorded")
        by_member = {
            (t, m): sc
            for t, members in zip(catalog.tenants, catalog.members)
            for m, sc in enumerate(members)
        }
        slotted: dict[int, dict[int, tuple[str, int, ServableCircuit]]] = {}
        seen = set()
        for tenant, refs in placement.items():
            for m, ref in enumerate(refs):
                sc = by_member.get((tenant, m))
                if sc is None:
                    raise ValueError(
                        f"placement names ({tenant!r}, member {m}) which is "
                        "not in the catalog"
                    )
                seen.add((tenant, m))
                s, slot = int(ref[0]), int(ref[1])
                if not 0 <= s < n_shards:
                    raise ValueError(
                        f"placement puts {tenant!r} on shard {s} of a "
                        f"{n_shards}-shard plan"
                    )
                if slot in slotted.setdefault(s, {}):
                    raise ValueError(
                        f"placement assigns shard {s} slot {slot} twice"
                    )
                slotted[s][slot] = (tenant, m, sc)
        if seen != set(by_member):
            missing = sorted(set(by_member) - seen)
            raise ValueError(f"placement misses catalog members {missing}")
        per_shard_entries: list[list[tuple[str, int, ServableCircuit]]] = []
        out_placement: dict[str, list[SlotRef | None]] = {
            t: [None] * len(ms)
            for t, ms in zip(catalog.tenants, catalog.members)
        }
        for s in range(n_shards):
            slots_here = slotted.get(s, {})
            if sorted(slots_here) != list(range(len(slots_here))):
                raise ValueError(
                    f"shard {s} slots are not contiguous: {sorted(slots_here)}"
                )
            if not slots_here:
                raise ValueError(f"shard {s} has no slots")
            entries = [slots_here[k] for k in range(len(slots_here))]
            for k, (t, m, _) in enumerate(entries):
                out_placement[t][m] = SlotRef(s, k)
            per_shard_entries.append(entries)
        shards = tuple(
            self._build_shard(s, entries, catalog.generation)
            for s, entries in enumerate(per_shard_entries)
        )
        return CompiledPlan(
            shards=shards,
            placement={t: tuple(refs) for t, refs in out_placement.items()},
            generation=catalog.generation,
            span_align=self.span_align,
            content_hash=self._hash([sh.content_hash for sh in shards]),
        )

    def executable_keys(
        self, plan: CompiledPlan, spans
    ) -> "dict[str, tuple[int, int]]":
        """Cache key of every (shard, span bucket) launch unit this plan
        can dispatch: key → ``(shard index, span_words)``.  Keys follow
        `repro_torch.runtime.aot.executable_key` — ``(backend, shard
        content hash, span bucket)`` — so they are stable across processes
        and restarts; exporters store units under them and booting hosts
        look them up."""
        return {
            executable_key(
                self.backend.name, shard.content_hash, int(span)
            ): (shard.shard, int(span))
            for shard in plan.shards
            for span in spans
        }

    def _build_shard(
        self,
        shard: int,
        entries: list[tuple[str, int, ServableCircuit]],
        generation: int,
    ) -> LaunchPlan:
        circuits = [sc for _, _, sc in entries]
        i_max = max(c.spec.n_inputs for c in circuits)
        n_max = max(c.spec.n_nodes for c in circuits)
        o_max = max(c.spec.n_outputs for c in circuits)
        padded = [pad_genome(c, i_max, n_max, o_max) for c in circuits]

        def frz(arr: np.ndarray) -> np.ndarray:
            arr.setflags(write=False)
            return arr

        return LaunchPlan(
            shard=shard,
            slot_tenants=tuple(t for t, _, _ in entries),
            slot_members=tuple(m for _, m, _ in entries),
            circuits=tuple(circuits),
            opcodes=frz(np.stack([p[0] for p in padded])),
            edge_src=frz(np.stack([p[1] for p in padded])),
            out_src=frz(np.stack([p[2] for p in padded])),
            in_width=frz(np.asarray(
                [c.spec.n_inputs for c in circuits], np.int32)),
            out_width=frz(np.asarray(
                [c.spec.n_outputs for c in circuits], np.int32)),
            n_classes=frz(np.asarray(
                [c.n_classes for c in circuits], np.int32)),
            span_align=self.span_align,
            generation=generation,
            content_hash=self._shard_hash(shard, entries),
        )

    def _shard_hash(
        self, shard: int, entries: list[tuple[str, int, ServableCircuit]]
    ) -> str:
        """Per-shard content address: span alignment, the shard's index
        (its device binding), and its slot contents in order — and
        deliberately NOT the policy's ``n_shards``/``assignment`` knobs,
        so growing the plan or rebalancing *other* shards leaves this
        shard's hash (and every device upload keyed on it)
        untouched across a swap."""
        h = hashlib.sha256()
        h.update(repr((self.span_align, shard)).encode())
        h.update(repr([
            (t, m, circuit_digest(sc)) for t, m, sc in entries
        ]).encode())
        return h.hexdigest()

    def _hash(self, parts: list) -> str:
        """Plan-level content address: policy knobs + shard hashes, NOT
        generation — re-adding identical circuits yields the same hash
        (caches keyed on it stay warm), while any content or
        placement change breaks it."""
        h = hashlib.sha256()
        h.update(repr((
            self.span_align, self.policy.n_shards, self.policy.assignment,
        )).encode())
        h.update(repr(parts).encode())
        return h.hexdigest()
