"""Immutable launch plans: the compiled half of launch planning.

A `Catalog` is what the registry knows (tenants and their member
circuits); a `LaunchPlan` is one shard of kernel-ready stacked tensors
plus the slot bookkeeping needed to route requests in and predictions
out; a `CompiledPlan` is the full set of shards with the tenant →
(shard, slot) placement map.  Plans are content-hashed so consumers
(device caches, schedulers) can tell "same tensors, reuse" from "stale,
rebuild" without comparing arrays.  Digests and content hashes are
byte-identical to the reference package's for the same circuits.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Mapping, NamedTuple

import numpy as np

from repro_torch.core import gates
from repro_torch.core.api import ServableCircuit


class Catalog(NamedTuple):
    """Immutable snapshot of a registry's tenant table.

    ``members[i]`` holds tenant ``tenants[i]``'s ensemble members in
    registration order (length 1 for plain tenants).  This is the only
    thing the compiler reads — it never touches the live registry."""

    tenants: tuple[str, ...]
    members: tuple[tuple[ServableCircuit, ...], ...]
    generation: int

    @property
    def n_slots(self) -> int:
        return sum(len(m) for m in self.members)


class SlotRef(NamedTuple):
    """Where one ensemble member landed: (shard index, slot in shard)."""

    shard: int
    slot: int


def pad_genome(
    sc: ServableCircuit, i_max: int, n_max: int, o_max: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Remap one circuit's genome into the shared (i_max, n_max, o_max) id
    space: input ids ``< I_t`` stay put, function-node ids shift by
    ``i_max - I_t``; pad nodes are inert ``BUF`` gates reading id 0."""
    i_t = sc.spec.n_inputs
    n_t = sc.spec.n_nodes
    o_t = sc.spec.n_outputs

    def remap(ids: np.ndarray) -> np.ndarray:
        return np.where(ids < i_t, ids, ids - i_t + i_max)

    opc = np.full(n_max, gates.BUF_A, np.int32)
    fn_set = np.asarray(sc.spec.fn_set, np.int32)
    opc[:n_t] = fn_set[np.asarray(sc.genome.gate_fn, np.int64)]
    edge = np.zeros((n_max, 2), np.int32)
    edge[:n_t] = remap(np.asarray(sc.genome.edge_src, np.int64))
    outs = np.zeros(o_max, np.int32)
    outs[:o_t] = remap(np.asarray(sc.genome.out_src, np.int64))
    return opc, edge, outs


def circuit_digest(sc: ServableCircuit) -> str:
    """Content hash of one servable circuit: genome, spec, encoder and
    class count — everything that can change what a launch computes."""
    h = hashlib.sha256()
    h.update(
        repr((
            tuple(int(v) for v in (sc.spec.n_inputs, sc.spec.n_nodes,
                                   sc.spec.n_outputs)),
            tuple(int(op) for op in sc.spec.fn_set),
            int(sc.n_classes),
            sc.encoder.strategy, int(sc.encoder.bits),
        )).encode()
    )
    for arr in (sc.genome.gate_fn, sc.genome.edge_src, sc.genome.out_src):
        h.update(np.ascontiguousarray(np.asarray(arr, np.int64)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(sc.encoder.thresholds, np.float32)).tobytes())
    h.update(np.ascontiguousarray(
        np.asarray(sc.encoder.codes, np.uint8)).tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """One shard of a compiled plan: kernel-ready stacked tensors for the
    slots placed on it, padded to this shard's own (i_max, n_max, o_max).

    Per-shard padding is a feature: a shard holding only small circuits
    launches small tensors, instead of inheriting the global maxima the
    old single-plan design forced on everyone."""

    shard: int                         # this shard's index in the plan
    slot_tenants: tuple[str, ...]      # logical tenant behind each slot
    slot_members: tuple[int, ...]      # ensemble member index per slot
    circuits: tuple[ServableCircuit, ...]  # artifact behind each slot
    opcodes: np.ndarray                # i32[S, n_max]
    edge_src: np.ndarray               # i32[S, n_max, 2]
    out_src: np.ndarray                # i32[S, O_max]
    in_width: np.ndarray               # i32[S] live input bits per slot
    out_width: np.ndarray              # i32[S] live output bits per slot
    n_classes: np.ndarray              # i32[S]
    span_align: int                    # word-span multiple launches honour
    generation: int                    # catalog generation compiled from
    content_hash: str                  # content address (excludes generation)

    @property
    def n_slots(self) -> int:
        return len(self.slot_tenants)

    @property
    def n_inputs_max(self) -> int:
        return 0 if self.in_width.size == 0 else int(self.in_width.max())

    def word_offsets(self, span_words: int) -> np.ndarray:
        """Word offset of each slot's span in the fused buffer (slot k owns
        words ``[k*span_words, (k+1)*span_words)``)."""
        return np.arange(self.n_slots, dtype=np.int64) * int(span_words)


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """Every shard of a compiled catalog plus the placement map.

    ``placement[tenant]`` lists one `SlotRef` per ensemble member, in
    member order; plain tenants have exactly one.  The plan is an
    immutable snapshot — registry mutations after compile never show up
    here, they bump the generation and trigger a fresh compile."""

    shards: tuple[LaunchPlan, ...]
    placement: Mapping[str, tuple[SlotRef, ...]]
    generation: int
    span_align: int
    content_hash: str

    @property
    def tenants(self) -> tuple[str, ...]:
        return tuple(self.placement)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def n_slots(self) -> int:
        return sum(s.n_slots for s in self.shards)

    def shard_of(self, tenant: str) -> int:
        """Home shard of a tenant (its first member's shard; 0 if the
        tenant is not in the plan — schedulers must still tick it so the
        server can fail its requests individually)."""
        refs = self.placement.get(tenant)
        return refs[0].shard if refs else 0

    def members(self, tenant: str) -> tuple[ServableCircuit, ...]:
        """The member circuits serving one logical tenant, member order."""
        return tuple(
            self.shards[r.shard].circuits[r.slot]
            for r in self.placement[tenant]
        )


def ensemble_vote(ids: np.ndarray, n_classes: int) -> np.ndarray:
    """Majority vote over member predictions: ``ids[k, rows]`` → ``[rows]``.

    Ties break toward the lowest class id (np.argmax picks the first
    maximum), which keeps voting deterministic for even member counts."""
    ids = np.asarray(ids, np.int64)
    if ids.shape[0] == 1:
        return ids[0]
    counts = np.zeros((ids.shape[1], n_classes), np.int64)
    rows = np.arange(ids.shape[1])
    for member in ids:
        counts[rows, member] += 1
    return counts.argmax(axis=1)
