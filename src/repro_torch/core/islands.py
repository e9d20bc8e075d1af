"""Island-parallel evolution over `torch.distributed` (PyTorch port).

The reference runs its islands as one `shard_map` program on a device
mesh: islands on one axis, dataset words on another.  Here each
(island, shard) pair is one process of a `torch.distributed` group, with

    rank = island * n_data + shard,

and every rank runs the port's own 1+λ loop (`core/evolve.py`).  The rank
layout is the counterpart of `make_host_mesh`: each island has a data
group (its ``n_data`` ranks) and each shard index a ring (the ``n_islands``
ranks that hold the same words).  Every rank creates every group, in one
order, including groups it is not in.

  * **Sharded fitness.**  A rank holds a contiguous block of W / n_data
    words (`pad_words_for` pads W to a multiple; the padding's mask words
    are zero).  Its `make_eval_fn` sums the confusion counts and the class
    counts over its island's data group (``all_reduce``) before the host
    fitness, so fitness is exactly the unsharded value.  With gloo the
    sum runs on the host copies the loop already makes.
  * **Draws.**  An island has one `torch.Generator`, seeded from
    ``(seed, island)`` and identical on each of its data ranks: the ranks
    of an island draw the same children, so their summed counts belong to
    one population, and their states stay equal.
  * **Lockstep.**  Every generation makes the same collectives in one
    order: (1) the data ``all_reduce`` of an island that is still live
    (all ranks of an island agree on that); (2) the ring: each rank sends
    its island's ``(best, best_train)`` to the next island's rank of the
    same shard and receives the previous island's, with `isend`/`irecv`
    (a blocking ring deadlocks); (3) one world ``all_reduce`` of the live
    flags: the loop runs while any island is live.  An island that has
    terminated freezes its state, but still sends its best and still
    takes part in every collective.
  * **Migration** (the reference's gated accept): at ``t % migrate_every
    == migrate_every - 1`` a live island takes the incoming best as its
    parent when its training fitness is ``>=`` the parent's.  A ring of
    one island receives its own best (the reference's ``ppermute`` onto
    itself), which torch cannot send to its own rank, so it is a local
    copy: a ring of one is not `evolve_packed`.
  * **The class-sum order.**  The reference's fitness depends on how XLA
    compiles it (`fitness._class_sum`).  In the island program the counts
    reach the fitness as the results of a ``psum``, and XLA sums the
    recalls left to right, for the first parent outside the loop and for
    the children inside it, at every C (checked at C = 3 and 4 against
    the reference's program on 8 devices).  So every evaluation here uses
    ``in_loop=False``.

`evolve_islands` is the distributed program (one call per rank, inside an
initialised process group); `evolve_islands_plain` runs the same
semantics in one process over unsharded data, island after island, and is
what the distributed run is held to.  `launch/islands.py` starts the
ranks.  NCCL (one card per rank) is not used: the collectives move a few
hundred bytes on the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import runtime
from repro_torch.core.encoding import PackedDataset
from repro_torch.core.evolve import (
    EvolveConfig,
    EvolveState,
    generation_step,
    init_state,
    make_eval_fn,
    not_terminated,
)
from repro_torch.core.genome import CircuitSpec, Genome
from repro_torch.device import resolve_device

# the collectives of a generation, as `evolve_islands` books them
COLLECTIVES = ("data_allreduce", "ring", "live_allreduce")


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    migrate_every: int = 32
    n_data: int = 1   # data shards per island (the reference's data axes)


class IslandEval(make_eval_fn):
    """The island program's eval: every evaluation sums the class recalls
    left to right, as the reference's island program does (module doc)."""

    def __call__(self, genomes: Genome, *, in_loop: bool = True):
        return super().__call__(genomes, in_loop=False)


def island_generator(seed: int, island: int) -> torch.Generator:
    """The island's generator, the same on each of its data ranks."""
    state = np.random.SeedSequence([seed, island]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def pad_words_for(n_data: int) -> int:
    """Word-axis padding multiple so every data shard is equal-sized."""
    return n_data


def shard_of(data: PackedDataset, mask_train: torch.Tensor, mask_val: torch.Tensor,
             shard: int, n_data: int, device) -> tuple:
    """Shard ``shard``'s contiguous block of words, as `shard_map`'s
    ``P(None, "data")`` splits them, on ``device``."""
    w = data.x_words.shape[1]
    if w % n_data:
        raise ValueError(f"W = {w} words do not split into {n_data} shards; "
                         "pack with pad_words_to=pad_words_for(n_data)")
    block = slice(shard * (w // n_data), (shard + 1) * (w // n_data))
    local = PackedDataset(*(a[..., block].contiguous().to(device) for a in data))
    return (local, mask_train[block].contiguous().to(device),
            mask_val[block].contiguous().to(device))


def sharded_eval_fn(spec: CircuitSpec, data: PackedDataset, mask_train: torch.Tensor,
                    mask_val: torch.Tensor, shard: int, n_data: int, group, device,
                    seconds: "dict | None" = None) -> make_eval_fn:
    """The island program's eval on shard ``shard`` of ``n_data``: its
    counts are summed over ``group`` (the island's data group; ``None``:
    the world) before the host fitness.  ``seconds["data_allreduce"]``,
    when given, accumulates the host time of the sums."""
    def reduce_counts(counts: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        dist.all_reduce(counts, group=group)
        if seconds is not None:
            seconds["data_allreduce"] += time.perf_counter() - t0
        return counts

    local = shard_of(data, mask_train, mask_val, shard, n_data, device)
    return IslandEval(spec, *local, reduce_counts=reduce_counts)


def _accept_migrant(t: int, icfg: IslandConfig, live: bool, state: EvolveState,
                    inc_best: Genome, inc_train: np.float32) -> EvolveState:
    """The gated accept of the ring's incoming best."""
    if t % icfg.migrate_every == icfg.migrate_every - 1 and live \
            and inc_train >= state.parent_fit:
        return state._replace(parent=inc_best, parent_fit=inc_train)
    return state


def _pack(genome: Genome, fit: np.float32) -> torch.Tensor:
    """A genome and a float32 fitness as one int32 message."""
    bits = torch.tensor([np.float32(fit).view(np.int32)], dtype=torch.int32)
    return torch.cat([a.reshape(-1).to(torch.int32) for a in genome] + [bits])


def _unpack(msg: torch.Tensor, like: Genome) -> tuple[Genome, np.float32]:
    parts, at = [], 0
    for a in like:
        parts.append(msg[at:at + a.numel()].reshape(a.shape).clone())
        at += a.numel()
    return Genome(*parts), np.int32(msg[at].item()).view(np.float32)


class _Groups:
    """The rank layout: each island's data group and each shard's ring."""

    def __init__(self, n_islands: int, n_data: int):
        rank = dist.get_rank()
        self.island, self.shard = divmod(rank, n_data)
        self.n_islands, self.n_data = n_islands, n_data
        data = [dist.new_group([i * n_data + s for s in range(n_data)])
                for i in range(n_islands)]
        ring = [dist.new_group([i * n_data + s for i in range(n_islands)])
                for s in range(n_data)]
        self.data, self.ring = data[self.island], ring[self.shard]
        self.next = ((self.island + 1) % n_islands) * n_data + self.shard
        self.prev = ((self.island - 1) % n_islands) * n_data + self.shard


def evolve_islands(
    seed: int,
    spec: CircuitSpec,
    cfg: EvolveConfig,
    icfg: IslandConfig,
    data: PackedDataset,
    mask_train: torch.Tensor,
    mask_val: torch.Tensor,
    *,
    device: "str | torch.device | None" = None,
    timings: "dict | None" = None,
) -> list[EvolveState]:
    """This rank's part of the island program (module doc).  Call it on
    every rank of an initialised process group of ``n_islands *
    icfg.n_data`` ranks, with the whole padded dataset; the rank takes its
    own shard to ``device`` (``None``: the card, raising without one).

    Returns every island's final state, in island order, on every rank.
    ``timings``, when given, receives the host seconds of each collective
    (`COLLECTIVES`), summed over the run, the loop's iterations, this
    rank's evaluations and its search's mean ms per phase of a generation
    (`PhaseClock`; ``readback`` includes the data ``all_reduce``)."""
    device = resolve_device(device)
    world = dist.get_world_size()
    if world % icfg.n_data:
        raise ValueError(f"{world} ranks do not split into islands of {icfg.n_data} shards")
    groups = _Groups(world // icfg.n_data, icfg.n_data)
    seconds = dict.fromkeys(COLLECTIVES, 0.0)
    eval_fn = sharded_eval_fn(spec, data, mask_train, mask_val, groups.shard, icfg.n_data,
                              groups.data, device, seconds)
    generator = island_generator(seed, groups.island)

    def any_live(state: EvolveState) -> bool:
        t0 = time.perf_counter()
        flag = torch.tensor([int(not_terminated(state, cfg))], dtype=torch.int32)
        dist.all_reduce(flag)
        seconds["live_allreduce"] += time.perf_counter() - t0
        return bool(flag.item() > 0)

    def ring(state: EvolveState) -> tuple[Genome, np.float32]:
        if groups.n_islands == 1:  # the reference's ppermute onto itself
            return state.best, state.best_train
        t0 = time.perf_counter()
        out = _pack(state.best, state.best_train)
        inc = torch.empty_like(out)
        reqs = [dist.isend(out, groups.next, group=groups.ring),
                dist.irecv(inc, groups.prev, group=groups.ring)]
        for r in reqs:
            r.wait()
        seconds["ring"] += time.perf_counter() - t0
        return _unpack(inc, state.best)

    state = init_state(generator, spec, eval_fn)
    evaluations, t = 1, 0
    while any_live(state):
        live = not_terminated(state, cfg)
        if live:
            state = generation_step(state, generator, spec, cfg, eval_fn)
            evaluations += 1
        state = _accept_migrant(t, icfg, live, state, *ring(state))
        t += 1

    gathered: list = [None] * world
    dist.all_gather_object(gathered, (groups.island, groups.shard, state))
    if timings is not None:
        timings.update(seconds, iterations=t, evaluations=evaluations,
                       phase_ms=eval_fn.clock.mean_ms())
    return [s for _, shard, s in sorted(gathered, key=lambda g: g[:2]) if shard == 0]


def evolve_islands_plain(
    seed: int,
    spec: CircuitSpec,
    cfg: EvolveConfig,
    icfg: IslandConfig,
    n_islands: int,
    data: PackedDataset,
    mask_train: torch.Tensor,
    mask_val: torch.Tensor,
    backend: "str | runtime.EvalBackend | None" = None,
) -> list[EvolveState]:
    """The island program's semantics in one process over unsharded data
    (on the data's device): the islands stepped in order each generation,
    then the ring and its gated accept, until no island is live.  The same
    generators as `evolve_islands`; ``backend`` as `make_eval_fn`'s (the
    plain versions on the card: ``"torch-ref"``).  Its ring and accept
    are its own, not `evolve_islands`' (the tests hold that to this)."""
    eval_fn = IslandEval(spec, data, mask_train, mask_val, backend=backend)
    generators = [island_generator(seed, i) for i in range(n_islands)]
    states = [init_state(g, spec, eval_fn) for g in generators]
    t = 0
    while any(not_terminated(s, cfg) for s in states):
        live = [not_terminated(s, cfg) for s in states]
        stepped = [generation_step(s, g, spec, cfg, eval_fn) if lv else s
                   for s, g, lv in zip(states, generators, live)]
        migrate = t % icfg.migrate_every == icfg.migrate_every - 1
        states = list(stepped)
        for i in range(n_islands):
            src = stepped[(i + n_islands - 1) % n_islands]  # island i hears from i - 1
            if migrate and live[i] and src.best_train >= stepped[i].parent_fit:
                states[i] = stepped[i]._replace(parent=src.best, parent_fit=src.best_train)
        t += 1
    return states


def best_island(states: "list[EvolveState]") -> EvolveState:
    """Host-side: the island with the best validation fitness (the first
    on a tie, as ``argmax`` picks)."""
    return states[int(np.argmax([s.best_val for s in states]))]
