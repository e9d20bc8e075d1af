"""Circuit genome representation (PyTorch port of the EGGP genome).

A genome is a feed-forward sea-of-gates graph:

  * ``I`` input nodes (ids ``0 … I-1``)   — one per encoded feature bit,
  * ``n`` function nodes (ids ``I … I+n-1``) — each with an opcode and two
    operand edges,
  * ``O`` output nodes — each tapping any input/function node.

Acyclicity: node ``i`` may only read ids ``< I + i`` (topological index
space), so one forward sweep evaluates the circuit.  Genome arrays are
``int32`` tensors kept on the host; a population is a plain leading axis.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CircuitSpec:
    """Static description of the genome search space."""

    n_inputs: int
    n_nodes: int
    n_outputs: int
    fn_set: tuple[int, ...] = (0, 1, 2, 3)  # opcodes (gates.FULL_FS default)

    def __post_init__(self):
        if self.n_inputs < 1 or self.n_nodes < 1 or self.n_outputs < 1:
            raise ValueError(f"circuit sizes must be >= 1: {self}")
        if len(self.fn_set) < 1:
            raise ValueError("fn_set must hold at least one opcode")

    @property
    def n_edges(self) -> int:
        """Total mutable edges E = 2n function-node edges + O output taps."""
        return 2 * self.n_nodes + self.n_outputs

    @property
    def total_ids(self) -> int:
        return self.n_inputs + self.n_nodes

    def fn_table(self) -> torch.Tensor:
        return torch.tensor(self.fn_set, dtype=torch.int32)


class Genome(NamedTuple):
    """Genome arrays.  ``gate_fn`` stores *indices into spec.fn_set* (not
    raw opcodes), as the reference and its saved bundles do."""

    gate_fn: torch.Tensor   # int32[n]     index into spec.fn_set
    edge_src: torch.Tensor  # int32[n, 2]  operand ids, edge_src[i] in [0, I+i)
    out_src: torch.Tensor   # int32[O]     output taps in [0, I+n)

    @property
    def n_nodes(self) -> int:
        return self.gate_fn.shape[-1]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def genome_from_arrays(gate_fn, edge_src, out_src) -> Genome:
    """A `Genome` of host ``int32`` tensors from genome arrays of any kind
    (numpy, or the reference package's arrays once passed through
    ``np.asarray``); a leading population axis is kept."""
    def i32(a) -> torch.Tensor:
        return torch.from_numpy(np.array(_np(a), dtype=np.int32))
    return Genome(i32(gate_fn), i32(edge_src), i32(out_src))


def opcodes(genome: Genome, spec: CircuitSpec) -> torch.Tensor:
    """Map stored fn-set indices to raw gate opcodes (int32)."""
    table = spec.fn_table().to(genome.gate_fn.device)
    return table[genome.gate_fn.long()]


def init_genome(generator: torch.Generator, spec: CircuitSpec) -> Genome:
    """Random initialisation (paper §3.2): each node gets a uniform function
    from F and operands drawn uniformly from the ids preceding it; each
    output taps a uniform id.  The stream differs from the reference's
    threefry stream; only the distribution is the same."""
    n, im = spec.n_nodes, spec.n_inputs
    gate_fn = torch.randint(
        0, len(spec.fn_set), (n,), generator=generator, dtype=torch.int32
    )
    # Valid operand range for node i is [0, I+i).
    hi = im + torch.arange(n, dtype=torch.int32)
    u = torch.rand((n, 2), generator=generator)
    edge_src = torch.floor(u * hi[:, None]).to(torch.int32)
    edge_src = torch.minimum(edge_src, hi[:, None] - 1)
    out_src = torch.randint(
        0, im + n, (spec.n_outputs,), generator=generator, dtype=torch.int32
    )
    return Genome(gate_fn, edge_src, out_src)


def validate_genome(genome: Genome, spec: CircuitSpec) -> bool:
    """Host-side structural validation."""
    g = Genome(*(_np(a) for a in genome))
    n, im, o = spec.n_nodes, spec.n_inputs, spec.n_outputs
    if g.gate_fn.shape != (n,) or g.edge_src.shape != (n, 2):
        return False
    if g.out_src.shape != (o,):
        return False
    if not ((g.gate_fn >= 0).all() and (g.gate_fn < len(spec.fn_set)).all()):
        return False
    hi = im + np.arange(n)
    if not ((g.edge_src >= 0).all() and (g.edge_src < hi[:, None]).all()):
        return False
    if not ((g.out_src >= 0).all() and (g.out_src < im + n).all()):
        return False
    return True


def active_nodes(genome: Genome, spec: CircuitSpec) -> np.ndarray:
    """Host-side mark-and-sweep of *active* function nodes (those with a
    path to an output).  Returns bool[n]."""
    g = Genome(*(_np(a) for a in genome))
    n, im = spec.n_nodes, spec.n_inputs
    active = np.zeros(n, dtype=bool)
    stack = [int(s) - im for s in g.out_src if int(s) >= im]
    while stack:
        i = stack.pop()
        if active[i]:
            continue
        active[i] = True
        for s in g.edge_src[i]:
            if int(s) >= im:
                stack.append(int(s) - im)
    return active
