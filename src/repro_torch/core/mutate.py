"""Point mutations (paper §3.2), PyTorch port.

Each locus mutates with an independent Bernoulli(p) draw, so the number of
mutated loci is Binomial(n, p) for the functions and Binomial(E, p) for the
edges (E = 2n operands + O taps), as in the reference.

* Node mutation: replace the node's function with a uniform draw from
  F \\ {current}, as ``(gate_fn + off) % |F|`` with ``off`` uniform in
  [1, |F|) (no function mutation when |F| == 1, e.g. the NAND-only set).
* Edge mutation: redirect to a uniform valid source ≠ current.  Node i's
  operands are valid below I+i (topological index space ⇒ acyclic by
  construction); output taps may point anywhere below I+n.  When only one
  valid source exists the mutation is abandoned.

Draws come from an explicit `torch.Generator` on the CPU, and genomes stay
on the host.  The stream differs from the reference's threefry stream;
the distribution is the same.
"""
from __future__ import annotations

import torch

from repro_torch.core.genome import CircuitSpec, Genome


def _resample_excluding(
    generator: torch.Generator, hi: torch.Tensor, current: torch.Tensor
) -> torch.Tensor:
    """Uniform draw from [0, hi) \\ {current}, elementwise.

    Returns ``current`` unchanged where hi <= 1 (mutation abandoned)."""
    u = torch.rand(hi.shape, generator=generator)
    r = torch.floor(u * torch.clamp(hi - 1, min=1).to(u.dtype)).to(torch.int32)
    r = torch.minimum(r, torch.clamp(hi - 2, min=0))
    cand = r + (r >= current).to(torch.int32)
    return torch.where(hi > 1, cand, current)


def _mutate_stack(
    generator: torch.Generator, genome: Genome, spec: CircuitSpec, p: float,
    lam: int,
) -> Genome:
    """λ independent point mutations of one genome → stacked Genome."""
    n, i_in, o = spec.n_nodes, spec.n_inputs, spec.n_outputs
    n_fns = len(spec.fn_set)
    gate_fn = genome.gate_fn.to(torch.int32).expand(lam, n)
    edge = genome.edge_src.to(torch.int32).expand(lam, n, 2)
    outs = genome.out_src.to(torch.int32).expand(lam, o)

    # --- node function mutations ---
    if n_fns > 1:
        m = torch.rand((lam, n), generator=generator) < p
        off = torch.randint(1, n_fns, (lam, n), generator=generator, dtype=torch.int32)
        gate_fn = torch.where(m, (gate_fn + off) % n_fns, gate_fn)

    # --- function-node edge mutations ---
    hi = (i_in + torch.arange(n, dtype=torch.int32))[:, None].expand(lam, n, 2)
    m_e = torch.rand((lam, n, 2), generator=generator) < p
    new_e = _resample_excluding(generator, hi, edge)
    edge = torch.where(m_e, new_e, edge)

    # --- output tap mutations ---
    hi_o = torch.full((lam, o), i_in + n, dtype=torch.int32)
    m_o = torch.rand((lam, o), generator=generator) < p
    new_o = _resample_excluding(generator, hi_o, outs)
    outs = torch.where(m_o, new_o, outs)

    return Genome(gate_fn.contiguous(), edge.contiguous(), outs.contiguous())


def mutate(generator: torch.Generator, genome: Genome, spec: CircuitSpec,
           p: float) -> Genome:
    """One point-mutated copy of ``genome``."""
    return Genome(*(a[0] for a in _mutate_stack(generator, genome, spec, p, 1)))


def mutate_children(generator: torch.Generator, genome: Genome, spec: CircuitSpec,
                    p: float, lam: int) -> Genome:
    """λ children, stacked on a leading axis, each mutated independently."""
    return _mutate_stack(generator, genome, spec, p, lam)
