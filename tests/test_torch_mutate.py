"""Point mutation in the PyTorch port, held to the reference's contract.

The two packages draw from different PRNG streams, so mutation is held to
its distribution and its rules rather than to the reference's draws:

* each locus mutates with probability p, so the number of changed loci of
  a child is Binomial(E, p) for the E = 2n + O edges and Binomial(n, p)
  for the functions (|F| > 1);
* a resample never returns the current value, and is uniform over the
  others;
* only one valid source (hi <= 1) abandons the mutation, and a one-gate
  function set leaves ``gate_fn`` alone;
* every child is a valid genome by the reference's own `validate_genome`.

Every draw comes from a seeded generator, so each test is deterministic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.genome import CircuitSpec as RefSpec
from repro.core.genome import Genome as RefGenome
from repro.core.genome import validate_genome as ref_validate
from repro_torch.core import gates
from repro_torch.core.genome import CircuitSpec, init_genome, validate_genome
from repro_torch.core.mutate import _resample_excluding, mutate, mutate_children

N_CHILDREN = 4000


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _changed(children, parent):
    """Per child: (changed gate functions, changed edges incl. taps)."""
    fn = (children.gate_fn != parent.gate_fn).sum(1)
    edges = (children.edge_src != parent.edge_src).sum((1, 2)) + \
        (children.out_src != parent.out_src).sum(1)
    return fn.numpy(), edges.numpy()


def _assert_binomial(counts: np.ndarray, trials: int, p: float) -> None:
    """Mean within 5 standard errors of trials·p, and sample variance within
    15 % of trials·p·(1-p) (about 5 standard errors at N_CHILDREN draws)."""
    mean, var = trials * p, trials * p * (1 - p)
    se = np.sqrt(var / len(counts))
    assert abs(counts.mean() - mean) < 5 * se, (counts.mean(), mean)
    assert abs(counts.var(ddof=1) / var - 1) < 0.15, (counts.var(ddof=1), var)


@pytest.mark.parametrize("n_in,n,n_out,p", [(6, 50, 3, 0.05), (16, 300, 1, 1 / 300),
                                             (3, 20, 2, 0.2)])
def test_mutated_loci_are_binomial(n_in, n, n_out, p):
    spec = CircuitSpec(n_in, n, n_out, gates.FULL_FS)
    g = _gen(n)
    parent = init_genome(g, spec)
    children = mutate_children(g, parent, spec, p, N_CHILDREN)
    fn, edges = _changed(children, parent)
    # every function mutation changes the function (off in [1, |F|)), and
    # with I >= 2 every edge has another valid source, so every mutated
    # locus changes
    _assert_binomial(fn, n, p)
    _assert_binomial(edges, spec.n_edges, p)


def test_resample_never_returns_current_and_is_uniform():
    g = _gen(1)
    hi = torch.randint(2, 40, (20000,), generator=g, dtype=torch.int32)
    cur = (torch.rand(20000, generator=g) * hi).to(torch.int32)
    new = _resample_excluding(g, hi, cur)
    assert new.dtype == torch.int32
    assert bool((new != cur).all()) and bool((new >= 0).all()) and bool((new < hi).all())
    # uniform over the hi - 1 others: hi = 5, current = 2
    five = torch.full((40000,), 5, dtype=torch.int32)
    draws = _resample_excluding(g, five, torch.full_like(five, 2)).numpy()
    freq = np.bincount(draws, minlength=5) / len(draws)
    assert freq[2] == 0
    se = np.sqrt(0.25 * 0.75 / len(draws))
    assert np.all(np.abs(freq[[0, 1, 3, 4]] - 0.25) < 5 * se), freq


def test_one_valid_source_abandons_the_mutation():
    g = _gen(2)
    one = torch.ones(100, dtype=torch.int32)
    assert torch.equal(_resample_excluding(g, one, torch.zeros_like(one)), torch.zeros_like(one))
    # I = 1: node 0's operands have one valid source; at p = 1 they stay
    spec = CircuitSpec(1, 8, 1, gates.FULL_FS)
    parent = init_genome(g, spec)
    children = mutate_children(g, parent, spec, 1.0, 200)
    assert bool((children.edge_src[:, 0] == parent.edge_src[0]).all())
    assert bool((children.edge_src[:, 1:] != parent.edge_src[1:]).all())


def test_one_function_set_leaves_gate_fn_alone():
    spec = CircuitSpec(4, 30, 2, gates.NAND_FS)
    g = _gen(3)
    parent = init_genome(g, spec)
    children = mutate_children(g, parent, spec, 1.0, 50)
    assert torch.equal(children.gate_fn, parent.gate_fn.expand(50, 30))
    assert bool((children.edge_src != parent.edge_src).any())


@pytest.mark.parametrize("fn_set", ["full", "nand", "extended"])
def test_every_child_is_valid_by_the_reference(fn_set):
    fs = gates.FUNCTION_SETS[fn_set]
    spec = CircuitSpec(5, 40, 3, fs)
    ref_spec = RefSpec(5, 40, 3, fs)
    g = _gen(4)
    parent = init_genome(g, spec)
    for p in (1 / 40, 0.3, 1.0):
        children = mutate_children(g, parent, spec, p, 64)
        for i in range(64):
            child = RefGenome(*(jnp.asarray(a[i].numpy()) for a in children))
            assert ref_validate(child, ref_spec)
        parent = mutate(g, parent, spec, p)
        assert validate_genome(parent, spec)


def test_mutate_is_one_child_and_keeps_dtypes():
    spec = CircuitSpec(6, 20, 2, gates.FULL_FS)
    g = _gen(5)
    parent = init_genome(g, spec)
    child = mutate(g, parent, spec, 0.5)
    children = mutate_children(g, parent, spec, 0.5, 3)
    for a, b, c in zip(child, children, parent):
        assert a.shape == c.shape and b.shape == (3, *c.shape)
        assert a.dtype == b.dtype == torch.int32
        assert a.is_contiguous() and b.is_contiguous()
    # the parent is never written
    assert torch.equal(parent.gate_fn, init_genome(_gen(5), spec).gate_fn)
