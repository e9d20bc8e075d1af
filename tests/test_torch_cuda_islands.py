"""Island-parallel evolution on the card.

Marked ``cuda``: each test skips when no CUDA device is present (decided
inside the test, never at import).  This file imports neither JAX nor the
reference package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_islands.py

  * 2 islands × 2 shards (4 processes on the card, gloo on the host): each
    rank launches ``eval_population`` once per evaluation it made, and
    every island's final state equals `evolve_islands_plain` through the
    plain versions on the card, which launches nothing;
  * a population's fitness through 2 shards equals 1 shard, bitwise, on
    the card;
  * the launcher runs on the card when no device is named.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import encoding as E
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.gates import FULL_FS
from repro_torch.core.genome import CircuitSpec, Genome
from repro_torch.core.islands import IslandConfig, evolve_islands_plain, pad_words_for
from repro_torch.kernels import circuit_eval
from repro_torch.launch import islands as L

CFG = EvolveConfig(lam=4, kappa=60, max_gens=300)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _problem(n_data=2):
    rng = np.random.RandomState(0)
    x = rng.randn(2000, 5)
    y = ((x[:, 0] > 0) | (x[:, 2] > 1.0)).astype(np.int64)
    bits = E.encode(E.fit_encoder(x, E.EncodingConfig("quantile", 2)), x)
    data = E.pack_dataset(bits, y, 2, pad_words_to=pad_words_for(n_data), device="cpu")
    masks = E.split_masks(2000, data.x_words.shape[1], 0.5, seed=1, device="cpu")
    return CircuitSpec(bits.shape[1], 50, 1, FULL_FS), data, masks


def _same(a, b) -> bool:
    return (all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a.best, b.best))
            and all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a.parent, b.parent))
            and all(getattr(a, f).tobytes() == getattr(b, f).tobytes()
                    for f in ("best_val", "best_train", "parent_fit", "ref_val"))
            and int(a.gen) == int(b.gen))


@pytest.mark.cuda
def test_islands_on_the_card_equal_the_plain_version():
    _card()
    spec, data, masks = _problem()
    icfg = IslandConfig(migrate_every=8, n_data=2)
    run = L.launch_islands(5, spec, CFG, icfg, 2, data, *masks, timeout_s=300)
    for r in run.ranks:
        assert r["launches"]["eval_population"] == r["timings"]["evaluations"] \
            == int(run.states[r["island"]].gen) + 1
    circuit_eval.reset_launch_counts()
    dev = [a.cuda() for a in data]
    want = evolve_islands_plain(5, spec, CFG, icfg, 2, E.PackedDataset(*dev),
                                *(m.cuda() for m in masks), backend="torch-ref")
    assert circuit_eval.EVAL_POPULATION.launches == 0
    assert all(_same(a, b) for a, b in zip(run.states, want))


@pytest.mark.cuda
def test_two_shards_give_the_fitness_of_one_on_the_card():
    _card()
    spec, data, masks = _problem()
    g = torch.Generator().manual_seed(3)
    from repro_torch.core.genome import init_genome

    pop = [init_genome(g, spec) for _ in range(6)]
    genomes = Genome(*(torch.stack([p[i] for p in pop]) for i in range(3)))
    payload = {"problems": [{"data": [a.numpy() for a in data],
                             "masks": [m.numpy() for m in masks], "spec": spec,
                             "genomes": genomes}]}
    ranks = L.spawn_ranks(L.__name__ + ":fitness_rank", payload, 2, timeout_s=300)
    for r in ranks:
        for a, b in zip(r["sharded"][0], r["whole"][0]):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert r["launches"]["eval_population"] == 2  # sharded and whole, one launch each
