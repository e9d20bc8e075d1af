"""Island-parallel evolution on the port (`core/islands.py` over gloo,
`launch/islands.py`) against the reference and against its own plain
version.

  * the sharded fitness, through real gloo groups of D = 2 and 4
    processes, equals the reference's `make_eval_fn` bitwise at C = 2, 3
    and 4, on genomes the reference made;
  * the reference's island program (8 fake devices: data = 2, model = 4)
    at C = 3 and 4: the port's sharded evaluation of its final parents and
    bests reproduces its ``parent_fit``, ``best_val`` and ``best_train``
    bitwise, which pins the class-sum order of the initial and the in-loop
    evaluations (left to right: `core/islands.py`);
  * that program at C = 3 and 4 (islands frozen at different generations
    at C = 3), its draws fed to `evolve_islands_plain`, ends in the
    reference's states island by island: genomes, fitnesses, γ/κ
    bookkeeping and generation counts;
  * distributed runs (2×2, 4×1 and a ring of one island, 1×2) equal
    `evolve_islands_plain` bitwise from the same seed, and D = 1 equals
    D = 2;
  * the reference test's quality bound (best_val > 0.8) at 4 islands × 2
    shards;
  * a failing or silent rank fails the launch with its stderr.

Every launch has its own timeout (``timeout_s``; the reference's program
runs under `run_multidevice`'s).  The processes of all launches start
together in one module fixture, so the file's wall time is about the
slowest launch's.
"""
import functools
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from repro.core import encoding as RE
from repro.core import gates
from repro.core.evolve import make_eval_fn as ref_make_eval_fn
from repro.core.genome import CircuitSpec as RefSpec
from repro.core.genome import Genome as RefGenome
from repro.core.genome import init_genome as ref_init_genome
from repro.core.mutate import mutate_children as ref_mutate_children
from repro_torch.core import encoding as E
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import balanced_accuracy_from_counts
from repro_torch.core.genome import CircuitSpec, genome_from_arrays
from repro_torch.core.islands import (
    IslandConfig, best_island, evolve_islands, evolve_islands_plain, pad_words_for)
from repro_torch.device import NoCudaDeviceError
from repro_torch.launch import islands as L
from tests.conftest import run_multidevice

TIMEOUT_S = 240.0
FITNESS = "repro_torch.launch.islands:fitness_rank"
RUNS = {"2x2": (2, 2), "4x1": (4, 1), "1x2": (1, 2), "2x1": (2, 1)}

# the reference's island program's cases: (C, EvolveConfig, migrate_every);
# at C = 3 the islands stop at different generations (a small κ), so the
# replay sees frozen islands, and at C = 4 the class-sum orders differ
REF_CASES = {"3": (3, dict(lam=4, kappa=5, max_gens=60), 4),
             "4": (4, dict(lam=4, kappa=10**6, max_gens=40), 8)}
REF_FIELDS = ("parent_fit", "best_val", "best_train", "ref_val")

REFERENCE_PROGRAM = """
import json, numpy as np, jax
from repro.core import gates
from repro.core import encoding as E
from repro.core.genome import CircuitSpec
from repro.core.evolve import EvolveConfig
from repro.core.islands import IslandConfig, evolve_islands, pad_words_for
from repro.launch.mesh import make_host_mesh
mesh = make_host_mesh(data=2, model=4)
out = {}
for name, (C, kw, every) in %r.items():
    rng = np.random.RandomState(0)
    X = rng.randn(700, 5)
    y = ((X[:, 0] > 0).astype(int) + 2 * (X[:, 2] > 0.5) + (X[:, 1] > 1)) %% C
    bits = E.encode(E.fit_encoder(X, E.EncodingConfig("quantile", 2)), X)
    data = E.pack_dataset(bits, y, C, pad_words_to=pad_words_for(mesh, ("data",)))
    mtr, mva = E.split_masks(700, data.x_words.shape[1], 0.5, seed=1)
    spec = CircuitSpec(bits.shape[1], 30, data.y_words.shape[0], gates.FULL_FS)
    st = evolve_islands(jax.random.split(jax.random.key(0), 4), spec, EvolveConfig(**kw),
                        IslandConfig(migrate_every=every), data, mtr, mva, mesh)
    res = {k: np.asarray(getattr(st, k)).view(np.uint32).tolist() for k in %r}
    res.update({k: np.asarray(getattr(st, k)).tolist() for k in ("since", "gen")})
    res.update({g + "." + f: np.asarray(getattr(getattr(st, g), f)).tolist()
                for g in ("parent", "best") for f in ("gate_fn", "edge_src", "out_src")})
    out[name] = res
print("RESULT " + json.dumps(out))
""" % (REF_CASES, REF_FIELDS)


def _rule_bits(rows, n_classes, seed):
    """The reference island test's rule (C = 2) or the fit tests' (C > 2)
    over seeded numpy rows, encoded by the reference."""
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, 5)
    if n_classes == 2:
        y = ((x[:, 0] > 0) | (x[:, 2] > 1.0)).astype(np.int64)
    else:
        y = ((x[:, 0] > 0).astype(int) + 2 * (x[:, 2] > 0.5) + (x[:, 1] > 1)) % n_classes
    return RE.encode(RE.fit_encoder(x, RE.EncodingConfig("quantile", 2)), x), y


def _problem(bits, y, n_classes, pad, n_nodes):
    """The same packed problem for the port (host arrays) and the reference."""
    ref = RE.pack_dataset(bits, y, n_classes, pad_words_to=pad)
    w = ref.x_words.shape[1]
    port = E.pack_dataset(bits, y, n_classes, pad_words_to=pad, device="cpu")
    masks = E.split_masks(len(y), w, 0.5, seed=1, device="cpu")
    return {"ref": ref, "ref_masks": RE.split_masks(len(y), w, 0.5, seed=1),
            "data": [a.numpy() for a in port], "masks": [m.numpy() for m in masks],
            "ref_spec": RefSpec(bits.shape[1], n_nodes, ref.y_words.shape[0], gates.FULL_FS),
            "spec": CircuitSpec(bits.shape[1], n_nodes, port.n_outputs, gates.FULL_FS)}


def _fitness_problems():
    """C = 2, 3, 4 with 8 reference-made genomes each (two broods of λ = 4
    children), padded for 4 shards."""
    probs = []
    for c in (2, 3, 4):
        prob = _problem(*_rule_bits(700, c, seed=c), c, pad=4, n_nodes=40)
        key = jax.random.key(c)
        broods = []
        for _ in range(2):
            key, k1, k2 = jax.random.split(key, 3)
            broods.append(ref_mutate_children(k2, ref_init_genome(k1, prob["ref_spec"]),
                                              prob["ref_spec"], 0.2, 4))
        children = jax.tree.map(lambda *a: np.concatenate(a), *broods)
        prob["genomes"] = genome_from_arrays(*children)
        prob["ref_fitness"] = ref_make_eval_fn(prob["ref_spec"], prob["ref"],
                                               *prob["ref_masks"])(children)
        probs.append(prob)
    return probs


def _payload(probs):
    return {"problems": [{k: p[k] for k in ("data", "masks", "spec", "genomes")}
                         for p in probs]}


def _launch(prob, k, d, cfg, migrate_every, seed=3):
    return L.launch_islands(seed, prob["spec"], cfg, IslandConfig(migrate_every, d), k,
                            *_port_data(prob), device="cpu", timeout_s=TIMEOUT_S)


def _port_data(prob):
    return (E.PackedDataset(*(torch.from_numpy(a) for a in prob["data"])),
            *(torch.from_numpy(m) for m in prob["masks"]))


RUN_CFG = EvolveConfig(lam=4, kappa=40, max_gens=200)


@pytest.fixture(scope="module")
def launched():
    """Every launch of the file, started together (the reference's program,
    the slowest, first); each value is a future."""
    with ThreadPoolExecutor(max_workers=12) as pool:
        futures = {"reference": pool.submit(run_multidevice, REFERENCE_PROGRAM, 8, 300)}
        fit_probs = _fitness_problems()
        run_prob = _problem(*_rule_bits(2000, 2, seed=0), 2, pad=2, n_nodes=50)
        futures |= {
            "fitness2": pool.submit(L.spawn_ranks, FITNESS, _payload(fit_probs), 2,
                                    device="cpu", timeout_s=TIMEOUT_S),
            "fitness4": pool.submit(L.spawn_ranks, FITNESS, _payload(fit_probs), 4,
                                    device="cpu", timeout_s=TIMEOUT_S),
            "quality": pool.submit(_launch, run_prob, 4, 2,
                                   EvolveConfig(lam=4, kappa=150, max_gens=800), 16, seed=0),
            "failing": pool.submit(L.spawn_ranks, "repro_torch.launch.islands:no_such_target",
                                   {}, 2, device="cpu", timeout_s=TIMEOUT_S),
            "silent": pool.submit(L.spawn_ranks, FITNESS, {"problems": []}, 2,
                                  device="cpu", timeout_s=0.2),
            "cli": pool.submit(L.main, ["--device", "cpu", "--dataset", "iris", "--islands", "2",
                                        "--data", "1", "--gates", "30", "--max-gens", "60"]),
        }
        for name, (k, d) in RUNS.items():
            futures[name] = pool.submit(_launch, run_prob, k, d, RUN_CFG, 8)
    return {"futures": futures, "fit_probs": fit_probs, "run_prob": run_prob}


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("n_data", [2, 4])
def test_sharded_fitness_is_bitwise_the_references(launched, n_data):
    ranks = launched["futures"][f"fitness{n_data}"].result()
    for i, prob in enumerate(launched["fit_probs"]):
        want_ft, want_fv = prob["ref_fitness"]
        for rank in ranks:
            ft, fv = rank["sharded"][i]
            np.testing.assert_array_equal(_bits(ft), _bits(want_ft))
            np.testing.assert_array_equal(_bits(fv), _bits(want_fv))
            np.testing.assert_array_equal(_bits(rank["whole"][i][0]), _bits(want_ft))
            np.testing.assert_array_equal(_bits(rank["whole"][i][1]), _bits(want_fv))
        assert ranks[0]["launches"] == {"eval_population": 0, "eval_population_spans": 0}


def test_the_reference_island_programs_fitness_is_reproduced(launched):
    """The reference's final parents and bests, evaluated by the port's
    sharded eval (D = 2, gloo), give its fitness values bitwise; at C = 4
    some of them differ between the two class-sum orders, so the match
    pins the order."""
    out = launched["futures"]["reference"].result()
    ref = json.loads(out.split("RESULT ", 1)[1])
    probs, wants, discriminating = [], [], 0
    for c in (3, 4):
        res = ref[str(c)]
        prob = _problem(*_rule_bits(700, c, seed=0), c, pad=2, n_nodes=30)
        for g in ("parent", "best"):
            p = dict(prob, genomes=genome_from_arrays(
                *(np.asarray(res[f"{g}.{f}"], np.int32) for f in ("gate_fn", "edge_src",
                                                                   "out_src"))))
            probs.append(p)
        wants.append(res)
    ranks = L.spawn_ranks(FITNESS, _payload(probs), 2, device="cpu", timeout_s=TIMEOUT_S)
    for j, (c, res) in enumerate(zip((3, 4), wants)):
        (p_train, _), (b_train, b_val) = ranks[0]["sharded"][2 * j:2 * j + 2]
        np.testing.assert_array_equal(_bits(p_train), np.asarray(res["parent_fit"], np.uint32))
        np.testing.assert_array_equal(_bits(b_val), np.asarray(res["best_val"], np.uint32))
        np.testing.assert_array_equal(_bits(b_train), np.asarray(res["best_train"], np.uint32))
        for mine, other in zip(ranks[1]["sharded"][2 * j:2 * j + 2],
                               ranks[0]["sharded"][2 * j:2 * j + 2]):
            assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(mine, other))
        if c == 4:
            discriminating = _orders_differ(probs[2 * j:2 * j + 2])
    assert discriminating > 0


class _Keyed:
    """Stands in for an island's generator: its key in the reference's
    draw sequence."""

    def __init__(self, key):
        self.key = key


@functools.lru_cache(maxsize=None)
def _ref_draws(ref_spec, rate: float, lam: int):
    """The reference's draws of one generation, compiled once per case."""
    @jax.jit
    def draws(key, gate_fn, edge_src, out_src):
        key, k_mut, k_sel = jax.random.split(key, 3)
        children = ref_mutate_children(k_mut, RefGenome(gate_fn, edge_src, out_src),
                                       ref_spec, rate, lam)
        return key, children, jax.random.uniform(k_sel, (lam,))

    return draws


def _replaying(monkeypatch, ref_spec, cfg) -> None:
    """Make `evolve_islands_plain` draw as the reference's island program
    does: island i's key is the i-th of ``split(key(0), 4)``; `init_state`
    splits off ``k_init`` for the first parent, and every generation splits
    (key, k_mut, k_sel) for the λ children and the tie-break uniforms (the
    reference's `generation_step`).  The port's `init_state` and `advance`
    run on those draws; the plain loop's freezing, ring, gated accept and
    termination are its own."""
    from repro_torch.core import evolve as V
    from repro_torch.core import islands as I

    keys = jax.random.split(jax.random.key(0), 4)
    draws = _ref_draws(ref_spec, cfg.rate(ref_spec), cfg.lam)

    def init_state(gen, spec, eval_fn):
        k_init, gen.key = jax.random.split(gen.key)
        parent = genome_from_arrays(*ref_init_genome(k_init, ref_spec))
        return V.init_state(None, spec, eval_fn, seed_genome=parent)

    def generation_step(state, gen, spec, cfg, eval_fn):
        gen.key, children, u = draws(gen.key, *(a.numpy() for a in state.parent))
        children = genome_from_arrays(*children)
        return V.advance(state, children, *eval_fn(children), np.asarray(u), cfg)

    monkeypatch.setattr(I, "island_generator", lambda seed, i: _Keyed(keys[i]))
    monkeypatch.setattr(I, "init_state", init_state)
    monkeypatch.setattr(I, "generation_step", generation_step)


def _ref_island(res: dict, i: int) -> dict:
    """Island ``i``'s final state in the reference program's output."""
    out = {k: np.uint32(res[k][i]) for k in REF_FIELDS}
    out |= {k: int(res[k][i]) for k in ("since", "gen")}
    out |= {f"{g}.{f}": np.asarray(res[f"{g}.{f}"][i], np.int32)
            for g in ("parent", "best") for f in ("gate_fn", "edge_src", "out_src")}
    return out


def _port_island(state) -> dict:
    out = {k: _bits(getattr(state, k)) for k in REF_FIELDS}
    out |= {k: int(getattr(state, k)) for k in ("since", "gen")}
    out |= {f"{g}.{f}": getattr(getattr(state, g), f).numpy()
            for g in ("parent", "best") for f in ("gate_fn", "edge_src", "out_src")}
    return out


def _same_island(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_the_reference_island_program_replays_through_the_plain_loop(launched, monkeypatch,
                                                                      case):
    """The reference's island program (4 islands × 2 data shards), its
    draws fed to `evolve_islands_plain`: every island's final genomes,
    fitnesses, γ/κ bookkeeping and generation count equal the reference's.
    The distributed run is held to the plain loop by the tests below."""
    ref = json.loads(launched["futures"]["reference"].result().split("RESULT ", 1)[1])[case]
    c, kw, every = REF_CASES[case]
    prob = _problem(*_rule_bits(700, c, seed=0), c, pad=2, n_nodes=30)
    cfg = EvolveConfig(**kw)
    _replaying(monkeypatch, prob["ref_spec"], cfg)
    got = evolve_islands_plain(0, prob["spec"], cfg, IslandConfig(every, 2), 4,
                               *_port_data(prob))
    want = [_ref_island(ref, i) for i in range(4)]
    for i, state in enumerate(got):
        mine = _port_island(state)
        bad = [k for k in want[i] if not np.array_equal(mine[k], want[i][k])]
        assert not bad, (i, bad)
    # the replay sees migration: without it the islands end elsewhere
    _replaying(monkeypatch, prob["ref_spec"], cfg)
    alone = evolve_islands_plain(0, prob["spec"], cfg, IslandConfig(10**9, 2), 4,
                                 *_port_data(prob))
    assert not all(_same_island(_port_island(s), w) for s, w in zip(alone, want))
    if case == "3":  # islands stopped at different generations, so some froze
        assert len({w["gen"] for w in want}) > 1 and min(w["gen"] for w in want) < cfg.max_gens


def _orders_differ(pair) -> int:
    """How many of the parents' train and the bests' train and val
    fitnesses change with the class-sum order."""
    from repro_torch.core import fitness as F
    from repro_torch.kernels.program import compile_program
    from repro_torch.kernels import ref as plain
    from repro_torch.core.genome import opcodes

    n = 0
    for prob, masks in ((pair[0], (0,)), (pair[1], (0, 1))):
        data, mtr, mva = _port_data(prob)
        g = prob["genomes"]
        out = plain.eval_program(compile_program(opcodes(g, prob["spec"]), g.edge_src,
                                                 g.out_src, prob["spec"].n_inputs), data.x_words)
        for m in masks:
            c, k = F.confusion_counts(out, data, (mtr, mva)[m])
            n += int(np.sum(balanced_accuracy_from_counts(c, k, in_loop=True)
                            != balanced_accuracy_from_counts(c, k, in_loop=False)))
    return n


def _same_state(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.parent, b.parent))
            and all(torch.equal(x, y) for x, y in zip(a.best, b.best))
            and all(_bits(getattr(a, f)) == _bits(getattr(b, f))
                    for f in ("parent_fit", "best_val", "best_train", "ref_val"))
            and a.since == b.since and a.gen == b.gen)


@pytest.mark.parametrize("run", ["2x2", "4x1", "1x2"])
def test_a_distributed_run_equals_the_plain_version(launched, run):
    k, d = RUNS[run]
    got = launched["futures"][run].result()
    prob = launched["run_prob"]
    want = evolve_islands_plain(3, prob["spec"], RUN_CFG, IslandConfig(8, d), k,
                                *_port_data(prob))
    assert len(got.states) == k
    assert all(_same_state(a, b) for a, b in zip(got.states, want))
    assert all(0 < s.gen <= RUN_CFG.max_gens for s in got.states)
    # every rank of an island made that island's evaluations, none more
    for r in got.ranks:
        assert r["timings"]["evaluations"] == int(got.states[r["island"]].gen) + 1
        assert r["timings"]["iterations"] == max(int(s.gen) for s in got.states)
        assert r["launches"]["eval_population"] == 0  # the plain versions on the CPU
    if k == 1:  # a ring of one is not evolve_packed: its migrations take its own best
        solo = evolve_islands_plain(3, prob["spec"], RUN_CFG, IslandConfig(10**9, d), k,
                                    *_port_data(prob))
        assert not _same_state(solo[0], want[0])


def test_the_shard_count_does_not_change_the_run(launched):
    one, two = (launched["futures"][r].result() for r in ("2x1", "2x2"))
    assert all(_same_state(a, b) for a, b in zip(one.states, two.states))


def test_four_islands_on_two_shards_learn_the_rule(launched):
    run = launched["futures"]["quality"].result()
    best = best_island(run.states)
    assert float(best.best_val) > 0.8, float(best.best_val)
    assert len(run.ranks) == 8 and {r["island"] for r in run.ranks} == {0, 1, 2, 3}


def test_best_island_takes_the_first_on_a_tie():
    class S:
        def __init__(self, v):
            self.best_val = np.float32(v)

    states = [S(0.5), S(0.9), S(0.9), S(0.1)]
    assert best_island(states) is states[1]


def test_a_failing_or_silent_rank_fails_the_launch(launched):
    with pytest.raises(L.IslandLaunchError, match="no_such_target"):
        launched["futures"]["failing"].result()
    with pytest.raises(L.IslandLaunchError, match="did not finish within"):
        launched["futures"]["silent"].result()


def test_the_launcher_runs_from_its_command_line(launched):
    assert launched["futures"]["cli"].result() == 0


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = _problem(*_rule_bits(100, 2, seed=0), 2, pad=1, n_nodes=10)
    with pytest.raises(NoCudaDeviceError):
        evolve_islands(0, prob["spec"], RUN_CFG, IslandConfig(), *_port_data(prob))
    with pytest.raises(NoCudaDeviceError):
        L.launch_islands(0, prob["spec"], RUN_CFG, IslandConfig(), 1, *_port_data(prob))
    with pytest.raises(NoCudaDeviceError):
        L.main(["--dataset", "iris"])


def test_shards_must_split_the_words():
    prob = _problem(*_rule_bits(100, 2, seed=0), 2, pad=1, n_nodes=10)
    data, mtr, mva = _port_data(prob)
    assert data.x_words.shape[1] % 3 and pad_words_for(3) == 3
    from repro_torch.core.islands import shard_of

    with pytest.raises(ValueError, match="pad_words_for"):
        shard_of(data, mtr, mva, 0, 3, "cpu")
