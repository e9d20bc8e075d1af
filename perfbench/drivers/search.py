"""The 1+lambda search, closed loop: one searcher runs `core/evolve`'s
generations back to back for the window; a search that ends on kappa or G
is followed by one from a fresh parent drawn from the seed.

Set-up encodes and packs the table onto the card as the fit does, and runs
the first generations of a warm-up search.  After the window the reference
evaluates a sample of the window's generations, drawn from the seed: each
child's and the parent's fitness against the program's, bit for bit, and the
selection the generation made.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench import devtrace, work
from perfbench.drivers import common
from perfbench.harness import Run
from perfbench.reference import circuits as ref

STREAM_SPLIT, STREAM_WARM, STREAM_WINDOW, STREAM_SAMPLE = 1, 2, 3, 4


class _Recorder:
    """The program's fitness function, passed through: keeps the last
    call's children and fitnesses, and with ``calls`` a list, every call's
    children (for the traced launches' work)."""

    def __init__(self, inner):
        self.inner = inner
        self.clock = inner.clock
        self.last = None
        self.calls = None

    def __call__(self, genomes, *, in_loop: bool = True):
        ft, fv = self.inner(genomes, in_loop=in_loop)
        self.last = (genomes, ft, fv)
        if self.calls is not None:
            self.calls.append(genomes)
        return ft, fv


def _split_seed(ctx) -> int:
    return int(common.rng(ctx, STREAM_SPLIT).randint(0, 2**31 - 1))


def _torch_seed(ctx, stream: int) -> int:
    return int(common.rng(ctx, stream).randint(0, 2**31 - 1))


def _genome(g, i=None) -> dict:
    pick = (lambda a: a.numpy()) if i is None else (lambda a: a[i].numpy())
    return {"gate_fn": pick(g.gate_fn), "edge_src": pick(g.edge_src), "out_src": pick(g.out_src)}


def run(ctx) -> Run:
    import torch

    from repro_torch.core import encoding as E
    from repro_torch.core import evolve as EV
    from repro_torch.core import gates
    from repro_torch.core.genome import CircuitSpec

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    x, y = common.table(ctx)
    enc = common.encoding(cfg)
    rows = x.shape[0]
    n_out = common.n_outputs(cfg)

    encoder = E.fit_encoder(x, E.EncodingConfig(enc["strategy"], enc["bits"]))
    bits = E.encode(encoder, x)
    data = E.pack_dataset(bits, y, cfg["classes"], n_out, device=ctx.device)
    words = data.x_words.shape[1]
    split_seed = _split_seed(ctx)
    m_tr, m_va = E.split_masks(rows, words, cfg["val_fraction"], seed=split_seed,
                               device=ctx.device)
    spec = CircuitSpec(n_inputs=bits.shape[1], n_nodes=cfg["n_gates"], n_outputs=n_out,
                       fn_set=tuple(gates.GATE_NAMES.index(g) for g in cfg["fn_set"]))
    ecfg = EV.EvolveConfig(lam=cfg["lam"], p=cfg["p"], gamma=cfg["gamma"],
                           kappa=cfg["kappa"], max_gens=cfg["max_gens"])
    eval_fn = _Recorder(EV.make_eval_fn(spec, data, m_tr, m_va))

    gen = torch.Generator().manual_seed(_torch_seed(ctx, STREAM_WARM))
    state = EV.init_state(gen, spec, eval_fn)
    for _ in range(tr["warmup_generations"]):
        state = EV.generation_step(state, gen, spec, ecfg, eval_fn)
    del state
    if ctx.device == "cuda":
        torch.cuda.synchronize()

    sample = common.Reservoir(tr["check_generations"], common.rng(ctx, STREAM_SAMPLE))
    gen = torch.Generator().manual_seed(_torch_seed(ctx, STREAM_WINDOW))
    clock0 = dict(eval_fn.clock.seconds)
    setup_s = time.perf_counter() - ctx.t_start
    generations = searches = 0
    with devtrace.Profile(ctx.trace) as prof:
        eval_fn.calls = [] if ctx.trace else None
        t0 = time.perf_counter()
        t_end = t0 + ctx.seconds
        state = EV.init_state(gen, spec, eval_fn)
        searches = 1
        while time.perf_counter() < t_end:
            if not EV.not_terminated(state, ecfg):
                state = EV.init_state(gen, spec, eval_fn)
                searches += 1
                continue
            before = state
            state = EV.generation_step(state, gen, spec, ecfg, eval_fn)
            generations += 1
            sample.offer((before, eval_fn.last, state))
        window_s = time.perf_counter() - t0
    calls, eval_fn.calls = eval_fn.calls, None

    out = Run(setup_s=setup_s, window_s=window_s, attempted=generations, failed=0,
              kernel="eval_program_kernel", trace=prof.trace,
              device=common.device_record(ctx.device))
    out.counters = {"generations": generations, "searches": searches}
    out.phases = {k: v - clock0[k] for k, v in eval_fn.clock.seconds.items()}
    if calls:
        for genomes in calls:
            circuits = [common.live(cfg, _genome(genomes, i), spec.n_inputs)
                        for i in range(genomes.gate_fn.shape[0])]
            nbytes, ops = work.program_work(circuits, n_out, words)
            out.launch_bounds_s.append(work.bound_s(nbytes, ops))
            out.ops += ops
    del data, m_tr, m_va, eval_fn
    out.checks = check(cfg, x, y, split_seed, sample.items)
    out.control = lambda: check(cfg, x, y, split_seed, sample.items, "bfloat16")
    return out


def check(cfg: dict, x, y, split_seed: int, items: list,
          fitness_dtype: str = "float32") -> dict:
    """The reference's verdict on sampled generations: the largest gap
    between a fitness the program computed (each child's training and
    validation fitness, and the parent's training fitness) and the
    reference's, and the generations whose new parent, best circuit or
    count break the search's rules under the reference's fitnesses.
    ``fitness_dtype="bfloat16"`` puts the reference, computed in bfloat16,
    in the program's place: the control."""
    enc = common.encoding(cfg)
    edges = ref.quantile_edges(x, enc["bits"])
    x_words = ref.pack(ref.encode(x, edges, enc["bits"]))
    rows = x.shape[0]
    is_val = np.random.RandomState(split_seed).rand(rows) < cfg["val_fraction"]
    masks = (~is_val, is_val)

    def fitness(genome, dtype="float32"):
        code = ref.codes(ref.evaluate(cfg["fn_set"], genome["gate_fn"], genome["edge_src"],
                                      genome["out_src"], x_words), rows)
        return [ref.balanced_accuracy(code, y, m, cfg["classes"], dtype) for m in masks]

    gap, faults = 0.0, 0
    for before, (children, ft, fv), after in items:
        lam = children.gate_fn.shape[0]
        kids = [_genome(children, i) for i in range(lam)]
        want = np.array([fitness(k) for k in kids])                  # (lam, 2)
        got = (np.array([fitness(k, "bfloat16") for k in kids])
               if fitness_dtype != "float32" else np.stack([ft, fv], 1).astype(np.float64))
        parent_want = fitness(_genome(before.parent))[0]
        parent_got = (fitness(_genome(before.parent), fitness_dtype)[0]
                      if fitness_dtype != "float32" else float(before.parent_fit))
        gap = max(gap, float(np.abs(got - want).max()), abs(parent_got - parent_want))
        faults += not _follows_rules(before, kids, want, after)
    return {"fitness_gap": common.check(gap, 0.0),
            "selection_faults": common.check(faults, 0)}


def _same(genome: dict, g) -> bool:
    return all(np.array_equal(genome[k], getattr(g, k).numpy())
               for k in ("gate_fn", "edge_src", "out_src"))


def _follows_rules(before, kids: list, want: np.ndarray, after) -> bool:
    """Whether a generation's new state is one the rules allow, given the
    reference's fitnesses: the parent is replaced by a child of the highest
    training fitness when that is at least the parent's, and kept
    otherwise; the best circuit moves to a child of the highest validation
    fitness when that is above the best's; the count moves on by one."""
    ft, fv = want[:, 0], want[:, 1]
    top = ft.max()
    if top >= before.parent_fit:
        ok = after.parent_fit == top and any(
            _same(k, after.parent) for k, f in zip(kids, ft) if f == top)
    else:
        ok = after.parent_fit == before.parent_fit and _same(_genome(before.parent), after.parent)
    best = fv.max()
    if best > before.best_val:
        ok &= after.best_val == best and any(
            _same(k, after.best) for k, f in zip(kids, fv) if f == best)
    else:
        ok &= after.best_val == before.best_val and _same(_genome(before.best), after.best)
    return bool(ok and after.gen == before.gen + 1)
