"""Live-gate programs in the PyTorch port against the reference, bitwise.

`repro_torch.kernels.program.compile_program` compacts genomes to their
live gates and canonicalises ids; `repro_torch.kernels.ref.eval_program*`
run the result as the CUDA kernels do.  Both are held here to the
reference's jnp oracle on the same genomes and words: random valid
genomes made by the reference, genomes padded by the reference's
`pad_genome`, and corrupt genomes (negative, forward and past-the-end ids,
opcodes outside the table) made from a numpy seed.  Each case runs on both
routes of `compile_program`: the native one, whose programs must equal the
plain `_compile_numpy`'s bit for bit, and the NumPy one it takes where no
C++ compiler is found.  The search's own path (`make_eval_fn`: one buffer,
the fn-set lookup in the native pass) is held to the plain version
generation by generation.
"""
import sys
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gates
from repro.core.genome import CircuitSpec, init_genome, opcodes
from repro.core.netlist import extract
from repro.kernels import ref as RR
from repro.serve.planning.plan import pad_genome
from repro_torch import runtime
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.core import encoding as TE
from repro_torch.core import evolve as V
from repro_torch.core.genome import CircuitSpec as TorchSpec
from repro_torch.core.genome import opcodes as torch_opcodes
from repro_torch.kernels import program as PG
from repro_torch.kernels.program import (
    ZERO_GATE,
    CircuitProgram,
    _compile_numpy,
    compile_program,
)
from tests.torch_parity import i32, make_ref_servable, u32

ROUTES = ["native", "numpy"]
PROGRAM_FIELDS = ("gates", "n_live", "rows", "n_rows", "taps")

# (inputs, nodes, outputs, fn_set, words, population)
VALID = [
    (4, 10, 1, gates.FULL_FS, 2, 1),
    (8, 50, 1, gates.NAND_FS, 11, 4),
    (16, 100, 2, gates.FULL_FS, 32, 5),
    (32, 300, 4, tuple(range(8)), 128, 3),
    (100, 300, 2, gates.FULL_FS, 313, 2),
    (6, 17, 3, tuple(range(8)), 1, 7),
]
# (inputs, nodes, outputs, words, population)
CORRUPT = [(2, 2, 4, 3, 3), (4, 10, 2, 5, 4), (8, 40, 3, 7, 5), (16, 120, 4, 33, 3)]


def _words(rng, n_in, w):
    return rng.randint(0, 2**32, (n_in, w), dtype=np.uint64).astype(np.uint32)


def _valid(seed, n_in, n, n_out, fs, pop):
    spec = CircuitSpec(n_in, n, n_out, fs)
    gs = jax.vmap(lambda k: init_genome(k, spec))(
        jax.random.split(jax.random.key(seed), pop))
    return (np.asarray(opcodes(gs, spec)), np.asarray(gs.edge_src),
            np.asarray(gs.out_src))


def _corrupt(rng, n_in, n, n_out, pop):
    """Ids anywhere in [-3(I+n), 3(I+n)) and opcodes in [-3, 16)."""
    t = n_in + n
    return (rng.randint(-3, 16, (pop, n)).astype(np.int32),
            rng.randint(-3 * t, 3 * t, (pop, n, 2)).astype(np.int32),
            rng.randint(-3 * t, 3 * t, (pop, n_out)).astype(np.int32))


def _assert_same(a: CircuitProgram, b: CircuitProgram) -> None:
    assert a.n_inputs == b.n_inputs
    for k in PROGRAM_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype == torch.int32 and x.shape == y.shape, k
        assert torch.equal(x, y), k


def _hide_compiler(monkeypatch) -> None:
    """No ``c++`` and no built library: compiles take the NumPy route."""
    missing = Path(tempfile.gettempdir()) / "repro_torch_no_program_library.so"
    monkeypatch.setattr(PG, "_cxx", lambda: None)
    monkeypatch.setattr(PG, "library_path", lambda: missing)
    monkeypatch.setattr(PG, "_lib", None)
    monkeypatch.setattr(PG, "_lib_loaded", False)


def _compile(route, opc, edge, outs, n_in, **kw) -> CircuitProgram:
    """`compile_program` on ``route``, counted there: with its native
    library, held bit for bit to `_compile_numpy`; or where no C++
    compiler is found."""
    with pytest.MonkeyPatch.context() as mp:
        if route == "numpy":
            _hide_compiler(mp)
        before = PG.compile_counts()[route]
        prog = compile_program(opc, edge, outs, n_in, **kw)
        assert PG.compile_counts()[route] == before + 1
    if route == "native":
        _assert_same(prog, _compile_numpy(opc, edge, outs, n_in, **kw))
    return prog


def _ref_population(opc, edge, outs, xw):
    return np.asarray(RR.eval_population_packed(
        jnp.asarray(opc), jnp.asarray(edge), jnp.asarray(outs), jnp.asarray(xw)))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("n_in,n,n_out,fs,w,pop", VALID)
def test_program_matches_reference_on_valid_genomes(n_in, n, n_out, fs, w, pop, route):
    opc, edge, outs = _valid(3, n_in, n, n_out, fs, pop)
    xw = _words(np.random.RandomState(4), n_in, w)
    want = _ref_population(opc, edge, outs, xw)
    prog = _compile(route, opc, edge, outs, n_in)
    np.testing.assert_array_equal(u32(TR.eval_program(prog, i32(xw))), want)
    np.testing.assert_array_equal(u32(ops.eval_program(prog, i32(xw))), want)
    # the genome-level entry points compile, then run the program
    np.testing.assert_array_equal(
        u32(ops.eval_population(i32(opc), i32(edge), i32(outs), i32(xw))), want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_in,n,n_out,w,pop", CORRUPT)
def test_corrupt_genomes_match_reference(seed, n_in, n, n_out, w, pop, route):
    rng = np.random.RandomState(100 + seed)
    opc, edge, outs = _corrupt(rng, n_in, n, n_out, pop)
    xw = _words(rng, n_in, w)
    want = _ref_population(opc, edge, outs, xw)
    # the genome-level plain version and the program, both as the reference
    got = TR.eval_population_packed(i32(opc), i32(edge), i32(outs), i32(xw))
    np.testing.assert_array_equal(u32(got), want)
    prog = _compile(route, opc, edge, outs, n_in)
    np.testing.assert_array_equal(u32(TR.eval_program(prog, i32(xw))), want)
    uncompacted = _compile(route, opc, edge, outs, n_in, compact=False)
    np.testing.assert_array_equal(u32(TR.eval_program(uncompacted, i32(xw))), want)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(3))
def test_liveness_matches_netlist_extract(seed, route):
    """Arity-aware liveness, as the reference's active-node extraction."""
    spec = CircuitSpec(12, 60, 3, tuple(range(8)))
    g = init_genome(jax.random.key(seed), spec)
    net = extract(g, spec)
    prog = _compile(route, np.asarray(opcodes(g, spec))[None],
                    np.asarray(g.edge_src)[None],
                    np.asarray(g.out_src)[None], spec.n_inputs)
    n_live, n_rows = int(prog.n_live[0]), int(prog.n_rows[0])
    assert n_live == len(net.nodes) == prog.n_gates
    assert [int(op) for op in prog.gates[0, :, 0]] == [nd.opcode for nd in net.nodes]
    assert prog.rows[0, :n_rows].tolist() == list(net.used_inputs)
    for j, nd in enumerate(net.nodes):  # a NOT/BUF gate's b reads zero
        if len(nd.srcs) == 1:
            assert int(prog.gates[0, j, 2]) == prog.zero_code


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(3))
def test_program_codes_are_canonical(seed, route):
    rng = np.random.RandomState(seed)
    opc, edge, outs = _corrupt(rng, 8, 40, 3, 6)
    prog = _compile(route, opc, edge, outs, 8)
    zero = prog.zero_code
    assert prog.gates.dtype == torch.int32 and prog.gates.is_contiguous()
    assert ((prog.gates[..., 0] >= 0) & (prog.gates[..., 0] <= ZERO_GATE)).all()
    assert ((prog.gates[..., 1:] >= 0) & (prog.gates[..., 1:] <= zero)).all()
    assert ((prog.taps >= 0) & (prog.taps <= zero)).all()
    for p in range(prog.pop):
        nl, nr = int(prog.n_live[p]), int(prog.n_rows[p])
        rows = prog.rows[p, :nr]
        assert (rows >= 0).all() and (rows < 8).all() and (rows.diff() > 0).all()
        # gate j reads only staged rows, earlier gates or zero
        codes = prog.gates[p, :nl, 1:]
        for j in range(nl):
            for c in codes[j].tolist():
                assert c < nr or prog.n_rows_max <= c < prog.n_rows_max + j or c == zero
        # padding gates are zero gates
        assert (prog.gates[p, nl:, 0] == ZERO_GATE).all()


def _padded_shard(seeds):
    """Reference servables of different shapes padded into one shard's id
    space by the reference's `pad_genome`."""
    shapes = [(4, 2, 40, 2), (7, 4, 80, 3), (3, 2, 25, 4), (10, 4, 120, 10)]
    scs = [make_ref_servable(s, *shapes[s % len(shapes)]) for s in seeds]
    i_max = max(sc.spec.n_inputs for sc in scs)
    n_max = max(sc.spec.n_nodes for sc in scs)
    o_max = max(sc.spec.n_outputs for sc in scs)
    padded = [pad_genome(sc, i_max, n_max, o_max) for sc in scs]
    opc, edge, outs = (np.stack([p[k] for p in padded]) for k in range(3))
    in_w = np.asarray([sc.spec.n_inputs for sc in scs], np.int32)
    return opc, edge, outs, in_w, i_max


@pytest.mark.parametrize("route", ROUTES)
def test_padded_genomes_match_reference(route):
    opc, edge, outs, in_w, i_max = _padded_shard(range(4))
    xw = _words(np.random.RandomState(8), i_max, 9)
    want = _ref_population(opc, edge, outs, xw)
    prog = _compile(route, opc, edge, outs, i_max)
    np.testing.assert_array_equal(u32(TR.eval_program(prog, i32(xw))), want)


SPANS = [
    # (slots, live, span, word offsets): the tick's layout with pad slots
    ([2, 0, 3, 1, 0, 0], [1, 1, 1, 1, 0, 0], 4, [0, 4, 8, 12, 16, 20]),
    # repeats, misaligned / negative / off-the-end offsets, mixed live
    ([3, 3, 1, 0, 2], [1, 0, 1, 1, 1], 3, [1, -2, 100, -100, 7]),
    # slot ids out of range land as the reference's gather lands them
    ([-1, 9, -7, 2], [1, 1, 1, 1], 2, [0, 2, 4, 6]),
]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("slots,live,span,offs", SPANS)
def test_spans_program_matches_reference(slots, live, span, offs, corrupt, route):
    opc, edge, outs, in_w, i_max = _padded_shard(range(4))
    rng = np.random.RandomState(12)
    if corrupt:
        opc, edge, outs = _corrupt(rng, i_max, opc.shape[1], outs.shape[1], 4)
        in_w = np.asarray([i_max, 3, 0, i_max + 5], np.int32)
    slots, live, offs = (np.asarray(a, np.int32) for a in (slots, live, offs))
    xw = _words(rng, i_max, max(len(slots) * span, 24))
    s = jnp.asarray(slots)
    want = np.asarray(RR.eval_population_spans_packed(
        jnp.asarray(opc)[s], jnp.asarray(edge)[s], jnp.asarray(outs)[s],
        jnp.asarray(xw), jnp.asarray(offs), jnp.asarray(in_w)[s] * jnp.asarray(live),
        span_words=span))
    prog = _compile(route, opc, edge, outs, i_max)
    args = (i32(xw), i32(slots), i32(offs), i32(in_w), i32(live))
    got = TR.eval_program_spans(prog, *args, span_words=span)
    np.testing.assert_array_equal(u32(got), want)
    got = runtime.get_backend("torch-ref").eval_program_spans(prog, *args, span_words=span)
    np.testing.assert_array_equal(u32(got), want)


@pytest.mark.parametrize("route", ROUTES)
def test_uncompacted_program_keeps_every_gate(route):
    opc, edge, outs = _valid(5, 10, 50, 2, gates.FULL_FS, 3)
    full = _compile(route, opc, edge, outs, 10, compact=False)
    live = _compile(route, opc, edge, outs, 10)
    assert full.n_gates == 50 and (full.n_live == 50).all()
    assert (full.gates[..., 0] == i32(opc)).all()
    assert (live.n_live <= full.n_live).all() and live.n_gates < full.n_gates
    xw = i32(_words(np.random.RandomState(6), 10, 5))
    assert torch.equal(TR.eval_program(full, xw), TR.eval_program(live, xw))


def test_program_checks_its_inputs():
    opc, edge, outs = _valid(1, 4, 10, 1, gates.FULL_FS, 2)
    prog = compile_program(opc, edge, outs, 4)
    assert isinstance(prog, CircuitProgram) and prog.n_inputs == 4
    assert prog.to("cpu") is prog and prog.gates.device == torch.device("cpu")
    with pytest.raises(ValueError, match="input rows"):
        TR.eval_program(prog, torch.zeros((5, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="input rows"):
        TR.eval_program_spans(prog, torch.zeros((5, 3), dtype=torch.int32),
                              *(torch.zeros(1, dtype=torch.int32),) * 2,
                              torch.ones(2, dtype=torch.int32),
                              torch.ones(1, dtype=torch.int32), span_words=1)
    with pytest.raises(ValueError, match="disagree"):
        compile_program(opc, edge[:, :5], outs, 4)


def test_cuda_program_wrappers_raise_on_cpu_tensors():
    """No fallback: a CPU program goes nowhere near the plain version."""
    from repro_torch.kernels import circuit_eval
    opc, edge, outs = _valid(2, 4, 10, 1, gates.FULL_FS, 2)
    prog = compile_program(opc, edge, outs, 4)
    x = torch.zeros((4, 8), dtype=torch.int32)
    one = torch.zeros(2, dtype=torch.int32)
    before = [k.launches for k in circuit_eval.KERNELS]
    with pytest.raises(ValueError, match="CUDA tensor"):
        circuit_eval.eval_program(prog, x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        circuit_eval.eval_program_spans(prog, x, one, one, one, one, span_words=4)
    assert [k.launches for k in circuit_eval.KERNELS] == before


def test_two_threads_compile_at_once():
    """The native pass keeps no state of its own: two threads compiling
    different populations at once each get their own program, and no
    compile goes uncounted."""
    rng = np.random.RandomState(21)
    cases = [(*_corrupt(rng, n_in, n, 3, 5), n_in) for n_in, n in ((8, 40), (12, 90))]
    wants = [_compile_numpy(*case) for case in cases]
    PG.load_library()
    before = PG.compile_counts()
    start, errors = threading.Barrier(2), []

    def work(case, want):
        try:
            start.wait(timeout=30)
            for _ in range(300):
                _assert_same(compile_program(*case), want)
        except BaseException as err:  # reported below, in the test's thread
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=cw) for cw in zip(cases, wants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert PG.compile_counts() == {"native": before["native"] + 600,
                                   "numpy": before["numpy"]}


def test_without_a_compiler_the_numpy_route_is_taken_and_counted(monkeypatch):
    _hide_compiler(monkeypatch)
    opc, edge, outs = _valid(7, 16, 100, 2, gates.FULL_FS, 5)
    before = PG.compile_counts()
    prog = compile_program(opc, edge, outs, 16)
    assert PG.load_library() is None and not PG.library_path().exists()
    assert PG.compile_counts() == {"native": before["native"],
                                   "numpy": before["numpy"] + 1}
    _assert_same(prog, _compile_numpy(opc, edge, outs, 16))


def test_compile_counts_sum_to_compile_count(monkeypatch):
    opc, edge, outs = _valid(8, 6, 30, 1, gates.FULL_FS, 2)
    PG.reset_compile_count()
    assert PG.compile_counts() == {"native": 0, "numpy": 0} and PG.compile_count() == 0
    for _ in range(3):
        compile_program(opc, edge, outs, 6)
    _hide_compiler(monkeypatch)
    for _ in range(2):
        compile_program(opc, edge, outs, 6)
    assert PG.compile_counts() == {"native": 3, "numpy": 2}
    assert sum(PG.compile_counts().values()) == PG.compile_count() == 5


def _as_form(a: np.ndarray, form: str):
    t = torch.from_numpy(a)
    if form == "int64":
        return t.long()
    if form == "numpy":
        return a
    if form == "strided":  # the same values, not contiguous
        return t.transpose(0, 1).contiguous().transpose(0, 1)
    if form == "too_many":  # more genomes than the buffer holds
        return torch.cat([t, t])
    return t


@pytest.mark.parametrize("form", ["int32", "int64", "numpy", "strided", "too_many"])
def test_population_compiler_takes_contiguous_int32_host_tensors(form):
    """The search's bound compiler hands contiguous int32 host tensors of
    up to its population straight to the native pass, to the program of
    `_compile_numpy` of the looked-up opcodes, and refuses any others
    before it compiles."""
    rng = np.random.RandomState(31)
    fs = np.asarray((2, 7, 0, 6, 4, 1, 3), np.int32)
    _, edge, outs = _corrupt(rng, 9, 50, 2, 4)
    idx = rng.randint(0, len(fs), (4, 50)).astype(np.int32)
    compiler = PG.PopulationCompiler(4, 50, 9, 2, fs)
    before = PG.compile_counts()
    if form != "int32":
        with pytest.raises(ValueError, match="contiguous int32 host tensors"):
            compiler(*(_as_form(a, form) for a in (idx, edge, outs)))
        assert PG.compile_counts() == before
        return
    for pop in (1, 4):
        args = [_as_form(np.ascontiguousarray(a[:pop]), form) for a in (idx, edge, outs)]
        n_l, n_r = compiler(*args)
        got = PG.program_views(compiler.buf, pop, n_l, n_r, 2, 9)
        _assert_same(got, _compile_numpy(fs[idx[:pop]], edge[:pop], outs[:pop], 9))
    assert PG.compile_counts()["native"] == before["native"] + 2
    assert compiler.fits(3, 50, 2) and not compiler.fits(5, 50, 2)


class _CheckedEval(V.make_eval_fn):
    """`make_eval_fn` whose backend checks each generation's program: a
    set of contiguous views, back to back, of one buffer, equal to the
    NumPy program of the same genomes."""

    def __init__(self, *args):
        super().__init__(*args)
        self.inner, self.backend, self.checked = self.backend, self, 0

    def __call__(self, genomes, **kw):
        self.genomes = genomes
        return super().__call__(genomes, **kw)

    def eval_program(self, program, x_words):
        g = self.genomes
        _assert_same(program, _compile_numpy(torch_opcodes(g, self.spec), g.edge_src,
                                             g.out_src, self.spec.n_inputs))
        ts = [getattr(program, k) for k in PROGRAM_FIELDS]
        base = ts[0].untyped_storage().data_ptr()
        assert all(t.is_contiguous() and t.untyped_storage().data_ptr() == base
                   for t in ts)
        assert [t.storage_offset() for t in ts[1:]] == [
            t.storage_offset() + t.numel() for t in ts[:-1]]
        self.checked += 1
        return self.inner.eval_program(program, x_words)


def _seeded_search(gens: int):
    rng = np.random.RandomState(5)
    x = rng.randn(600, 4).astype(np.float32)
    y = (x[:, 0] + x[:, 1] * x[:, 2] > 0).astype(np.int64)
    enc = TE.fit_encoder(x, TE.EncodingConfig("quantile", 2))
    bits = TE.encode(enc, x)
    data = TE.pack_dataset(bits, y, 2, device="cpu")
    masks = TE.split_masks(600, data.x_words.shape[1], 0.5, seed=5, device="cpu")
    spec = TorchSpec(bits.shape[1], 40, 1, (2, 7, 0, 6, 4, 1))
    eval_fn = _CheckedEval(spec, data, *masks)
    cfg = V.EvolveConfig(lam=4)
    g = torch.Generator().manual_seed(9)
    state = V.init_state(g, spec, eval_fn)
    for _ in range(gens):
        state = V.generation_step(state, g, spec, cfg, eval_fn)
    assert eval_fn.checked == gens + 1
    return state


def test_search_is_the_same_through_both_routes(monkeypatch):
    """A seeded 200-generation search compiles through the native route,
    then through `_compile_numpy`, to the same states."""
    before = PG.compile_counts()
    fast = _seeded_search(200)
    assert PG.compile_counts()["native"] == before["native"] + 201
    _hide_compiler(monkeypatch)
    before = PG.compile_counts()
    plain = _seeded_search(200)
    assert PG.compile_counts() == {"native": before["native"],
                                   "numpy": before["numpy"] + 201}
    for k in ("parent", "best"):
        for a, b in zip(getattr(fast, k), getattr(plain, k)):
            assert torch.equal(a, b), k
    for k in ("parent_fit", "best_val", "best_train", "ref_val", "since", "gen"):
        a, b = np.asarray(getattr(fast, k)), np.asarray(getattr(plain, k))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert fast.gen == 200 and fast.best_val > 0.5
