"""Live-gate programs in the PyTorch port against the reference, bitwise.

`repro_torch.kernels.program.compile_program` compacts genomes to their
live gates and canonicalises ids; `repro_torch.kernels.ref.eval_program*`
run the result as the CUDA kernels do.  Both are held here to the
reference's jnp oracle on the same genomes and words: random valid
genomes made by the reference, genomes padded by the reference's
`pad_genome`, and corrupt genomes (negative, forward and past-the-end ids,
opcodes outside the table) made from a numpy seed.
"""
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
from repro_torch.kernels.program import ZERO_GATE, CircuitProgram, compile_program
from tests.torch_parity import i32, make_ref_servable, u32

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


def _ref_population(opc, edge, outs, xw):
    return np.asarray(RR.eval_population_packed(
        jnp.asarray(opc), jnp.asarray(edge), jnp.asarray(outs), jnp.asarray(xw)))


@pytest.mark.parametrize("n_in,n,n_out,fs,w,pop", VALID)
def test_program_matches_reference_on_valid_genomes(n_in, n, n_out, fs, w, pop):
    opc, edge, outs = _valid(3, n_in, n, n_out, fs, pop)
    xw = _words(np.random.RandomState(4), n_in, w)
    want = _ref_population(opc, edge, outs, xw)
    prog = compile_program(opc, edge, outs, n_in)
    np.testing.assert_array_equal(u32(TR.eval_program(prog, i32(xw))), want)
    np.testing.assert_array_equal(u32(ops.eval_program(prog, i32(xw))), want)
    # the genome-level entry points compile, then run the program
    np.testing.assert_array_equal(
        u32(ops.eval_population(i32(opc), i32(edge), i32(outs), i32(xw))), want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n_in,n,n_out,w,pop", CORRUPT)
def test_corrupt_genomes_match_reference(seed, n_in, n, n_out, w, pop):
    rng = np.random.RandomState(100 + seed)
    opc, edge, outs = _corrupt(rng, n_in, n, n_out, pop)
    xw = _words(rng, n_in, w)
    want = _ref_population(opc, edge, outs, xw)
    # the genome-level plain version and the program, both as the reference
    got = TR.eval_population_packed(i32(opc), i32(edge), i32(outs), i32(xw))
    np.testing.assert_array_equal(u32(got), want)
    prog = compile_program(opc, edge, outs, n_in)
    np.testing.assert_array_equal(u32(TR.eval_program(prog, i32(xw))), want)
    uncompacted = compile_program(opc, edge, outs, n_in, compact=False)
    np.testing.assert_array_equal(u32(TR.eval_program(uncompacted, i32(xw))), want)


@pytest.mark.parametrize("seed", range(3))
def test_liveness_matches_netlist_extract(seed):
    """Arity-aware liveness, as the reference's active-node extraction."""
    spec = CircuitSpec(12, 60, 3, tuple(range(8)))
    g = init_genome(jax.random.key(seed), spec)
    net = extract(g, spec)
    prog = compile_program(np.asarray(opcodes(g, spec))[None],
                           np.asarray(g.edge_src)[None],
                           np.asarray(g.out_src)[None], spec.n_inputs)
    n_live, n_rows = int(prog.n_live[0]), int(prog.n_rows[0])
    assert n_live == len(net.nodes) == prog.n_gates
    assert [int(op) for op in prog.gates[0, :, 0]] == [nd.opcode for nd in net.nodes]
    assert prog.rows[0, :n_rows].tolist() == list(net.used_inputs)
    for j, nd in enumerate(net.nodes):  # a NOT/BUF gate's b reads zero
        if len(nd.srcs) == 1:
            assert int(prog.gates[0, j, 2]) == prog.zero_code


@pytest.mark.parametrize("seed", range(3))
def test_program_codes_are_canonical(seed):
    rng = np.random.RandomState(seed)
    opc, edge, outs = _corrupt(rng, 8, 40, 3, 6)
    prog = compile_program(opc, edge, outs, 8)
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


def test_padded_genomes_match_reference():
    opc, edge, outs, in_w, i_max = _padded_shard(range(4))
    xw = _words(np.random.RandomState(8), i_max, 9)
    want = _ref_population(opc, edge, outs, xw)
    prog = compile_program(opc, edge, outs, i_max)
    np.testing.assert_array_equal(u32(TR.eval_program(prog, i32(xw))), want)


SPANS = [
    # (slots, live, span, word offsets): the tick's layout with pad slots
    ([2, 0, 3, 1, 0, 0], [1, 1, 1, 1, 0, 0], 4, [0, 4, 8, 12, 16, 20]),
    # repeats, misaligned / negative / off-the-end offsets, mixed live
    ([3, 3, 1, 0, 2], [1, 0, 1, 1, 1], 3, [1, -2, 100, -100, 7]),
    # slot ids out of range land as the reference's gather lands them
    ([-1, 9, -7, 2], [1, 1, 1, 1], 2, [0, 2, 4, 6]),
]


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("slots,live,span,offs", SPANS)
def test_spans_program_matches_reference(slots, live, span, offs, corrupt):
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
    prog = compile_program(opc, edge, outs, i_max)
    args = (i32(xw), i32(slots), i32(offs), i32(in_w), i32(live))
    got = TR.eval_program_spans(prog, *args, span_words=span)
    np.testing.assert_array_equal(u32(got), want)
    got = runtime.get_backend("torch-ref").eval_program_spans(prog, *args, span_words=span)
    np.testing.assert_array_equal(u32(got), want)


def test_uncompacted_program_keeps_every_gate():
    opc, edge, outs = _valid(5, 10, 50, 2, gates.FULL_FS, 3)
    full = compile_program(opc, edge, outs, 10, compact=False)
    live = compile_program(opc, edge, outs, 10)
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
