"""Circuit evaluation in the PyTorch port against the reference, bitwise.

The port's plain versions (`repro_torch.kernels.ref`, what every wrapper
runs on CPU tensors) are held to the reference's jnp oracle and to its
Pallas TPU kernels run in interpret mode, on genomes made by the
reference.  The CUDA kernels themselves are compared with the plain
versions on the card (`test_torch_cuda_kernels.py`, ``chip_smoke.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as RE
from repro.core import gates
from repro.core.genome import CircuitSpec, init_genome, opcodes
from repro.kernels import ref as RR
from repro.runtime import PallasBackend
from repro_torch import runtime
from repro_torch.kernels import circuit_eval, ops
from repro_torch.kernels import ref as TR
from repro_torch.kernels.program import CircuitProgram, compile_program
from tests.torch_parity import i32, u32

# the reference's kernel sweep (tests/test_kernels.py)
SWEEP = [
    # (inputs, nodes, outputs, fn_set, rows, population)
    (4, 10, 1, gates.FULL_FS, 40, 1),
    (8, 50, 1, gates.NAND_FS, 333, 4),
    (16, 100, 2, gates.FULL_FS, 1000, 5),
    (32, 300, 4, gates.EXTENDED_FS, 4096, 3),
    (100, 300, 2, gates.FULL_FS, 10_000, 2),
    (6, 17, 3, gates.FULL_FS, 31, 7),  # odd everything (non-multiple-of-32)
]


def _problem(seed, n_inputs, n_nodes, n_outputs, fn_set, rows, pop):
    """Reference genomes (threefry) and seeded numpy bits, both sides."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (rows, n_inputs)).astype(np.uint8)
    xw = RE.pack_bits_rows(bits, RE.n_words(rows))
    spec = CircuitSpec(n_inputs, n_nodes, n_outputs, fn_set)
    gs = jax.vmap(lambda k: init_genome(k, spec))(
        jax.random.split(jax.random.key(seed), pop)
    )
    return opcodes(gs, spec), gs.edge_src, gs.out_src, xw, bits


def _port(opc, edge, outs, xw):
    return i32(opc), i32(edge), i32(outs), i32(xw)


@pytest.mark.parametrize("ninp,nnod,nout,fs,rows,pop", SWEEP)
def test_population_matches_reference(ninp, nnod, nout, fs, rows, pop):
    opc, edge, outs, xw, _ = _problem(7, ninp, nnod, nout, fs, rows, pop)
    want = np.asarray(RR.eval_population_packed(opc, edge, outs, jnp.asarray(xw)))
    got = TR.eval_population_packed(*_port(opc, edge, outs, xw))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(u32(got), want)
    # the device-dispatching wrapper and the plain backend agree on CPU
    np.testing.assert_array_equal(u32(ops.eval_population(*_port(opc, edge, outs, xw))), want)
    np.testing.assert_array_equal(
        u32(runtime.get_backend("torch-ref").eval_population(*_port(opc, edge, outs, xw))),
        want,
    )


@pytest.mark.parametrize("ninp,nnod,nout,fs,rows,pop", SWEEP[::2])
def test_single_circuit_matches_reference(ninp, nnod, nout, fs, rows, pop):
    opc, edge, outs, xw, _ = _problem(11, ninp, nnod, nout, fs, rows, 1)
    want = np.asarray(RR.eval_circuit_packed(opc[0], edge[0], outs[0], jnp.asarray(xw)))
    o, e, s, x = _port(opc[0], edge[0], outs[0], xw)
    np.testing.assert_array_equal(u32(TR.eval_circuit_packed(o, e, s, x)), want)
    np.testing.assert_array_equal(u32(ops.eval_circuit(o, e, s, x)), want)


def test_packed_matches_rowwise():
    """The packed layout itself, against the row-wise versions."""
    opc, edge, outs, xw, bits = _problem(3, 12, 40, 2, gates.FULL_FS, 200, 1)
    want_rows = np.asarray(RR.eval_circuit_rows(opc[0], edge[0], outs[0], jnp.asarray(bits)))
    got_rows = TR.eval_circuit_rows(i32(opc[0]), i32(edge[0]), i32(outs[0]),
                                    torch.from_numpy(bits))
    np.testing.assert_array_equal(got_rows.numpy(), want_rows)
    from repro_torch.core.encoding import unpack_words
    packed = TR.eval_circuit_packed(*_port(opc[0], edge[0], outs[0], xw))
    np.testing.assert_array_equal(unpack_words(packed, 200).numpy().T, got_rows.numpy())


SPANS = [
    # (inputs, nodes, outputs, pop, span, word offsets)
    (12, 24, 3, 5, 2, [0, 2, 4, 6, 8]),        # back to back (the tick)
    (12, 24, 3, 5, 2, [1, 3, 0, 7, 5]),        # misaligned
    (8, 40, 2, 4, 4, [9, 100, -3, -40]),       # off either end: wrapped, clamped
    (30, 300, 1, 2, 33, [0, 33]),              # ragged (not a multiple of 32)
]


@pytest.mark.parametrize("ninp,nnod,nout,pop,span,offs", SPANS)
def test_spans_match_reference(ninp, nnod, nout, pop, span, offs):
    rng = np.random.RandomState(5)
    spec = CircuitSpec(ninp, nnod, nout, gates.EXTENDED_FS)
    gs = [init_genome(jax.random.key(i), spec) for i in range(pop)]
    opc = jnp.stack([opcodes(g, spec) for g in gs])
    edge = jnp.stack([g.edge_src for g in gs])
    outs = jnp.stack([g.out_src for g in gs])
    w_total = max(pop * span, 12)
    xw = rng.randint(0, 2**32, (ninp, w_total), dtype=np.uint64).astype(np.uint32)
    woff = np.asarray(offs, np.int32)
    iw = rng.randint(0, ninp + 1, pop).astype(np.int32)
    want = np.asarray(RR.eval_population_spans_packed(
        opc, edge, outs, jnp.asarray(xw), jnp.asarray(woff), jnp.asarray(iw),
        span_words=span))
    args = (*_port(opc, edge, outs, xw), i32(woff), i32(iw))
    np.testing.assert_array_equal(
        u32(TR.eval_population_spans_packed(*args, span_words=span)), want)
    np.testing.assert_array_equal(
        u32(ops.eval_population_spans(*args, span_words=span)), want)
    one = TR.eval_circuit_span(*(a[0] for a in args[:3]), args[3],
                               int(woff[0]), int(iw[0]), span_words=span)
    np.testing.assert_array_equal(u32(one), want[0])


def test_spans_reject_span_beyond_buffer():
    args = (torch.zeros((1, 4), dtype=torch.int32), torch.zeros((1, 4, 2), dtype=torch.int32),
            torch.zeros((1, 1), dtype=torch.int32), torch.zeros((3, 8), dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="span_words"):
        TR.eval_population_spans_packed(*args, span_words=9)


def test_spans_isolation_edges_past_in_width_read_zeros():
    """Bits above in_width are invisible even to a genome that reads them."""
    rng = np.random.RandomState(0)
    spec = CircuitSpec(8, 10, 2, gates.FULL_FS)
    g = init_genome(jax.random.key(0), spec)
    opc, edge, outs = opcodes(g, spec)[None], g.edge_src[None], g.out_src[None]
    iw, woff = np.asarray([5], np.int32), np.asarray([0], np.int32)
    base = rng.randint(0, 2**32, (8, 4), dtype=np.uint64).astype(np.uint32)
    poisoned, clean = base.copy(), base.copy()
    poisoned[5:] = 0xDEADBEEF
    clean[5:] = 0
    # every input edge of this genome past the live width reads zero
    assert (np.asarray(g.edge_src) >= 5).any()
    outs_t = []
    for x in (poisoned, clean):
        outs_t.append(u32(TR.eval_population_spans_packed(
            *_port(opc, edge, outs, x), i32(woff), i32(iw), span_words=4)))
    np.testing.assert_array_equal(outs_t[0], outs_t[1])
    want = np.asarray(RR.eval_population_spans_packed(
        opc, edge, outs, jnp.asarray(poisoned), jnp.asarray(woff),
        jnp.asarray(iw), span_words=4))
    np.testing.assert_array_equal(outs_t[0], want)


# I = 2, n = 2, two BUF_A gates: (edge_src, out_src) of the cases where the
# reference's vals[id] wraps a negative id once and clamps into [0, I+n-1]
OUT_OF_CONTRACT = {
    "gate 1 reads -2": ([[0, 0], [-2, 0]], [3]),     # node 2
    "tap 4": ([[1, 0], [0, 0]], [4]),                # clamped to node 3
    "tap -1": ([[1, 0], [0, 0]], [-1]),              # node 3
    "tap -9": ([[1, 0], [0, 0]], [-9]),              # clamped to input row 0
    "forward operand": ([[3, 1], [2, 0]], [2, 3]),   # not yet written: zero
}


@pytest.mark.parametrize("case", list(OUT_OF_CONTRACT))
def test_out_of_contract_ids_match_reference(case):
    """Operand ids outside [0, I+i) and taps outside [0, I+n) read what the
    reference reads, in the genome-level plain version and the program."""
    edge, taps = OUT_OF_CONTRACT[case]
    opc = np.full((1, 2), gates.BUF_A, np.int32)
    edge, taps = np.asarray([edge], np.int32), np.asarray([taps], np.int32)
    rng = np.random.RandomState(0)
    for xw in (np.full((2, 3), 0xFFFFFFFF, np.uint32),
               rng.randint(0, 2**32, (2, 3), dtype=np.uint64).astype(np.uint32)):
        want = np.asarray(RR.eval_population_packed(
            jnp.asarray(opc), jnp.asarray(edge), jnp.asarray(taps), jnp.asarray(xw)))
        got = TR.eval_population_packed(*_port(opc, edge, taps, xw))
        np.testing.assert_array_equal(u32(got), want)
        prog = compile_program(opc, edge, taps, 2)
        np.testing.assert_array_equal(u32(TR.eval_program(prog, i32(xw))), want)


@pytest.mark.parametrize("case", [0, 5])
def test_plain_matches_pallas_interpret(case):
    """Two sweep cases against the reference's TPU kernel in interpret
    mode, the way the reference's own tests run it on the CPU."""
    ninp, nnod, nout, fs, rows, pop = SWEEP[case]
    opc, edge, outs, xw, _ = _problem(9, ninp, nnod, nout, fs, rows, pop)
    want = np.asarray(PallasBackend(interpret=True).eval_population(
        opc, edge, outs, jnp.asarray(xw)))
    np.testing.assert_array_equal(u32(TR.eval_population_packed(*_port(opc, edge, outs, xw))), want)


def test_spans_plain_matches_pallas_interpret():
    rng = np.random.RandomState(1)
    spec = CircuitSpec(12, 24, 3, gates.EXTENDED_FS)
    gs = [init_genome(jax.random.key(i), spec) for i in range(3)]
    opc = jnp.stack([opcodes(g, spec) for g in gs])
    edge = jnp.stack([g.edge_src for g in gs])
    outs = jnp.stack([g.out_src for g in gs])
    xw = rng.randint(0, 2**32, (12, 6), dtype=np.uint64).astype(np.uint32)
    woff = np.arange(3, dtype=np.int32) * 2
    iw = np.asarray([12, 7, 3], np.int32)
    want = np.asarray(PallasBackend(interpret=True).eval_population_spans(
        opc, edge, outs, jnp.asarray(xw), jnp.asarray(woff), jnp.asarray(iw),
        span_words=2))
    got = TR.eval_population_spans_packed(
        *_port(opc, edge, outs, xw), i32(woff), i32(iw), span_words=2)
    np.testing.assert_array_equal(u32(got), want)


def test_cuda_backend_raises_on_cpu_tensors():
    """The kernels never fall back to the plain version: CPU tensors raise,
    and nothing is counted as launched."""
    opc, edge, outs, xw, _ = _problem(2, 6, 17, 3, gates.FULL_FS, 31, 2)
    args = _port(opc, edge, outs, xw)
    before = [k.launches for k in circuit_eval.KERNELS]
    be = runtime.get_backend("cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        be.eval_population(*args)
    with pytest.raises(ValueError, match="CUDA tensor"):
        be.eval_circuit(*(a[0] for a in args[:3]), args[3])
    with pytest.raises(ValueError, match="CUDA tensor"):
        be.eval_population_spans(*args, torch.zeros(2, dtype=torch.int32),
                                 torch.full((2,), 6, dtype=torch.int32), span_words=1)
    assert [k.launches for k in circuit_eval.KERNELS] == before


def _program_of(n_gates, n_outputs, n_rows=0, pop=1, n_inputs=4, dtype=torch.int32):
    z = functools.partial(torch.zeros, dtype=dtype)
    return CircuitProgram(z((pop, n_gates, 3)), z(pop), z((pop, n_rows)), z(pop),
                          z((pop, n_outputs)), n_inputs)


def test_wrapper_checks_dtype_and_shape_before_anything_else():
    before = [k.launches for k in circuit_eval.KERNELS]
    with pytest.raises(ValueError):  # an int64 program
        circuit_eval.eval_program(_program_of(4, 1, dtype=torch.int64),
                                  torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):  # 1-D words
        circuit_eval.eval_program(_program_of(4, 1), torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):  # genome arrays instead of a program
        circuit_eval.eval_program(torch.zeros((1, 4), dtype=torch.int32),
                                  torch.zeros((4, 8), dtype=torch.int32))
    assert [k.launches for k in circuit_eval.KERNELS] == before


# n live gates (no staged rows), o taps: the table is [n+1][T]
@pytest.mark.parametrize("n,o,want", [(10, 1, 128), (300, 1, 128), (400, 4, 128),
                                      (1000, 2, 32), (1600, 2, 32)])
def test_threads_per_block_fits_shared_memory(n, o, want):
    t = circuit_eval.threads_per_block(_program_of(n, o), words=1 << 20, circuits=1)
    assert t == want and t % 32 == 0
    assert circuit_eval.smem_bytes(n + 1, n, o, t) <= circuit_eval.MAX_SMEM_BYTES
    assert 4 * ((n + 1) * t + n + o) <= circuit_eval.MAX_SMEM_BYTES


def test_threads_per_block_rejects_circuits_too_large():
    with pytest.raises(ValueError, match="does not fit"):
        circuit_eval.threads_per_block(_program_of(1800, 1), words=64, circuits=1)
    with pytest.raises(ValueError, match="does not fit"):
        circuit_eval.threads_per_block(_program_of(900, 1, n_rows=900), words=64,
                                       circuits=1)


# (words, circuits, want): the largest T that still gives 2 CTAs per SM
@pytest.mark.parametrize("words,circuits,want", [
    (3065, 1, 32),         # golden higgs predict: 96 CTAs at most
    (256, 12, 32),         # the smoke tick: 12 slots x 256 words
    (32768, 1, 64),        # 512 CTAs of 64 words; 256 of 128 would be too few
    (32768, 4, 128),
    (1, 1, 32),
])
def test_threads_per_block_fills_the_card(words, circuits, want):
    prog = _program_of(7, 1, n_rows=8)
    assert circuit_eval.threads_per_block(prog, words, circuits) == want


def test_backend_registry_and_capabilities():
    assert {"torch-ref", "cuda"} <= set(runtime.available_backends())
    for name in ("torch-ref", "cuda"):
        caps = runtime.get_backend(name).capabilities()
        assert caps.word_alignment == 1 and caps.span_offset_contract == "none"
        assert caps.supports_spans
        # only the kernels make span-launch units, as only the reference's
        # compiled backend makes executables
        assert caps.supports_aot == (name == "cuda")
        assert (caps.aot_format, caps.aot_format_version) == (
            ("repro-torch-span-launch", 1) if name == "cuda" else ("", 0))
        assert runtime.get_backend(name).span_alignment() == 1
    assert runtime.backend_for(torch.device("cpu")).name == "torch-ref"
    assert runtime.backend_for(torch.device("cuda")).name == "cuda"
    with pytest.raises(runtime.UnknownBackendError):
        runtime.get_backend("pallas")


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(runtime.NoCudaDeviceError):
        runtime.resolve_device(None)
    with pytest.raises(runtime.NoCudaDeviceError):
        runtime.resolve_backend(None)
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        runtime.resolve_device("meta")


def test_instrument_hook_wraps_each_launch():
    seen = []

    class Hook:
        def __init__(self, kind, **meta):
            seen.append((kind, meta))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    be = runtime.get_backend("torch-ref").instrument(Hook)
    assert be.name == "torch-ref" and be.span_alignment() == 1
    opc, edge, outs, xw, _ = _problem(4, 4, 10, 1, gates.FULL_FS, 40, 2)
    args = _port(opc, edge, outs, xw)
    be.eval_population(*args)
    be.eval_circuit(*(a[0] for a in args[:3]), args[3])
    be.eval_population_spans(*args, torch.zeros(2, dtype=torch.int32),
                             torch.full((2,), 4, dtype=torch.int32), span_words=1)
    assert [k for k, _ in seen] == ["eval_population", "eval_circuit",
                                    "eval_population_spans"]
    assert seen[2][1] == {"population": 2, "span_words": 1}
