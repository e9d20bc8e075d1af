"""The plain reference and the kernels' yardstick against worked examples."""
import numpy as np
import pytest

from perfbench import tabular, work
from perfbench.drivers import common
from perfbench.reference import circuits as ref

NAMES = ("AND", "OR", "NAND", "NOR", "XOR", "XNOR", "NOT", "BUF")


def truth_words():
    """Inputs a, b over the four rows (a, b) = (0,0), (1,0), (0,1), (1,1)."""
    return ref.pack(np.array([[0, 0], [1, 0], [0, 1], [1, 1]], bool))


@pytest.mark.parametrize("gates, edges, want", [
    # g0 = AND(a, b); g1 = NOR(a, g0); g2 = OR(g0, g1)
    ((0, 3, 1), ((0, 1), (0, 2), (2, 3)), [1, 0, 1, 1]),
    # g0 = NAND(a, b); g1 = XOR(g0, b); g2 = NOT(g1)
    ((2, 4, 6), ((0, 1), (2, 1), (3, 0)), [0, 0, 1, 0]),
    # g0 = XNOR(a, b); g1 = BUF(a); g2 = AND(g0, g1): only (1, 1)
    ((5, 7, 0), ((0, 1), (0, 0), (2, 3)), [0, 0, 0, 1]),
])
def test_three_gate_circuits(gates, edges, want):
    out = ref.evaluate(NAMES, gates, edges, [4], truth_words())
    assert ref.codes(out, 4).tolist() == want


def test_pack_puts_row_r_at_bit_r_of_its_word():
    bits = np.zeros((40, 2), bool)
    bits[[0, 5, 33], 0] = True
    bits[31, 1] = True
    words = ref.pack(bits)
    assert words.shape == (2, 2) and words.dtype == np.uint32
    assert words[0].tolist() == [(1 << 0) | (1 << 5), 1 << 1]
    assert words[1].tolist() == [1 << 31, 0]


def test_quantile_encoding_counts_edges_at_or_below():
    x = np.arange(8, dtype=np.float32)[:, None]
    edges = ref.quantile_edges(x, 2)           # quartiles of 0..7
    assert edges[0].tolist() == [1.75, 3.5, 5.25]
    bits = ref.encode(x, edges, 2)
    bucket = bits[:, 0] + 2 * bits[:, 1]
    assert bucket.tolist() == [0, 0, 1, 1, 2, 2, 3, 3]


def test_balanced_accuracy_is_the_mean_recall_in_float32():
    y = np.array([0, 0, 0, 1, 1, 1, 1, 1, 1, 1])
    code = np.array([0, 0, 1, 1, 1, 1, 1, 1, 0, 0])
    mask = np.ones(10, bool)
    want = np.float32(np.float32(np.float32(2) / np.float32(3))
                      + np.float32(np.float32(5) / np.float32(7))) / np.float32(2)
    assert ref.balanced_accuracy(code, y, mask, 2) == float(want)
    assert ref.balanced_accuracy(code, y, mask, 2, "bfloat16") != float(want)
    # a class absent under the mask drops out of the mean
    only0 = y == 0
    assert ref.balanced_accuracy(code, y, only0, 2) == float(np.float32(2) / np.float32(3))


def test_live_work_counts_gates_an_output_reaches():
    # inputs 0..2; g0 = AND(0, 1) (id 3), g1 = NOT(2) (id 4, reads one operand),
    # g2 = OR(3, 4) (id 5), g3 = AND(0, 2) (id 6, dead)
    opc, edge = [0, 6, 1, 0], [[0, 1], [2, 0], [3, 4], [0, 2]]
    assert work.live_work(opc, edge, [5], 3, 3) == (3, 3)
    assert work.live_work(opc, edge, [5], 3, 2) == (3, 2)      # row 2 at the width
    assert work.live_work(opc, edge, [4], 3, 3) == (1, 1)      # NOT reads row 2 only
    assert work.live_work(opc, edge, [0], 3, 3) == (0, 1)      # a tap of an input


def test_bytes_and_ops_of_a_launch():
    a = work.live_set([0, 0], [[0, 1], [3, 2]], [4], 3, 3)
    b = work.live_set([0, 0], [[0, 2], [1, 2]], [3], 3, 3)
    assert a == (2, frozenset({0, 1, 2})) and b == (1, frozenset({0, 2}))
    # rows shared by the two circuits are read once; ops are per circuit
    assert work.program_work([a, b], 1, 10) == (4 * (3 * 3 + 2 + 3 * 10 + 2 * 10), 3 * 10)
    assert work.spans_work([(2, 3, 4), (1, 2, 8)], 1) == (
        4 * (6 + 1 + 3 + 12 + 4) + 4 * (3 + 1 + 3 + 16 + 8), 2 * 4 + 8)
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)


def test_reference_ids_equal_the_programs_on_the_cpu():
    cfg = {"n_gates": 60, "fn_set": ["AND", "OR", "NAND", "NOR"], "classes": 2,
           "encodings": [{"strategy": "quantile", "bits": 4}]}
    x, _ = tabular.make_table("higgs", 700, 6, 2, 5)
    edges = ref.quantile_edges(x, 4)
    rng = np.random.RandomState(3)
    for _ in range(5):
        genome = common.seeded_genome(rng, 24, cfg)
        want = common.reference_ids(cfg, genome, ref.pack(ref.encode(x, edges, 4)), len(x))
        got = common.servable(genome, edges, cfg).predict(x, device="cpu")
        np.testing.assert_array_equal(got, want)
