"""Gate semantics of the PyTorch port against the reference, bitwise."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gates as RG
from repro_torch.core import gates as G
from tests.torch_parity import i32, u32


def test_opcode_table_matches_reference():
    assert (G.AND, G.OR, G.NAND, G.NOR, G.XOR, G.XNOR, G.NOT_A, G.BUF_A) == (
        RG.AND, RG.OR, RG.NAND, RG.NOR, RG.XOR, RG.XNOR, RG.NOT_A, RG.BUF_A)
    assert G.GATE_NAMES == RG.GATE_NAMES and G.N_OPCODES == RG.N_OPCODES
    assert G.FUNCTION_SETS == RG.FUNCTION_SETS


@pytest.mark.parametrize("op", range(8))
def test_truth_table(op):
    """Each opcode on all-zero / all-one words equals the scalar reference
    truth table in every bit."""
    for a, b in itertools.product((0, 1), repeat=2):
        wa = torch.full((1, 3), -a, dtype=torch.int32)  # 0 or 0xFFFFFFFF
        wb = torch.full((1, 3), -b, dtype=torch.int32)
        out = u32(G.apply_gates_packed(torch.tensor([op]), wa, wb))
        want = RG.apply_gate_bool(op, a, b)
        assert G.apply_gate_bool(op, a, b) == want
        assert (out == (0xFFFFFFFF if want else 0)).all(), (op, a, b)


@pytest.mark.parametrize("seed,k,w", [(0, 8, 5), (1, 40, 33), (2, 3, 1)])
def test_random_words_match_reference(seed, k, w):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 2**32, (k, w), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, (k, w), dtype=np.uint64).astype(np.uint32)
    a[:, 0] |= np.uint32(0x80000000)  # bit 31 set: the int32 sign bit
    ops = rng.randint(0, 8, k).astype(np.int32)
    ops[0] = 9  # outside the table: zero words in both
    want = np.asarray(RG.apply_gates_packed(
        jnp.asarray(ops), jnp.asarray(a), jnp.asarray(b)))
    got = u32(G.apply_gates_packed(torch.from_numpy(ops), i32(a), i32(b)))
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all()
