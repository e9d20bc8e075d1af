"""The port's hardware toolflow — netlist, Verilog/C emission, the Verilog
simulator and the hardware cost model — against the reference, on the CPU.

All of it is host code with no randomness, so every comparison is exact:
the same `Netlist` fields, the same emitted text byte for byte, the same
`HardwareReport` floats.  Genomes come from the reference's `init_genome`
(seeds 0-3, as `tests/test_toolflow.py` makes them) and are carried into
the port with `genome_from_arrays`.  The netlist keeps the reference's
semantics even outside the genome contract (an id no node wrote reads
zero; it is not canonicalised as `compile_program` does), so corrupt
genomes are held to the reference too: the same netlist, or the same
exception.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import encoding as RE
from repro.core import gates as RG
from repro.core import hardware as RH
from repro.core.genome import CircuitSpec as RefSpec
from repro.core.genome import Genome as RefGenome
from repro.core.genome import init_genome as ref_init_genome
from repro.core.netlist import eval_netlist as ref_eval_netlist
from repro.core.netlist import extract as ref_extract
from repro.core.verilog import simulate_verilog as ref_simulate_verilog
from repro.core.verilog import to_c as ref_to_c
from repro.core.verilog import to_verilog as ref_to_verilog
from repro_torch.core import api as A
from repro_torch.core import encoding as E
from repro_torch.core import gates, hardware
from repro_torch.core.genome import CircuitSpec, genome_from_arrays, opcodes
from repro_torch.core.netlist import eval_netlist, extract
from repro_torch.core.verilog import simulate_verilog, to_c, to_verilog
from repro_torch.data import load_dataset, train_test_split
from repro_torch.kernels import ref as plain
from repro_torch.kernels.program import compile_program
from tests.torch_parity import i32

# (inputs, gates, outputs, function set): the reference test's shape, the
# extended set (XOR/XNOR) and every opcode (NOT/BUF read one operand)
SPECS = {"full": (10, 50, 2, RG.FULL_FS), "extended": (10, 50, 2, RG.EXTENDED_FS),
         "all8": (12, 80, 3, tuple(range(8)))}
SEEDS = (0, 1, 2, 3)
TECHS = ((RH.SILICON_45NM, hardware.SILICON_45NM), (RH.FLEXIC_08UM, hardware.FLEXIC_08UM))


def _pair(spec_name: str, seed: int):
    """A reference genome and its spec in both packages."""
    n_in, n, n_out, fs = SPECS[spec_name]
    ref_spec = RefSpec(n_in, n, n_out, fs)
    g = ref_init_genome(jax.random.key(seed), ref_spec)
    return ref_spec, g, CircuitSpec(n_in, n, n_out, fs), genome_from_arrays(*g)


@pytest.fixture(params=[(s, k) for s in SPECS for k in SEEDS], ids=lambda p: f"{p[0]}-{p[1]}")
def nets(request):
    ref_spec, g, spec, pg = _pair(*request.param)
    return ref_extract(g, ref_spec), extract(pg, spec), spec, pg


def _fields(net) -> tuple:
    nodes = tuple((n.nid, n.opcode, n.srcs) for n in net.nodes)
    return (net.n_inputs, net.n_outputs, nodes, net.out_src, net.used_inputs,
            net.n_gates, net.logic_ge(), net.buffer_bits(), net.depth())


def _bits(n_rows: int, n_in: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 2, (n_rows, n_in)).astype(np.uint8)


def test_gate_tables_are_the_references():
    assert gates.VERILOG_EXPR == RG.VERILOG_EXPR
    assert gates.C_EXPR == RG.C_EXPR
    assert gates.NAND2_EQUIV == RG.NAND2_EQUIV
    assert len(gates.VERILOG_EXPR) == len(gates.C_EXPR) == len(gates.NAND2_EQUIV) == 8


def test_netlist_fields_equal_the_references(nets):
    ref, port, _, _ = nets
    assert _fields(port) == _fields(ref)
    assert type(port.logic_ge()) is float and type(port.depth()) is int


def test_verilog_and_c_text_is_byte_identical(nets):
    ref, port, _, _ = nets
    for kw in ({}, {"registered": True}, {"module_name": "clf_x", "registered": False}):
        assert to_verilog(port, **kw).encode() == ref_to_verilog(ref, **kw).encode()
    assert to_verilog(port, registered=True).endswith("endmodule\n")
    assert "// input buffer holds only consumed bits: [" in to_verilog(port, registered=True)
    for kw in ({}, {"fn_name": "predict_x"}):
        assert to_c(port, **kw).encode() == ref_to_c(ref, **kw).encode()


def test_eval_netlist_equals_the_plain_program_and_the_reference(nets):
    ref, port, spec, pg = nets
    bits = _bits(200, spec.n_inputs, 7)
    words = E.pack_bits_rows(bits, E.n_words(200))
    prog = compile_program(opcodes(pg, spec)[None], pg.edge_src[None], pg.out_src[None],
                           spec.n_inputs)
    out = plain.eval_program(prog, i32(words))[0]                 # [O, W]
    by_program = E.unpack_words(out, 200).numpy().T
    got = eval_netlist(port, bits)
    assert got.dtype == np.uint8 and got.shape == (200, spec.n_outputs)
    np.testing.assert_array_equal(got, by_program)
    np.testing.assert_array_equal(got, ref_eval_netlist(ref, bits))


def test_simulated_verilog_equals_the_netlist(nets):
    ref, port, spec, _ = nets
    bits = _bits(96, spec.n_inputs, 11)
    text = to_verilog(port)
    got = simulate_verilog(text, bits)
    np.testing.assert_array_equal(got, eval_netlist(port, bits))
    np.testing.assert_array_equal(got, ref_simulate_verilog(ref_to_verilog(ref), bits))


def test_tiny_classifier_report_is_exactly_the_references(nets):
    ref, port, _, _ = nets
    for rt, pt in TECHS:
        for design in ("tiny", "tiny-x"):
            want = RH.tiny_classifier_report(ref, rt, design)
            got = hardware.tiny_classifier_report(port, pt, design)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.row() == want.row()


@pytest.mark.parametrize("n_trees,depth,n_features", [
    (1, 6, 4), (10, 5, 7), (100, 6, 29), (200, 3, 1), (1000, 8, 476)])
def test_gbdt_hw_is_exactly_the_references(n_trees, depth, n_features):
    for rt, pt in TECHS:
        for bits in ((8, 8), (4, 6)):
            want = RH.gbdt_hw(n_trees, depth, n_features, *bits, tech=rt)
            got = hardware.gbdt_hw(n_trees, depth, n_features, *bits, tech=pt)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("sizes", [[4, 64, 64, 64, 2], [7, 64, 64, 64, 10],
                                   [29] + [512] * 9 + [2], [1, 2]])
def test_mlp_hw_is_exactly_the_references(sizes):
    for rt, pt in TECHS:
        for bits in ((2, 2), (4, 8)):
            want = RH.mlp_hw(sizes, *bits, tech=rt)
            got = hardware.mlp_hw(sizes, *bits, tech=pt)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)


def test_tech_constants_are_the_references():
    for rt, pt in TECHS:
        assert dataclasses.astuple(pt) == dataclasses.astuple(rt)
    assert hardware.ACTIVITY == RH.ACTIVITY
    assert (hardware.DFF_GE, hardware.GATES_PER_LUT) == (RH.DFF_GE, RH.GATES_PER_LUT)


def test_hardware_model_reproduces_paper_table2():
    """The port's cost model against the paper's own FlexIC numbers, as
    `tests/test_toolflow.py` holds the reference's."""
    xgb_blood = hardware.gbdt_hw(1, 6, 4, tech=hardware.FLEXIC_08UM)
    assert xgb_blood.area_mm2 == pytest.approx(5.4, rel=0.15)      # paper 5.4
    assert xgb_blood.power_mw == pytest.approx(4.12, rel=0.25)     # paper 4.12
    assert xgb_blood.ge_total == pytest.approx(1520, rel=0.15)     # paper 1520
    xgb_led = hardware.gbdt_hw(10, 5, 7, tech=hardware.FLEXIC_08UM)
    assert xgb_led.area_mm2 == pytest.approx(27.74, rel=0.2)       # paper 27.74
    assert xgb_led.ge_total == pytest.approx(7780, rel=0.15)       # paper 7780


# -- genomes outside the contract -------------------------------------------

def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the reference's own exception is the expectation
        return ("raises", type(e))


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_genomes_follow_the_reference(seed):
    """Negative, forward and past-the-end ids and fn-set indices outside
    the set: the port's netlist, its depth, emitted text and interpreter
    give the reference's results, or raise its exception."""
    n_in, n, n_out = 6, 20, 2
    t = n_in + n
    rng = np.random.RandomState(100 + seed)
    hi = t if seed % 2 else 2 * t  # odd seeds: no past-the-end ids
    gate_fn = rng.randint(-4, 4, n).astype(np.int32)
    edge = rng.randint(-t, hi, (n, 2)).astype(np.int32)
    outs = rng.randint(-t, hi, n_out).astype(np.int32)
    fs = tuple(range(8))
    ref_g = RefGenome(jnp.asarray(gate_fn), jnp.asarray(edge), jnp.asarray(outs))
    ref = _outcome(lambda: ref_extract(ref_g, RefSpec(n_in, n, n_out, fs)))
    port = _outcome(lambda: extract(genome_from_arrays(gate_fn, edge, outs),
                                    CircuitSpec(n_in, n, n_out, fs)))
    assert port[0] == ref[0]
    if ref[0] == "raises":
        assert port[1] is ref[1]
        return
    rnet, pnet = ref[1], port[1]
    for name in ("n_inputs", "n_outputs", "out_src", "used_inputs", "n_gates"):
        assert getattr(pnet, name) == getattr(rnet, name)
    assert [(x.nid, x.opcode, x.srcs) for x in pnet.nodes] == \
        [(x.nid, x.opcode, x.srcs) for x in rnet.nodes]
    assert _outcome(pnet.depth) == _outcome(rnet.depth)
    assert pnet.logic_ge() == rnet.logic_ge() and pnet.buffer_bits() == rnet.buffer_bits()
    assert to_verilog(pnet) == ref_to_verilog(rnet) and to_c(pnet) == ref_to_c(rnet)
    bits = _bits(64, n_in, seed)
    np.testing.assert_array_equal(eval_netlist(pnet, bits), ref_eval_netlist(rnet, bits))


# -- the four AutoTinyClassifier report methods ------------------------------

@pytest.fixture(scope="module")
def fitted():
    ds = load_dataset("blood")
    tr, _ = train_test_split(ds, 0.2, seed=0)
    clf = A.AutoTinyClassifier(n_gates=40, kappa=60, max_gens=150, device="cpu",
                               encodings=(E.EncodingConfig("quantile", 2),))
    return clf.fit(tr.x, tr.y, ds.n_classes), tr


def _as_reference(clf):
    g = clf.genome_
    spec = RefSpec(clf.spec_.n_inputs, clf.spec_.n_nodes, clf.spec_.n_outputs,
                   clf.spec_.fn_set)
    return RefGenome(*(jnp.asarray(a.numpy()) for a in g)), spec


def test_classifier_netlist_is_the_references(fitted):
    clf, _ = fitted
    g, spec = _as_reference(clf)
    assert _fields(clf.netlist()) == _fields(ref_extract(g, spec))


def test_classifier_verilog_and_c_are_the_references(fitted):
    clf, _ = fitted
    ref = ref_extract(*_as_reference(clf))
    assert clf.to_verilog() == ref_to_verilog(ref)
    assert clf.to_verilog("m", registered=True) == ref_to_verilog(ref, "m", True)
    assert clf.to_c() == ref_to_c(ref) and clf.to_c("f") == ref_to_c(ref, "f")


def test_classifier_hardware_report_is_the_references(fitted):
    clf, tr = fitted
    ref = ref_extract(*_as_reference(clf))
    assert dataclasses.astuple(clf.hardware_report()) == \
        dataclasses.astuple(RH.tiny_classifier_report(ref, RH.SILICON_45NM, "tiny"))
    assert dataclasses.astuple(clf.hardware_report(hardware.FLEXIC_08UM, "d")) == \
        dataclasses.astuple(RH.tiny_classifier_report(ref, RH.FLEXIC_08UM, "d"))
    # the netlist predicts what the classifier predicts
    bits = RE.encode(clf.encoder_, tr.x)
    out = eval_netlist(clf.netlist(), bits).astype(np.int64)
    ids = np.minimum((out << np.arange(out.shape[1])).sum(axis=1), clf.n_classes_ - 1)
    np.testing.assert_array_equal(ids, clf.predict(tr.x))


def test_report_methods_need_a_fit():
    clf = A.AutoTinyClassifier(device="cpu")
    for method in (clf.netlist, clf.to_verilog, clf.to_c, clf.hardware_report):
        with pytest.raises(RuntimeError, match="fit"):
            method()


def test_servable_program_needs_a_device():
    """`ServableCircuit.program` takes no default device: nothing runs on
    the CPU unless asked."""
    ref_spec, g, spec, pg = _pair("full", 0)
    enc = E.fit_encoder(np.random.RandomState(0).randn(64, 5).astype(np.float32),
                        E.EncodingConfig("quantile", 2))
    sc = A.ServableCircuit(spec, pg, enc, 3)
    with pytest.raises(TypeError):
        sc.program()
    assert sc.program("cpu").n_live.shape == (1,)
