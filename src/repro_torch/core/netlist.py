"""Host-side netlist extraction from an evolved genome (paper §4.1–4.2).

The evolved graph contains inactive material (the neutral-drift substrate);
synthesis keeps only nodes on a path to an output.  The netlist also records
which *input bits* are actually consumed — the paper sizes the input buffer
to exactly those bits (§3.6: "holds only the necessary bits").

Host code: the genome's tensors are read through numpy.  The netlist keeps
the genome's ids as they are — it does not canonicalise out-of-contract ids
as `kernels/program.py` does — and `eval_netlist` reads an id that no node
has written as zero.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import gates
from repro_torch.core.genome import CircuitSpec, Genome, _np


@dataclasses.dataclass(frozen=True)
class NetNode:
    nid: int          # global id (I + node index)
    opcode: int
    srcs: tuple[int, ...]  # operand ids (2, or 1 for NOT/BUF)


@dataclasses.dataclass(frozen=True)
class Netlist:
    n_inputs: int
    n_outputs: int
    nodes: tuple[NetNode, ...]       # active nodes, topological order
    out_src: tuple[int, ...]         # output taps (global ids)
    used_inputs: tuple[int, ...]     # input bit ids actually consumed

    @property
    def n_gates(self) -> int:
        return len(self.nodes)

    def logic_ge(self) -> float:
        """NAND2-equivalent count of the combinational logic (summed in
        node order: the hardware model's LUT count depends on the float)."""
        return float(sum(gates.NAND2_EQUIV[n.opcode] for n in self.nodes))

    def buffer_bits(self) -> int:
        """Registered I/O bits (input buffer sized to used bits + outputs)."""
        return len(self.used_inputs) + self.n_outputs

    def depth(self) -> int:
        """Logic levels on the longest input→output path."""
        lvl: dict[int, int] = {i: 0 for i in range(self.n_inputs)}
        for n in self.nodes:
            lvl[n.nid] = 1 + max((lvl[s] for s in n.srcs), default=0)
        return max((lvl.get(s, 0) for s in self.out_src), default=0)


def extract(genome: Genome, spec: CircuitSpec) -> Netlist:
    """Mark-and-sweep active extraction, preserving topological order."""
    g = Genome(*(_np(a) for a in genome))
    im, n = spec.n_inputs, spec.n_nodes
    fn_table = np.asarray(spec.fn_set)
    ops = fn_table[g.gate_fn]

    active = np.zeros(n, dtype=bool)
    stack = [int(s) - im for s in g.out_src if int(s) >= im]
    while stack:
        i = stack.pop()
        if i < 0 or active[i]:
            continue
        active[i] = True
        op = int(ops[i])
        arity = 1 if op in (gates.NOT_A, gates.BUF_A) else 2
        for s in g.edge_src[i, :arity]:
            if int(s) >= im:
                stack.append(int(s) - im)

    used_inputs: set[int] = set()
    nodes = []
    for i in range(n):
        if not active[i]:
            continue
        op = int(ops[i])
        arity = 1 if op in (gates.NOT_A, gates.BUF_A) else 2
        srcs = tuple(int(s) for s in g.edge_src[i, :arity])
        for s in srcs:
            if s < im:
                used_inputs.add(s)
        nodes.append(NetNode(nid=im + i, opcode=op, srcs=srcs))
    for s in g.out_src:
        if int(s) < im:
            used_inputs.add(int(s))

    return Netlist(
        n_inputs=im,
        n_outputs=spec.n_outputs,
        nodes=tuple(nodes),
        out_src=tuple(int(s) for s in g.out_src),
        used_inputs=tuple(sorted(used_inputs)),
    )


def eval_netlist(net: Netlist, x_bits: np.ndarray) -> np.ndarray:
    """Pure-python netlist interpreter (oracle for the emitted RTL).

    x_bits: uint8[R, I] → uint8[R, O].
    """
    x_bits = np.asarray(x_bits, dtype=np.uint8)
    vals: dict[int, np.ndarray] = {i: x_bits[:, i] for i in range(net.n_inputs)}
    zero = np.zeros(x_bits.shape[0], dtype=np.uint8)
    for node in net.nodes:
        a = vals.get(node.srcs[0], zero)
        b = vals.get(node.srcs[1], zero) if len(node.srcs) > 1 else a
        op = node.opcode
        if op == gates.AND:
            r = a & b
        elif op == gates.OR:
            r = a | b
        elif op == gates.NAND:
            r = 1 - (a & b)
        elif op == gates.NOR:
            r = 1 - (a | b)
        elif op == gates.XOR:
            r = a ^ b
        elif op == gates.XNOR:
            r = 1 - (a ^ b)
        elif op == gates.NOT_A:
            r = 1 - a
        else:
            r = a
        vals[node.nid] = r.astype(np.uint8)
    out = np.stack([vals.get(s, zero) for s in net.out_src], axis=1)
    return out.astype(np.uint8)
