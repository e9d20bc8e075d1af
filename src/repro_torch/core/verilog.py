"""RTL emission (paper §4.1: "the sea of gates is automatically translated
into RTL, typically as multiple Verilog assign statements per output bit")
plus the C emission used by the FPGA/HLS flow (§4.2).

Also includes a miniature simulator for the *emitted Verilog text* so tests
can close the loop: kernel eval == netlist interpreter == emitted RTL.
The emitted text is the reference package's, byte for byte.
"""
from __future__ import annotations

import re

import numpy as np

from repro_torch.core import gates
from repro_torch.core.netlist import Netlist


def _sig(net: Netlist, sid: int) -> str:
    return f"x[{sid}]" if sid < net.n_inputs else f"n{sid}"


def to_verilog(net: Netlist, module_name: str = "tiny_classifier",
               registered: bool = False) -> str:
    """Emit the classifier as a Verilog module.

    registered=True wraps the combinational sea of gates with the paper's
    input/output buffers (§3.6) — DFFs on the *used* input bits and outputs.
    """
    lines = []
    if registered:
        lines.append(f"module {module_name} (")
        lines.append("  input  wire clk,")
        lines.append(f"  input  wire [{net.n_inputs - 1}:0] x_in,")
        lines.append(f"  output reg  [{net.n_outputs - 1}:0] y")
        lines.append(");")
        lines.append(f"  reg [{net.n_inputs - 1}:0] x;")
        used = ", ".join(str(i) for i in net.used_inputs)
        lines.append(f"  // input buffer holds only consumed bits: [{used}]")
        lines.append("  always @(posedge clk) begin")
        for i in net.used_inputs:
            lines.append(f"    x[{i}] <= x_in[{i}];")
        lines.append("  end")
    else:
        lines.append(f"module {module_name} (")
        lines.append(f"  input  wire [{net.n_inputs - 1}:0] x,")
        lines.append(f"  output wire [{net.n_outputs - 1}:0] y")
        lines.append(");")

    for node in net.nodes:
        a = _sig(net, node.srcs[0])
        b = _sig(net, node.srcs[1]) if len(node.srcs) > 1 else a
        expr = gates.VERILOG_EXPR[node.opcode].format(a=a, b=b)
        lines.append(f"  wire n{node.nid};")
        lines.append(f"  assign n{node.nid} = {expr};")

    if registered:
        lines.append("  always @(posedge clk) begin")
        for o, s in enumerate(net.out_src):
            lines.append(f"    y[{o}] <= {_sig(net, s)};")
        lines.append("  end")
    else:
        for o, s in enumerate(net.out_src):
            lines.append(f"  assign y[{o}] = {_sig(net, s)};")
    lines.append("endmodule")
    return "\n".join(lines) + "\n"


def to_c(net: Netlist, fn_name: str = "tiny_classifier_predict") -> str:
    """Emit the HLS-ready C function (paper §4.2 Composer input)."""
    lines = [
        "#include <stdint.h>",
        "",
        f"void {fn_name}(const uint8_t x[{net.n_inputs}], "
        f"uint8_t y[{net.n_outputs}]) {{",
        "#pragma HLS PIPELINE II=1",
    ]
    for node in net.nodes:
        a = _sig(net, node.srcs[0])
        b = _sig(net, node.srcs[1]) if len(node.srcs) > 1 else a
        expr = gates.C_EXPR[node.opcode].format(a=a, b=b)
        lines.append(f"  uint8_t n{node.nid} = (uint8_t){expr} & 1u;")
    for o, s in enumerate(net.out_src):
        lines.append(f"  y[{o}] = {_sig(net, s)} & 1u;")
    lines.append("}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Emitted-Verilog simulator (tests the *text*, not the netlist object)
# ---------------------------------------------------------------------------

_ASSIGN_RE = re.compile(r"assign\s+(\S+)\s*=\s*(.+);")


def simulate_verilog(verilog: str, x_bits: np.ndarray) -> np.ndarray:
    """Evaluate a combinational module emitted by :func:`to_verilog` on a
    batch of input vectors.  uint8[R, I] → uint8[R, O]."""
    x_bits = np.asarray(x_bits, dtype=np.uint8)
    r = x_bits.shape[0]
    env: dict[str, np.ndarray] = {}
    n_out = 0
    outputs: dict[int, np.ndarray] = {}

    def term(tok: str) -> np.ndarray:
        tok = tok.strip()
        m = re.fullmatch(r"x\[(\d+)\]", tok)
        if m:
            return x_bits[:, int(m.group(1))]
        return env[tok]

    def eval_expr(expr: str) -> np.ndarray:
        expr = expr.strip()
        neg = False
        while expr.startswith("~"):
            neg = not neg
            expr = expr[1:].strip()
        if expr.startswith("("):
            if not expr.endswith(")"):
                raise ValueError(f"unbalanced expression: {expr!r}")
            inner = expr[1:-1]
            for opch, fn in (
                ("&", lambda a, b: a & b),
                ("|", lambda a, b: a | b),
                ("^", lambda a, b: a ^ b),
            ):
                # split at top level (the emission has no nested parens)
                if opch in inner:
                    a, b = inner.split(opch, 1)
                    v = fn(term(a), term(b))
                    break
            else:
                v = term(inner)
        else:
            v = term(expr)
        return (1 - v).astype(np.uint8) if neg else v.astype(np.uint8)

    for line in verilog.splitlines():
        m = _ASSIGN_RE.search(line)
        if not m:
            continue
        lhs, rhs = m.group(1), m.group(2)
        ym = re.fullmatch(r"y\[(\d+)\]", lhs)
        if ym:
            o = int(ym.group(1))
            outputs[o] = eval_expr(rhs)
            n_out = max(n_out, o + 1)
        else:
            env[lhs] = eval_expr(rhs)

    out = np.zeros((r, n_out), dtype=np.uint8)
    for o, v in outputs.items():
        out[:, o] = v
    return out
