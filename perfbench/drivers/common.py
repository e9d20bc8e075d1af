"""What the drivers share: the table, the circuits drawn from the seed, the
reference's answers, sampling and the device's record."""
from __future__ import annotations

import subprocess

import numpy as np

from perfbench import tabular, work
from perfbench.reference import circuits as ref

# the paper's gate set, in opcode order (NOT and BUF read one operand)
OPCODES = ("AND", "OR", "NAND", "NOR", "XOR", "XNOR", "NOT", "BUF")


def rng(ctx, *stream: int) -> np.random.RandomState:
    return tabular.rng_for(ctx.seed, *stream)


def table(ctx) -> tuple[np.ndarray, np.ndarray]:
    c = ctx.cell.config
    return tabular.make_table(c["dataset"], c["rows"], c["features"], c["classes"], ctx.seed)


def n_outputs(config: dict) -> int:
    return max(1, int(np.ceil(np.log2(max(config["classes"], 2)))))


def encoding(config: dict) -> dict:
    (enc,) = config["encodings"]
    if enc["strategy"] != "quantile":
        raise ValueError(f"the reference encodes by quantile only, not {enc['strategy']!r}")
    return enc


def opcodes(config: dict, fn_index) -> np.ndarray:
    """Raw opcodes of a genome's function-set indices."""
    table_ = np.array([OPCODES.index(g) for g in config["fn_set"]])
    return table_[np.asarray(fn_index)]


def seeded_genome(r: np.random.RandomState, n_in: int, config: dict) -> dict:
    """A circuit drawn from ``r``: each gate's function uniform over the
    set and its operands uniform over the ids before it; the outputs tap
    the last gates, so that the circuit computes through its gates."""
    n, n_out = config["n_gates"], n_outputs(config)
    hi = n_in + np.arange(n)
    return {
        "gate_fn": r.randint(0, len(config["fn_set"]), n).astype(np.int32),
        "edge_src": np.minimum((r.rand(n, 2) * hi[:, None]).astype(np.int64),
                               hi[:, None] - 1).astype(np.int32),
        "out_src": (n_in + n - 1 - np.arange(n_out)).astype(np.int32),
    }


def servable(genome: dict, edges: np.ndarray, config: dict):
    """The program's `ServableCircuit` of a drawn genome and bucket edges."""
    from repro_torch.core import gates
    from repro_torch.core.api import servable_from_arrays
    bits = encoding(config)["bits"]
    codes = ((np.arange(2 ** bits)[:, None] >> np.arange(bits)[None, :]) & 1).astype(np.uint8)
    meta = {
        "spec": {"n_inputs": edges.shape[0] * bits, "n_nodes": config["n_gates"],
                 "n_outputs": n_outputs(config),
                 "fn_set": [gates.GATE_NAMES.index(g) for g in config["fn_set"]]},
        "encoder": {"strategy": "quantile", "bits": bits},
        "n_classes": config["classes"],
    }
    return servable_from_arrays({**genome, "enc_thresholds": edges, "enc_codes": codes}, meta)


def reference_ids(config: dict, genome: dict, x_words: np.ndarray, n_rows: int) -> np.ndarray:
    """The reference's class id of every row, from its packed inputs."""
    out = ref.evaluate(config["fn_set"], genome["gate_fn"], genome["edge_src"],
                       genome["out_src"], x_words)
    return ref.class_ids(ref.codes(out, n_rows), config["classes"])


def live(config: dict, genome: dict, n_in: int) -> tuple[int, frozenset]:
    return work.live_set(opcodes(config, genome["gate_fn"]), genome["edge_src"],
                         genome["out_src"], n_in, n_in)


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``r`` (Algorithm R): one uniform draw per item offered."""

    def __init__(self, k: int, r: np.random.RandomState, draws: int = 1 << 20):
        self.k, self.items, self.seen = k, [], 0
        self._u = r.rand(draws)

    def offer(self, item) -> None:
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(item)
        else:
            j = int(self._u[i % len(self._u)] * (i + 1))
            if j < self.k:
                self.items[j] = item


def check(value, limit) -> dict:
    return {"value": value, "limit": limit}


def device_record(device: str) -> dict:
    """The device a run used, as the result line reports it."""
    import torch
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        rec["power_limit_w"] = float(out.stdout.strip())
    except (OSError, ValueError, subprocess.SubprocessError):
        pass
    return rec
