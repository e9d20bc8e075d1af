"""Helpers the PyTorch-port parity tests share (not a test module).

Reference words are ``uint32``; the port's are ``int32`` tensors with the
same bits.  Genomes are made by the reference and carried across with
`repro_torch.core.api.servable_from_arrays`, never by seeding both
packages (their PRNG streams differ by design).
"""
from __future__ import annotations

import os

import jax
import numpy as np
import torch

from repro.core import encoding as RE
from repro.core.api import ServableCircuit as RefServable
from repro.core.genome import CircuitSpec as RefSpec
from repro.core.genome import init_genome as ref_init_genome
from repro_torch.core.api import servable_from_arrays


def i32(a) -> torch.Tensor:
    """numpy/jax int or uint32 array → int32 tensor with the same bits."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32).copy())


def u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor → uint32 numpy with the same bits."""
    return t.cpu().numpy().view(np.uint32)


def bundle_of(sc: RefServable) -> tuple[dict, dict]:
    """A reference servable as the bundle's arrays and JSON metadata."""
    arrays = {
        "gate_fn": np.asarray(sc.genome.gate_fn, np.int32),
        "edge_src": np.asarray(sc.genome.edge_src, np.int32),
        "out_src": np.asarray(sc.genome.out_src, np.int32),
        "enc_thresholds": np.asarray(sc.encoder.thresholds, np.float32),
        "enc_codes": np.asarray(sc.encoder.codes, np.uint8),
    }
    if sc.ref_stats is not None:
        arrays["enc_ref_stats"] = np.asarray(sc.ref_stats, np.float32)
    meta = {
        "spec": {
            "n_inputs": sc.spec.n_inputs, "n_nodes": sc.spec.n_nodes,
            "n_outputs": sc.spec.n_outputs, "fn_set": list(sc.spec.fn_set),
        },
        "encoder": {"strategy": sc.encoder.strategy, "bits": sc.encoder.bits},
        "n_classes": sc.n_classes,
        "lineage": sc.lineage,
    }
    return arrays, meta


def to_port(sc: RefServable):
    """Carry a reference servable into the port."""
    return servable_from_arrays(*bundle_of(sc))


def make_ref_servable(
    seed: int, n_feats: int, bits: int, n_nodes: int, n_classes: int,
    strategy: str = "quantile",
) -> RefServable:
    """A reference servable with a random reference genome and an encoder
    fitted on seeded numpy rows."""
    rng = np.random.RandomState(1000 + seed)
    enc = RE.fit_encoder(
        rng.randn(200, n_feats).astype(np.float32),
        RE.EncodingConfig(strategy, bits),
    )
    n_out = max(1, int(np.ceil(np.log2(max(n_classes, 2)))))
    spec = RefSpec(enc.n_bits_total, n_nodes, n_out, (0, 1, 2, 3))
    return RefServable(
        spec, ref_init_genome(jax.random.key(seed), spec), enc, n_classes
    )


GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")
# (features, bits/input, gates, classes) of the serving parity tenants
SERVE_TENANTS = [(4, 2, 40, 2), (7, 4, 80, 3), (3, 2, 25, 4), (10, 4, 120, 5)]
ENSEMBLE = [(7, 2, 30, 3), (7, 4, 50, 3), (7, 2, 64, 3)]


def golden_pair(name: str):
    """A reference-fitted golden bundle loaded by each package."""
    from repro.core.api import load_servable as ref_load
    from repro_torch.core.api import load_servable

    path = os.path.join(GOLDEN, f"{name}.circuit.npz")
    return ref_load(path), load_servable(path)


def serving_registries():
    """The same tenants in both packages' registries: four synthetic
    reference circuits, both golden bundles and a 3-member ensemble."""
    from repro.serve.circuits import CircuitRegistry as RefRegistry
    from repro_torch.serve.circuits import CircuitRegistry

    ref, port = RefRegistry(), CircuitRegistry()
    for i, shape in enumerate(SERVE_TENANTS):
        sc = make_ref_servable(i, *shape)
        ref.add(f"t{i}", sc)
        port.add(f"t{i}", to_port(sc))
    for name in ("higgs", "led"):
        a, b = golden_pair(name)
        ref.add(name, a)
        port.add(name, b)
    members = [make_ref_servable(10 + k, *s, strategy=("quantize", "quantile", "gray")[k])
               for k, s in enumerate(ENSEMBLE)]
    ref.add_ensemble("ens", members)
    port.add_ensemble("ens", [to_port(m) for m in members])
    return ref, port


def rows_for(reg, tenant: str, seed: int, n: int) -> np.ndarray:
    """``n`` seeded float rows of a tenant's feature width."""
    f = reg.get(tenant).encoder.n_features
    return np.random.RandomState(seed).randn(n, f).astype(np.float32)
