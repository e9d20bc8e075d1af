"""AutoTinyClassifier, the deployable `ServableCircuit`, and its bundles.

`AutoTinyClassifier.fit(X, y)` is the toolflow of Fig. 7: for each
candidate encoding (strategy, bits per input) fit the encoder on the
training rows, pack the bits onto the device, split train/val rows (§3.3),
run the 1+λ search (`core/evolve.py`), and keep the circuit with the best
validation fitness across encodings (§5.2).  Its `netlist`, `to_verilog`,
`to_c` and `hardware_report` take the fitted circuit on to hardware
(§4, host code: `core/netlist.py`, `core/verilog.py`, `core/hardware.py`).

A `ServableCircuit` is a fitted genome plus everything needed to run it on
raw float features (fitted encoder, class count).  Bundles use the
reference package's on-disk format unchanged — one ``.npz`` holding the
genome/encoder arrays and a JSON metadata string, format version 2 — so a
bundle saved by either package loads in the other and predicts the same
class ids.  `servable_from_arrays` builds an artifact from those arrays
directly; `load_servable` is built on it.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import Sequence

import numpy as np
import torch

from repro_torch import runtime
from repro_torch.core import encoding as E
from repro_torch.core import fitness as F
from repro_torch.core import gates, hardware, netlist, verilog
from repro_torch.core.evolve import EvolveConfig, PhaseClock, evolve, make_eval_fn
from repro_torch.core.genome import CircuitSpec, Genome, genome_from_arrays, opcodes
from repro_torch.kernels.program import CircuitProgram, compile_program

# On-disk bundle format (the reference's).  Version history:
#   1 — genome + spec + encoder + class count + validated backend.
#   2 — adds optional lineage metadata and the fit-time per-bit activation
#       frequencies (``enc_ref_stats``).
SERVABLE_FORMAT_VERSION = 2
_SERVABLE_READABLE_VERSIONS = (1, 2)
SERVABLE_FORMAT_KIND = "tiny-classifier-circuits/servable-circuit"


def read_servable_meta(path: str) -> dict:
    """Read just the JSON metadata of a saved bundle."""
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["meta"]))


def decode_predictions(out_words, n_rows: int, n_classes: int) -> np.ndarray:
    """Packed circuit output words → int64 class ids, length exactly n_rows.

    Runs on the host in numpy ``uint32`` (``int32`` words are viewed as
    ``uint32`` first, so ``>>`` is a logical shift).  The row axis is padded
    up to a word boundary, so the decode trims to the true row count; an
    out-of-range binary code maps to the last class."""
    words = np.asarray(out_words)
    if words.dtype == np.int32:
        words = words.view(np.uint32)                   # u32[O, W]
    shifts = np.arange(E.WORD, dtype=np.uint32)
    bits = (words[..., None] >> shifts) & np.uint32(1)  # (O, W, 32)
    bits = bits.reshape(words.shape[0], -1)[:, :n_rows].astype(np.int64)
    weights = (np.int64(1) << np.arange(words.shape[0], dtype=np.int64))
    ids = (bits * weights[:, None]).sum(axis=0)
    return np.minimum(ids, n_classes - 1)


@dataclasses.dataclass(frozen=True)
class ServableCircuit:
    """Deployable inference artifact of a fitted classifier.

    ``lineage`` (JSON metadata) and ``ref_stats`` (fit-time per-bit
    activation frequencies) ride along from format-v2 bundles and are
    excluded from equality."""

    spec: CircuitSpec
    genome: Genome
    encoder: E.Encoder
    n_classes: int
    lineage: "dict | None" = dataclasses.field(default=None, compare=False)
    ref_stats: "np.ndarray | None" = dataclasses.field(
        default=None, compare=False, repr=False
    )
    # the live-gate program per device, compiled at first use
    _programs: dict = dataclasses.field(
        default_factory=dict, init=False, compare=False, repr=False
    )

    def __post_init__(self):
        if self.spec.n_inputs != self.encoder.n_bits_total:
            raise ValueError(
                f"spec has {self.spec.n_inputs} inputs, the encoder makes "
                f"{self.encoder.n_bits_total} bits"
            )
        if self.n_classes < 2:
            raise ValueError(f"n_classes must be >= 2, got {self.n_classes}")
        if self.ref_stats is not None and (
                np.shape(self.ref_stats) != (self.encoder.n_bits_total,)):
            raise ValueError(
                f"ref_stats shape {np.shape(self.ref_stats)} != "
                f"({self.encoder.n_bits_total},)"
            )

    @property
    def n_inputs(self) -> int:
        return self.spec.n_inputs

    @property
    def n_outputs(self) -> int:
        return self.spec.n_outputs

    def program(self, device: "str | torch.device") -> CircuitProgram:
        """The genome's live-gate program (`kernels/program.py`) on
        ``device``: compiled once, copied once to each device."""
        dev = torch.device(device)
        if dev not in self._programs:
            host = self._programs.get(torch.device("cpu"))
            if host is None:
                host = compile_program(
                    opcodes(self.genome, self.spec)[None],
                    self.genome.edge_src[None], self.genome.out_src[None],
                    self.spec.n_inputs,
                )
                self._programs[torch.device("cpu")] = host
            self._programs[dev] = host.to(dev)
        return self._programs[dev]

    def predict(
        self, x: np.ndarray, *, device: "str | torch.device | None" = None,
    ) -> np.ndarray:
        """Class ids for float rows ``x`` (the serving engine matches this
        bit for bit).  ``device=None`` runs on the card through the CUDA
        kernel and raises without one; ``device="cpu"`` runs the plain
        version."""
        dev = runtime.resolve_device(device)
        be = runtime.backend_for(dev)
        bits = E.encode(self.encoder, np.asarray(x, np.float32))
        r = bits.shape[0]
        x_words = E.pack_bits_rows(bits, E.n_words(r))
        out = be.eval_program(
            self.program(dev), torch.from_numpy(x_words.view(np.int32)).to(dev)
        )[0]
        return decode_predictions(out.cpu().numpy(), r, self.n_classes)

    def serve_async(
        self, *,
        device: "str | torch.device | None" = None,
        tenant: str = "default",
        qos=None,
        clock=None,
    ):
        """One-call async serving of this artifact.

        Builds a single-tenant `CircuitRegistry` and a
        `CircuitServer(device=device)` and returns an (unstarted)
        `AsyncCircuitServer`; enter it to run the deadline scheduler::

            with sc.serve_async() as frontend:
                fut = frontend.enqueue("default", x, deadline_s=0.05)
                ids = fut.result()

        or from a coroutine::

            async with sc.serve_async() as frontend:
                ids = await frontend.submit("default", x)

        ``device=None`` serves on the card and raises `NoCudaDeviceError`
        without one; ``device="cpu"`` serves through the plain versions.
        ``qos`` optionally pins the tenant's `TenantQoS`; ``clock``
        injects a time source (tests).  More tenants can be added to
        ``frontend.server.registry`` afterwards."""
        # lazy: the serving layer imports this module
        from repro_torch.serve.async_frontend import AsyncCircuitServer
        from repro_torch.serve.circuits import CircuitRegistry, CircuitServer

        reg = CircuitRegistry()
        reg.add(tenant, self, qos=qos)
        server = CircuitServer(reg, device=device)
        kwargs = {} if clock is None else {"clock": clock}
        return AsyncCircuitServer(server, **kwargs)

    # -- persistence ---------------------------------------------------
    def save(
        self, path: str, *,
        validated_backend: "str | runtime.EvalBackend" = "torch-ref",
    ) -> str:
        """Deprecated alias of `save_servable`, as in the reference.
        Prefer `save_servable(sc, path)` for single bundles, or an
        `repro_torch.serve.artifacts.ArtifactStore` for anything
        fleet-shaped."""
        warnings.warn(
            "ServableCircuit.save() is deprecated; use "
            "repro_torch.core.api.save_servable(circuit, path) or an "
            "repro_torch.serve.artifacts.ArtifactStore",
            DeprecationWarning, stacklevel=2,
        )
        return save_servable(self, path, validated_backend=validated_backend)

    @classmethod
    def load(cls, path: str) -> "ServableCircuit":
        """Deprecated alias of `load_servable`, as in the reference."""
        warnings.warn(
            "ServableCircuit.load() is deprecated; use "
            "repro_torch.core.api.load_servable(path) or an "
            "repro_torch.serve.artifacts.ArtifactStore",
            DeprecationWarning, stacklevel=2,
        )
        return load_servable(path)


def servable_from_arrays(
    arrays: "dict[str, np.ndarray]", meta: dict
) -> ServableCircuit:
    """Build a `ServableCircuit` from a bundle's arrays and metadata.

    ``arrays`` holds the bundle's own keys — ``gate_fn``, ``edge_src``,
    ``out_src``, ``enc_thresholds``, ``enc_codes`` and optionally
    ``enc_ref_stats`` — and ``meta`` its JSON metadata (``spec``,
    ``encoder``, ``n_classes``, optional ``lineage``)."""
    spec = CircuitSpec(
        n_inputs=int(meta["spec"]["n_inputs"]),
        n_nodes=int(meta["spec"]["n_nodes"]),
        n_outputs=int(meta["spec"]["n_outputs"]),
        fn_set=tuple(int(op) for op in meta["spec"]["fn_set"]),
    )

    genome = genome_from_arrays(arrays["gate_fn"], arrays["edge_src"], arrays["out_src"])
    encoder = E.Encoder(
        thresholds=np.asarray(arrays["enc_thresholds"], np.float32),
        codes=np.asarray(arrays["enc_codes"], np.uint8),
        strategy=meta["encoder"]["strategy"],
        bits=int(meta["encoder"]["bits"]),
    )
    ref_stats = arrays.get("enc_ref_stats")
    return ServableCircuit(
        spec=spec, genome=genome, encoder=encoder,
        n_classes=int(meta["n_classes"]),
        lineage=meta.get("lineage"),
        ref_stats=None if ref_stats is None else np.asarray(ref_stats, np.float32),
    )


def save_servable(
    circuit: ServableCircuit, path: str, *,
    validated_backend: "str | runtime.EvalBackend" = "torch-ref",
) -> str:
    """Write a `ServableCircuit` as a versioned npz+JSON bundle (the
    reference's format).  Returns the path written (``.npz`` appended when
    missing)."""
    meta = {
        "kind": SERVABLE_FORMAT_KIND,
        "format_version": SERVABLE_FORMAT_VERSION,
        "spec": {
            "n_inputs": int(circuit.spec.n_inputs),
            "n_nodes": int(circuit.spec.n_nodes),
            "n_outputs": int(circuit.spec.n_outputs),
            "fn_set": [int(op) for op in circuit.spec.fn_set],
        },
        "encoder": {
            "strategy": circuit.encoder.strategy,
            "bits": int(circuit.encoder.bits),
        },
        "n_classes": int(circuit.n_classes),
        "validated_backend": runtime.resolve_backend(validated_backend).name,
        "lineage": circuit.lineage,
    }
    if not path.endswith(".npz"):
        path = path + ".npz"
    arrays = {
        "gate_fn": circuit.genome.gate_fn.cpu().numpy().astype(np.int32),
        "edge_src": circuit.genome.edge_src.cpu().numpy().astype(np.int32),
        "out_src": circuit.genome.out_src.cpu().numpy().astype(np.int32),
        "enc_thresholds": np.asarray(circuit.encoder.thresholds, np.float32),
        "enc_codes": np.asarray(circuit.encoder.codes, np.uint8),
    }
    if circuit.ref_stats is not None:
        arrays["enc_ref_stats"] = np.asarray(circuit.ref_stats, np.float32)
    np.savez(path, meta=json.dumps(meta), **arrays)
    return path


def load_servable(path: str) -> ServableCircuit:
    """Load a bundle written by either package's `save_servable`."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta.get("kind") != SERVABLE_FORMAT_KIND:
            raise ValueError(
                f"{path}: not a ServableCircuit bundle "
                f"(kind={meta.get('kind')!r})"
            )
        version = meta.get("format_version")
        if version not in _SERVABLE_READABLE_VERSIONS:
            raise ValueError(
                f"{path}: unsupported bundle format version {version!r} "
                f"(this build reads versions "
                f"{list(_SERVABLE_READABLE_VERSIONS)})"
            )
        arrays = {k: z[k] for k in z.files if k != "meta"}
    return servable_from_arrays(arrays, meta)


# ---------------------------------------------------------------------------
# The end-to-end toolflow
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FitRecord:
    encoding: E.EncodingConfig
    val_fitness: float
    train_fitness: float
    generations: int
    # wall seconds of this encoding's search, and its host seconds per
    # phase (`PhaseClock`)
    search_s: float = 0.0
    clock: PhaseClock = dataclasses.field(default_factory=PhaseClock, repr=False)


DEFAULT_ENCODINGS = (
    E.EncodingConfig("quantize", 2),
    E.EncodingConfig("quantize", 4),
    E.EncodingConfig("quantile", 2),
    E.EncodingConfig("quantile", 4),
)


class AutoTinyClassifier:
    """Fit a tiny classifier circuit to tabular rows, then predict.

    ``device=None`` runs the search and ``predict`` on the card through
    the CUDA kernel (and raises without one); ``device="cpu"`` runs the
    plain versions on the CPU."""

    def __init__(
        self,
        n_gates: int = 300,
        fn_set: str | tuple[int, ...] = "full",
        encodings: Sequence[E.EncodingConfig] = DEFAULT_ENCODINGS,
        lam: int = 4,
        p: float | None = None,
        gamma: float = 0.01,
        kappa: int = 300,
        max_gens: int = 8000,
        n_out_bits: int | None = None,
        val_fraction: float = 0.5,
        seed: int = 0,
        device: "str | torch.device | None" = None,
    ):
        self.device = runtime.resolve_device(device)
        self.fn_set = gates.FUNCTION_SETS[fn_set] if isinstance(fn_set, str) else fn_set
        self.n_gates = n_gates
        self.encodings = tuple(encodings)
        self.cfg = EvolveConfig(
            lam=lam, p=p, gamma=gamma, kappa=kappa, max_gens=max_gens,
        )
        self.n_out_bits = n_out_bits
        self.val_fraction = val_fraction
        self.seed = seed
        # fitted state
        self.spec_: CircuitSpec | None = None
        self.genome_: Genome | None = None
        self.encoder_: E.Encoder | None = None
        self.n_classes_: int | None = None
        self.ref_stats_: np.ndarray | None = None
        self.records_: list[FitRecord] = []

    # ------------------------------------------------------------------
    def fit(self, x: np.ndarray, y: np.ndarray, n_classes: int | None = None):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int64)
        self.n_classes_ = n_classes or int(y.max()) + 1
        n_out = self.n_out_bits or max(
            1, int(np.ceil(np.log2(max(self.n_classes_, 2))))
        )
        best = None
        self.records_ = []
        for ei, ecfg in enumerate(self.encodings):
            enc = E.fit_encoder(x, ecfg)
            bits = E.encode(enc, x)
            data = E.pack_dataset(bits, y, self.n_classes_, n_out, device=self.device)
            w = data.x_words.shape[1]
            mtr, mva = E.split_masks(
                x.shape[0], w, self.val_fraction, seed=self.seed + ei,
                device=self.device,
            )
            spec = CircuitSpec(
                n_inputs=bits.shape[1], n_nodes=self.n_gates,
                n_outputs=n_out, fn_set=self.fn_set,
            )
            generator = torch.Generator().manual_seed(self.seed * 1000 + ei)
            eval_fn = make_eval_fn(spec, data, mtr, mva)
            t0 = time.perf_counter()
            final = evolve(generator, spec, self.cfg, eval_fn)
            rec = FitRecord(
                encoding=ecfg,
                val_fitness=float(final.best_val),
                train_fitness=float(final.best_train),
                generations=int(final.gen),
                search_s=time.perf_counter() - t0,
                clock=eval_fn.clock,
            )
            self.records_.append(rec)
            if best is None or rec.val_fitness > best[0]:
                # per-bit activation frequency of the encoded training
                # data: the reference snapshot online drift detection
                # compares live traffic against (bundle v2 `ref_stats`)
                best = (rec.val_fitness, spec, final.best, enc,
                        bits.mean(axis=0).astype(np.float32))
        (_, self.spec_, self.genome_, self.encoder_,
         self.ref_stats_) = best
        return self

    # ------------------------------------------------------------------
    def _require_fit(self):
        if self.genome_ is None:
            raise RuntimeError("call fit() first")

    def to_servable(self) -> ServableCircuit:
        """Export the deployment artifact (what the circuit server serves)."""
        self._require_fit()
        return ServableCircuit(
            spec=self.spec_, genome=self.genome_,
            encoder=self.encoder_, n_classes=self.n_classes_,
            ref_stats=self.ref_stats_,
        )

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self.to_servable().predict(x, device=self.device)

    def balanced_score(self, x: np.ndarray, y: np.ndarray) -> float:
        pred = self.predict(x)
        y = np.asarray(y)
        return F.balanced_accuracy_rows(
            pred, y, np.ones_like(y, bool), self.n_classes_
        )

    def accuracy(self, x: np.ndarray, y: np.ndarray) -> float:
        return float((self.predict(x) == np.asarray(y)).mean())

    # ------------------------------------------------------------------
    # The hardware toolflow (paper §4): host code, no device needed
    def netlist(self) -> netlist.Netlist:
        self._require_fit()
        return netlist.extract(self.genome_, self.spec_)

    def to_verilog(self, module_name: str = "tiny_classifier",
                   registered: bool = False) -> str:
        return verilog.to_verilog(self.netlist(), module_name, registered)

    def to_c(self, fn_name: str = "tiny_classifier_predict") -> str:
        return verilog.to_c(self.netlist(), fn_name)

    def hardware_report(
        self, tech: hardware.TechModel = hardware.SILICON_45NM,
        design: str = "tiny",
    ) -> hardware.HardwareReport:
        return hardware.tiny_classifier_report(self.netlist(), tech, design)
