"""The paper's own configuration space (§3.5, §5.3–5.4).

Evaluation settings from §5.4: 300 gates, κ=300, G=8000, λ=4, p=1/n, γ=0.01,
best across {quantize, quantile} × {2, 4} bits per input.
"""
from repro_torch.core.encoding import EncodingConfig
from repro_torch.core.evolve import EvolveConfig

N_GATES = 300
FN_SET = "full"           # Fig. 8a: {and, or, nand, nor}; "nand" variant below

PAPER_EVOLVE = EvolveConfig(lam=4, p=None, gamma=0.01, kappa=300, max_gens=8000)

PAPER_ENCODINGS = (
    EncodingConfig("quantize", 2),
    EncodingConfig("quantize", 4),
    EncodingConfig("quantile", 2),
    EncodingConfig("quantile", 4),
)

# Fig. 8a sweep values
GATE_SWEEP = (50, 100, 150, 200, 250, 300)
FN_SETS = ("full", "nand")
# Fig. 8b sweep (κ) and Fig. 8c sweep (G)
KAPPA_SWEEP = (100, 200, 300, 500, 1000)
G_SWEEP = (1000, 2000, 4000, 8000)
