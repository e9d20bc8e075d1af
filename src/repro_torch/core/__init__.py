"""Core of the port: gates, genomes, encoding, the 1+λ search and the
servable artifact.

Public surface:
  * CircuitSpec / Genome / init_genome  — genome.py
  * EncodingConfig / fit_encoder        — encoding.py
  * mutate / mutate_children            — mutate.py
  * confusion_counts / balanced_accuracy — fitness.py
  * EvolveConfig / evolve_packed        — evolve.py
  * AutoTinyClassifier / ServableCircuit / load_servable — api.py
"""
from repro_torch.core.genome import CircuitSpec, Genome, init_genome  # noqa: F401
from repro_torch.core.encoding import EncodingConfig, encode, fit_encoder  # noqa: F401
