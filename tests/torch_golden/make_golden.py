"""Regenerate the reference-fitted golden fixtures of the PyTorch port.

Fits the reference package's `AutoTinyClassifier` (JAX) on two tabular
datasets, saves each fitted circuit as a reference bundle, and saves the
reference's class ids (``backend="ref"``) on every row of the full
dataset.  The port's tests and ``chip_smoke.py`` load these bundles with
`repro_torch.core.api.load_servable` and must predict the same ids.

  * ``higgs``: quantile encoding at 4 bits → 29 × 4 = 116 input bits,
    300 gates, 1 output bit; fitted on 4,096 rows, predicted on 98,050.
  * ``led``: the same recipe → 28 input bits, 300 gates, 4 output bits
    for 10 classes (multi-bit decode and the clamp of codes 10-15).

Run from the repository root (needs JAX):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py

Accuracy is not the point; a real reference-fitted genome is, so the
search runs few generations.  Ids are stored as uint8 to keep the
directory small.
"""
from __future__ import annotations

import os

import numpy as np

from repro.core.api import AutoTinyClassifier, save_servable
from repro.core.encoding import EncodingConfig
from repro.data.tabular import load_dataset

HERE = os.path.dirname(os.path.abspath(__file__))
DATASETS = ("higgs", "led")
FIT_ROWS = 4096
MAX_GENS = 2000


def main() -> None:
    for name in DATASETS:
        fit = load_dataset(name, max_rows=FIT_ROWS)
        clf = AutoTinyClassifier(
            n_gates=300, encodings=(EncodingConfig("quantile", 4),),
            max_gens=MAX_GENS, seed=0, backend="ref",
        )
        clf.fit(fit.x, fit.y, n_classes=fit.n_classes)
        sc = clf.to_servable()
        save_servable(sc, os.path.join(HERE, f"{name}.circuit.npz"))
        full = load_dataset(name)
        ids = sc.predict(full.x, backend="ref")
        assert ids.max() < 256
        np.save(os.path.join(HERE, f"{name}.ids.npy"), ids.astype(np.uint8))
        acc = float((ids == full.y).mean())
        print(f"{name}: {sc.spec} rows={full.n_rows} accuracy={acc:.4f} "
              f"gens={clf.records_[0].generations}")


if __name__ == "__main__":
    main()
