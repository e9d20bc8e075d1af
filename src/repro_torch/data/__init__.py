"""Tabular datasets (numpy; byte-identical to the reference's)."""
from repro_torch.data.tabular import (  # noqa: F401
    DATASETS,
    TabularDataset,
    kfold,
    load_dataset,
    train_test_split,
)
