"""The paper's ML baselines (§5.1): XGBoost-style boosted trees in numpy on
the host, and the MLP in PyTorch, trained on the card."""
from repro_torch.core.baselines.gbdt import GBDTConfig, gbdt_predict, train_gbdt  # noqa: F401
from repro_torch.core.baselines.mlp import MLPConfig, mlp_predict, train_mlp  # noqa: F401
