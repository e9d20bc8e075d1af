from repro_torch.train.optimizer import OptConfig, init_opt_state, apply_updates  # noqa: F401
from repro_torch.train.train_step import TrainState, make_train_step, make_train_state  # noqa: F401
