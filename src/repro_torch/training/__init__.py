from repro_torch.training import optim
from repro_torch.training.trainer import (
    TrainConfig,
    Trainer,
    TrainState,
    make_train_step,
    value_and_grad,
)

__all__ = ["optim", "TrainConfig", "Trainer", "TrainState",
           "make_train_step", "value_and_grad"]
