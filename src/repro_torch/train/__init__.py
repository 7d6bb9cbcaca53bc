from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .loop import TrainState, make_train_step

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "make_train_step", "TrainState"]
