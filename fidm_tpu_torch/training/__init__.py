from .checkpoint import CheckpointManager
from .early_stopping import EarlyStopping
from .ema import init_ema, update_ema
from .loop import FitConfig, GracefulShutdown, fit, train_epoch, validate
from .lr import make_lr_schedule
from .train_state import (
    TrainDraws,
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = ["CheckpointManager", "EarlyStopping", "FitConfig", "GracefulShutdown",
           "TrainDraws", "TrainState", "fit", "init_ema", "make_eval_step",
           "make_lr_schedule", "make_optimizer", "make_train_step", "train_epoch",
           "update_ema", "validate"]
