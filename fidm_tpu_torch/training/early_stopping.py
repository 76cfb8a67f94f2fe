"""Early stopping with best-weight restoration (PyTorch port of
`fidm_tpu/training/early_stopping.py`): patience in epochs, a min-delta
threshold, and a snapshot of the best parameters restored when it stops."""
from __future__ import annotations

__all__ = ["EarlyStopping"]


class EarlyStopping:
    def __init__(self, patience: int = 10, min_delta: float = 0.0,
                 restore_best_weights: bool = True):
        self.patience = patience
        self.min_delta = min_delta
        self.restore_best_weights = restore_best_weights
        self.wait = 0
        self.stopped = False
        self.best_loss = float("inf")
        self.best_params = None

    def update(self, val_loss: float, params=None):
        """Returns (should_stop, params): the best snapshot when stopping
        with restore_best_weights, else the params passed in."""
        if val_loss < self.best_loss - self.min_delta:
            self.best_loss = val_loss
            self.wait = 0
            if self.restore_best_weights and params is not None:
                # a clone of every tensor: the optimizer updates the live
                # parameters in place, and an alias would follow them
                self.best_params = {k: v.detach().clone() for k, v in params.items()}
        else:
            self.wait += 1
        if self.wait >= self.patience:
            self.stopped = True
            if self.restore_best_weights and self.best_params is not None:
                return True, self.best_params
            return True, params
        return False, params
