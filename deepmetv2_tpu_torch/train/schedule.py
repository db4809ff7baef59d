"""ReduceLROnPlateau — host-side LR controller (a copy of the JAX
package's ``train/schedule.py``, so that both packages step it alike and
read each other's ``sched_state``).

Faithful re-implementation of the torch scheduler as configured by the
reference (train.py:76: factor 0.5, patience 500, threshold 0.05, mode
'min', threshold_mode 'rel', cooldown 0), stepped once per epoch on the
mean train loss (train.py:58).  Pure Python state, serialized into
checkpoints for exact resume.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict


@dataclasses.dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.5
    patience: int = 500
    threshold: float = 0.05
    threshold_mode: str = "rel"
    mode: str = "min"
    cooldown: int = 0
    min_lr: float = 0.0
    eps: float = 1e-8

    best: float = math.inf
    num_bad_epochs: int = 0
    cooldown_counter: int = 0
    last_epoch: int = 0

    def _is_better(self, a: float) -> bool:
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < self.best * (1.0 - self.threshold)
            return a < self.best - self.threshold
        if self.threshold_mode == "rel":
            return a > self.best * (1.0 + self.threshold)
        return a > self.best + self.threshold

    def step(self, metric: float) -> float:
        """Update on an epoch metric; returns the (possibly reduced) lr."""
        self.last_epoch += 1
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1

        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0

        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict:
        return dataclasses.asdict(self)

    def load_state_dict(self, d: Dict) -> None:
        for k, v in d.items():
            if hasattr(self, k):
                setattr(self, k, v)
