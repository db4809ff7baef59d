"""Observability helpers (a copy of the JAX package's ``utils/logging.py``;
reference utils.py:10-30, train.py:37-57)."""

from __future__ import annotations

import time
from typing import Optional


class RunningAverage:
    """Running average of a scalar (reference utils.py:10-30)."""

    def __init__(self) -> None:
        self.steps = 0
        self.total = 0.0

    def update(self, val: float) -> None:
        self.total += float(val)
        self.steps += 1

    def __call__(self) -> float:
        return self.total / float(self.steps) if self.steps else 0.0


class StepTimer:
    """The host clock of a training epoch: seconds since ``start``."""

    def __init__(self) -> None:
        self._t0: Optional[float] = None

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    @property
    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0
