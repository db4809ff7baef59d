"""Observability helpers (a copy of the JAX package's ``utils/logging.py``;
reference utils.py:10-30, train.py:37-57)."""

from __future__ import annotations

import time
from typing import Dict, Optional


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
    """Step-rate + edges/s meter (the BASELINE.json headline metric).

    The reference only had tqdm's it/s (train.py:38-57); here throughput is
    measured in graph edges processed per second, the honest unit for
    message-passing work."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._t0: Optional[float] = None
        self.steps = 0
        self.edges = 0
        self.nodes = 0

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def update(self, num_edges: int, num_nodes: int = 0) -> None:
        self.start()
        self.steps += 1
        self.edges += int(num_edges)
        self.nodes += int(num_nodes)

    @property
    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def rates(self) -> Dict[str, float]:
        dt = max(self.elapsed, 1e-9)
        return {
            "steps_per_s": self.steps / dt,
            "edges_per_s": self.edges / dt,
            "nodes_per_s": self.nodes / dt,
        }
