"""What every entry and family shares: the run's readings, the port's
config from a configuration file, the judgement of the compared numbers,
the port's kernels as ``counts/kernels/`` declares them, the device's
housekeeping."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import spec


@dataclasses.dataclass
class Reading:
    """What a run measured; the metric readers take their numbers from it.
    Times in seconds.  ``trace_*`` and the counts are of the traced part
    of a ``--trace 1`` run, None or empty otherwise."""

    entry: str
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    events: int = 0
    batch_s: List[float] = dataclasses.field(default_factory=list)
    collate_s: List[float] = dataclasses.field(default_factory=list)
    trace_window_s: Optional[float] = None
    busy_s: Optional[float] = None
    covers: bool = False
    port_kernel_s: float = 0.0
    bound_s: float = 0.0
    ops: float = 0.0
    trace_collate_s: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Outcome:
    reading: Reading
    checks: Dict[str, dict]
    attempted: int
    failed: int
    memory_peak: int
    breakdown: Optional[dict] = None
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"]
            for c in self.checks.values()))


@dataclasses.dataclass
class Run:
    """One run of one cell: its files, seed, window and mode; ``t0`` is the
    process's start on the host clock.  ``control`` runs the cell's
    control in the program's place (the configuration's lower precision);
    the driver never asks for it."""

    spec: spec.CellSpec
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float
    control: bool = False


def judge(values: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, dict]:
    """The numbers the cell's limits file names, each beside its limit
    (``knn_tol`` is a tolerance of the DRN's graph check, not a limit)."""
    return {k: {"value": float(values[k]), "limit": float(v)}
            for k, v in limits.items() if k != "knn_tol"}


@contextlib.contextmanager
def deterministic():
    """The plain reference's ops in a fixed order: on the card its
    ``index_add`` and the backward of its gathers add in no fixed order
    otherwise, so one seed would give other compared numbers run after run.
    Only the reference runs under it, after the window; ops that have no
    fixed-order form only warn."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def port_config(config: dict, **sections):
    """The port's ``Config`` from a configuration file, with ``sections``
    (dicts of keys) laid over its sections, loaded by the port's own
    ``Config.from_json`` (which passes every section the port declares and
    ignores the file's other keys)."""
    from deepmetv2_tpu_torch.config import Config

    raw = copy.deepcopy(config)
    for key, over in sections.items():
        raw.setdefault(key, {}).update(over)
    return Config.from_json(json.dumps(raw))


def round_halo(halo: int) -> int:
    """The CLIs' halo: the data's span up to a multiple of 64, at least
    64."""
    return max(64, -(-int(halo) // 64) * 64)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device: torch.device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def launch_counts() -> Dict[str, int]:
    from deepmetv2_tpu_torch.ops.cuda import build

    return dict(build.launch_counts())


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: n - before.get(k, 0) for k, n in after.items()}


def kernel_patterns() -> dict:
    """The port's kernels: the declarations of ``counts/kernels/`` (one
    file per kernel source of the port, ``csrc/<name>.cu``) merged by file
    name."""
    files = sorted((spec.HERE / "counts" / "kernels").glob("*.json"))
    return merge_kernels([spec.load_json(p) for p in files])


def merge_kernels(declared: List[dict]) -> dict:
    """``port``: the alternation of the declarations' ``port`` patterns
    (the kernels ``kernel_roofline`` sums); ``per_wrapper``:
    every declaration's map of a launch-counting wrapper to its kernel's
    pattern (``tracing.coverage``).  A wrapper declared twice is an
    error."""
    per: Dict[str, str] = {}
    for d in declared:
        twice = set(per) & set(d["per_wrapper"])
        if twice:
            raise ValueError(f"wrappers declared twice: {sorted(twice)}")
        per.update(d["per_wrapper"])
    return {"port": "|".join(d["port"] for d in declared), "per_wrapper": per}


def met_rel(port: np.ndarray, ref: np.ndarray) -> float:
    """The largest gap of an event's MET vector, over the larger of its
    reference length and the median event's."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    size = np.hypot(ref[:, 0], ref[:, 1])
    scale = np.maximum(size, np.median(size))
    gap = np.hypot(*(port - ref).T)
    bad = ~np.isfinite(gap)
    return float("inf") if bad.any() else float((gap / scale).max())


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
