"""What ``BENCHMARK.json`` names, found by name: a cell's configuration,
traffic and limits files, and the reader of each metric it reports."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class CellSpec:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1


def reports(metric: dict, cell: str) -> bool:
    """Whether a metric of BENCHMARK.json is reported in ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, bench: Optional[dict] = None) -> CellSpec:
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT / configs[w["config"]]["file"])
    return CellSpec(
        name=name, config=config,
        traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        chips=int(w["chips"]))


def reader_path(metric: str) -> Path:
    """The reader of a metric: ``metrics/<metric>.py`` where a metric has
    one of its own, else the reader of its kind, the name up to its first
    '.' (``device_idle.train`` -> ``device_idle.py``), with every
    ``<kind>_events_per_s`` read by ``events_per_s.py``.  A metric's name
    gives it a bound of its own; its reader says how it is read."""
    own = HERE / "metrics" / f"{metric}.py"
    if own.exists():
        return own
    kind = metric.split(".")[0]
    if kind.endswith("_events_per_s"):
        kind = "events_per_s"
    return HERE / "metrics" / f"{kind}.py"


def reader(metric: str) -> Callable:
    """``read(reading) -> number or None`` of the metric's reader."""
    path = reader_path(metric)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], reading) -> Dict[str, dict]:
    """Each metric's value, by its reader; a reader that finds nothing to
    read leaves its metric out."""
    out = {}
    for m in metrics:
        v = reader(m["name"])(reading)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
