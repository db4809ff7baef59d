"""What ``BENCHMARK.json`` names, found by name: a cell's configuration,
traffic and limits files, its entry (``entries/<traffic entry>.py``), its
family (``families/<config family>.py``), and the reader of each metric it
reports.  Each is a file of its own, loaded by its path, so a new one
arrives as a new file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
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


def load(path: Path, prefix: str) -> ModuleType:
    """The Python file ``path``, loaded by its path as ``prefix`` + its
    stem."""
    spec = importlib.util.spec_from_file_location(prefix + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def named(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` (``kind`` ``entries`` or ``families``); a name
    with no file stops with the names there are."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        there = sorted(p.stem for p in (HERE / kind).glob("*.py")
                       if p.stem != "__init__")
        raise SystemExit(f"no {kind}/{name}.py: {kind} there are {there}")
    return load(path, f"portbench_{kind}_")


def entry(name: str) -> ModuleType:
    """The entry a traffic file names: ``run(cell.Run) -> cell.Outcome``."""
    return named("entries", name)


def family(name: str, role: str) -> type:
    """The class ``role`` (``Train``, ``Serve``) of the family a
    configuration names; one that the family lacks stops with what it
    has."""
    mod = named("families", name)
    if not isinstance(getattr(mod, role, None), type):
        has = sorted(k for k, v in vars(mod).items()
                     if isinstance(v, type) and v.__module__ == mod.__name__)
        raise SystemExit(f"family {name!r} (families/{name}.py) has no "
                         f"{role} class for this entry; its classes: {has}")
    return getattr(mod, role)


def families() -> List[ModuleType]:
    """Every family file."""
    return [load(p, "portbench_families_")
            for p in sorted((HERE / "families").glob("*.py"))
            if p.stem != "__init__"]


def reader(metric: str) -> Callable:
    """``read(reading) -> number or None`` of the metric's reader."""
    return load(reader_path(metric), "portbench_metric_").read


def read_metrics(metrics: List[dict], reading) -> Dict[str, dict]:
    """Each metric's value, by its reader; a reader that finds nothing to
    read leaves its metric out."""
    out = {}
    for m in metrics:
        v = reader(m["name"])(reading)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
