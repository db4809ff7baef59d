"""Every name in BENCHMARK.json resolves to its files, and the file keeps
the contract's shape."""

import json
import re

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    s = spec.cell_spec(cell)
    assert (spec.HERE / "entries" / f"{s.traffic['entry']}.py").is_file()
    assert (spec.HERE / "families" / f"{s.config['family']}.py").is_file()
    e2e = {m["name"] for m in s.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert s.per_layer
    for m in s.end_to_end + s.per_layer:
        assert spec.reader_path(m["name"]).exists()
        assert callable(spec.reader(m["name"]))
    need = ({"loss_rel", "grad_gap"} if s.traffic["entry"] == "train"
            else {"met_rel"})
    assert set(s.limits) >= need
    if s.traffic["entry"] == "train":
        assert set(s.limits) & {"change_gap", "change_med"}
    if s.config["family"] == "drn":
        assert s.limits["graph_faults"] == 0 and "knn_tol" in s.limits


def test_names_units_and_metric_shapes():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + list(e2e) + [
        m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for c in m["workloads"]:
            assert spec.reports(e2e[m["moves"]], c)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"].split(".")[0])


def test_configs_and_workloads():
    for c in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert c["file"].startswith("portbench/")
        assert cfg["reduced"] == c["reduced"] == []
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
