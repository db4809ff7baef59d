"""The check on a whole run at a tiny size on the CPU: sound runs come out
correct; the control in the program's place, and each fault planted under
the timed path, come out not correct (the cell's own limits)."""

import pytest

from portbench import faults
from portbench.tests.tiny import run_tiny

CELLS = ["graphmet-train-cms", "graphmet-infer-cms", "drn-infer-cms",
         "drn-train-cms"]
FAULTS = [("graphmet-train-cms", "unchanged"),
          ("graphmet-train-cms", "not_captured"),
          ("graphmet-train-cms", "half_batch"),
          ("graphmet-infer-cms", "half_batch"),
          ("graphmet-infer-cms", "altered"),
          ("drn-infer-cms", "half_batch"),
          ("drn-infer-cms", "altered"),
          ("drn-infer-cms", "no_matching"),
          ("drn-train-cms", "unchanged"),
          ("drn-train-cms", "not_captured"),
          ("drn-train-cms", "half_batch"),
          ("drn-train-cms", "no_matching")]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    outcome, result = run_tiny(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    outcome, result = run_tiny(cell, control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    with faults.plant(fault):
        outcome, result = run_tiny(cell)
    assert not result["correct"], result["checks"]


def test_traced_run_reports_per_layer_metrics():
    outcome, result = run_tiny("graphmet-infer-cms", trace=True)
    assert result["correct"]
    assert "host_collate_ms.serve" in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
