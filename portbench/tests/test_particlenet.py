"""The ParticleNet family as new files only: its cell resolves from
``BENCHMARK.json``, runs through the tiny CPU cell path correct, and each
fault planted under its timed path (and its control in the program's
place) comes out not correct; its counts by hand; one
short run on the card (``-m card``)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import faults, spec
from portbench.counts import knn
from portbench.counts import particlenet as pn_counts
from portbench.faults import patched
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELL = "particlenet-train-cms"
NEW = ["device_idle.pn_train", "kernel_roofline.pn_train",
       "step_mfu.pn_train"]


def run_tiny(**kw):
    with patched(tiny, "SIZES", dict(tiny.SIZES, **{
            CELL: dict(events=12, batch=4)})):
        return tiny.run_tiny(CELL, **kw)


def test_benchmark_resolves_the_new_entries():
    s = spec.cell_spec(CELL)
    assert s.config["family"] == "particlenet" and s.chips == 1
    assert s.config["reduced"] == []
    assert {m["name"] for m in s.end_to_end} == {"drn_train_events_per_s",
                                                 "setup_s"}
    assert [m["name"] for m in s.per_layer] == NEW
    for m in s.per_layer:
        assert m["moves"] == "drn_train_events_per_s"
        assert callable(spec.reader(m["name"]))
    assert s.limits["graph_faults"] == 0 and "knn_tol" in s.limits
    pats = spec.load_json(spec.HERE / "counts" / "kernels" / "pn_edge.json")
    assert set(pats["per_wrapper"]) == {"pn_edge_fwd", "pn_edge_bwd"}


def test_sound_run_is_correct():
    outcome, result = run_tiny()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["checks"]) == {"loss_rel", "grad_gap", "change_med",
                                     "graph_faults", "chain_change"}


def test_control_is_not_correct():
    outcome, result = run_tiny(control=True)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "not_captured", "half_batch",
                                   "altered", "no_dropout"])
def test_planted_fault_is_not_correct(fault):
    with faults.plant(fault):
        outcome, result = run_tiny()
    assert not result["correct"], result["checks"]


def test_counts_by_hand():
    assert pn_counts.edges([20, 10, 1], 16) == 20 * 16 + 10 * 9
    assert pn_counts.fwd_ops(10, 100, 4, 8) == 4 * 4 * 8 * 10 + 8 * 100 \
        + 4 * 64 * 100
    assert pn_counts.bwd_ops(10, 100, 4, 8) == 8 * 4 * 8 * 10 + (
        8 * 64 + 16) * 100
    assert pn_counts.fusion_widths([[64] * 3, [128] * 3, [256] * 3]) == (
        448, 384)
    pn = {"input_dim": 11, "k": 16, "conv_params": [[64] * 3], "fc": 4}
    n = [20, 30]
    E = pn_counts.edges(n, 16)
    products = (pn_counts.fwd_ops(50, E, 11, 64) + 2 * 11 * 64 * 50
                + 2 * 64 * 128 * 50 + 2 * 2 * (128 * 4 + 4 * 2))
    assert pn_counts.train_ops(n, pn) == 3 * products + knn.ops(n, 2)


def test_traced_run_reports_what_the_cpu_can():
    outcome, result = run_tiny(trace=True)
    assert result["correct"]
    assert "step_mfu.pn_train" in result["metrics"]


@pytest.mark.card
def test_short_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELL, "--seed", "2718281828", "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert set(result["metrics"]) == set(NEW)
    assert all(0 < v["value"] <= 100 for v in result["metrics"].values())
