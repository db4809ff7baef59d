"""One short run of each cell on the card (``-m card``; skips without
one)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", ["graphmet-train-cms", "graphmet-infer-cms",
                                  "drn-infer-cms"])
def test_short_run_on_the_card_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        cell, "--seed", "12345", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", ["graphmet-train-cms", "graphmet-infer-cms",
                                  "drn-infer-cms"])
def test_one_seed_gives_the_same_checks_twice(cell):
    """The port's timed path and the reference (``cell.deterministic``)
    both repeat bit for bit, so two runs at one seed compare the same
    numbers."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    checks = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            cell, "--seed", "3141592653", "--seconds", "2",
                            "--trace", "0"], cwd=ROOT, capture_output=True,
                           text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        checks.append(json.loads(p.stdout.strip().splitlines()[-1])["checks"])
    assert checks[0] == checks[1]
