"""The edge-MLP breakdown probe
(``deepmetv2_tpu_torch/probes/edge_mlp_breakdown.py``) on the CPU: every
variant's cuts still match ``csrc/edge_mlp.cu`` and it refuses to run
without a GPU.  The variants themselves build and run only on the card."""

import pytest
import torch

from deepmetv2_tpu_torch.probes import edge_mlp_breakdown as eb


@pytest.mark.parametrize("name", sorted(eb.VARIANTS))
def test_variant_cuts_match_the_source(name):
    full = eb.variant_source("full")
    src = eb.variant_source(name)
    assert (src == full) == (name == "full")
    for _, new in eb.VARIANTS[name]:
        assert new in src


def test_variant_refuses_a_stale_cut(monkeypatch):
    monkeypatch.setitem(eb.VARIANTS, "stale", [("no such line", "")])
    with pytest.raises(ValueError, match="does not match"):
        eb.variant_source("stale")


def test_probe_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the probe runs")
    assert eb.main() == 1
    assert "no CUDA GPU" in capsys.readouterr().err
