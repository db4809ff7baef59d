"""The knn breakdown probe (``deepmetv2_tpu_torch/probes/knn_breakdown.py``)
on the CPU: every variant's cuts still match ``csrc/knn_und.cu``, its
inputs are the DRN's round-1 features of the evaluation batch that
``chip_smoke.py`` times, and it refuses to run without a GPU.  The variants
themselves build and run only on the card."""

import pytest
import torch

from deepmetv2_tpu_torch.data import to_device
from deepmetv2_tpu_torch.probes import knn_breakdown as kb
from tests.torch_threads import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("name", sorted(kb.VARIANTS))
def test_variant_cuts_match_the_source(name):
    full = kb.variant_source("full")
    src = kb.variant_source(name)
    assert (src == full) == (name == "full")
    for _, new in kb.VARIANTS[name]:
        assert new in src


def test_variant_refuses_a_stale_cut(monkeypatch):
    monkeypatch.setitem(kb.VARIANTS, "stale", [("no such line", "")])
    with pytest.raises(ValueError, match="does not match"):
        kb.variant_source("stale")


def test_probe_inputs_are_the_smoke_tests():
    import chip_smoke

    h, mask = kb.probe_inputs("cpu")
    model, cfg = chip_smoke.drn_model("cpu")
    batch = to_device(next(iter(chip_smoke.drn_val_loader(
        cfg, chip_smoke.DRN_B))), "cpu")
    assert h.shape == (40, 2048, 64) and mask.dtype == torch.bool
    assert torch.equal(mask, batch.mask)
    assert torch.equal(h, chip_smoke.drn_features(model, batch))


def test_probe_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the probe runs")
    assert kb.main() == 1
    assert "no CUDA GPU" in capsys.readouterr().err
