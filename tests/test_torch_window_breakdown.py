"""The window-max breakdown probe
(``deepmetv2_tpu_torch/probes/window_breakdown.py``) on the CPU: every
variant's cuts still match ``csrc/window_max.cu``, its inputs (which
``chip_smoke.py``'s kernel lines time too) give the chunk counts of an
independent count, and it refuses to run without a GPU.  The variants
themselves build and run only on the card."""

import pytest
import torch

from deepmetv2_tpu_torch.probes import window_breakdown as wb
from tests.torch_threads import few_torch_threads  # noqa: F401


@pytest.mark.parametrize("name", sorted(wb.VARIANTS))
def test_variant_cuts_match_the_source(name):
    full = wb.variant_source("full")
    src = wb.variant_source(name)
    assert (src == full) == (name == "full")
    for _, new in wb.VARIANTS[name]:
        assert new in src


def test_variant_refuses_a_stale_cut(monkeypatch):
    monkeypatch.setitem(wb.VARIANTS, "stale", [("no such line", "")])
    with pytest.raises(ValueError, match="does not match"):
        wb.variant_source("stale")


def test_smoke_chunk_counts():
    # chip_smoke.py's kept / window chunk visits and blocks with a real row
    # on the probe's (and the smoke's) batches, counted by the prune's
    # oracle; an independent numpy count of the same rule gave these
    import chip_smoke

    for name, want in (("train", (1209, 6320, 229)),
                       ("eval", (5129, 22240, 1129))):
        _, pos, halo = wb.probe_inputs("cpu")[name]
        assert chip_smoke.chunk_counts(pos, halo, wb.R ** 2) == want


def test_probe_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the probe runs")
    assert wb.main() == 1
    assert "no CUDA GPU" in capsys.readouterr().err
