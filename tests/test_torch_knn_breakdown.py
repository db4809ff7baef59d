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


def test_cell_inputs_are_the_cells_events():
    from deepmetv2_tpu_torch.data import synthetic_events

    h, mask = kb.cell_inputs("cpu", 6144)
    n = mask.sum(dim=1)
    assert h.shape == (40, 6144, 64) and mask.dtype == torch.bool
    assert int(n.min()) >= 500 and int(n.max()) <= 5000
    # prefix masks, the events' own counts, the same events on every call
    assert torch.equal(mask, torch.arange(6144)[None] < n[:, None])
    events = synthetic_events(40, seed=kb.CELL_SEED, n_min=500, n_max=5000)
    assert n.tolist() == [x.shape[0] for x, _ in events]
    h2, mask2 = kb.cell_inputs("cpu", 8192)
    assert torch.equal(mask2[:, :6144], mask) and not mask2[:, 6144:].any()
    assert torch.equal(h2[:, :6144][mask], h[mask])


def test_count_summary_reads_real_rows_only():
    mask = torch.zeros((2, 8), dtype=torch.bool)
    mask[0, :4] = True
    mask[1, :3] = True
    counts = torch.zeros((2, 8, 2), dtype=torch.int32)
    counts[0, :4, 0] = torch.tensor([3, 2, 1, 0])
    counts[0, :4, 1] = torch.tensor([1, 2, 1, 1])
    counts[1, :3] = torch.tensor([[2, 1], [2, 3], [0, 1]])
    counts[0, 5] = 99                    # a padded row: not read
    got = kb.count_summary(counts, mask)
    assert got["pass_share"] == pytest.approx(10 / (4 * 3 + 3 * 2))
    assert got["merges_mean"] == pytest.approx(10 / 7)
    assert got["merges_max"] == 3
