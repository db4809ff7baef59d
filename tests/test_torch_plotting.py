"""The port's plotting (deepmetv2_tpu_torch/plotting/, cli/plot.py,
cli/plot_weight.py) against the JAX package's: the same file names and
artifact layout, and on the same events and weights the same weight
summary (keys, labels, bin edges and counts exact, mean weights within
rtol 1e-5), on the CPU; and the port's trace file (utils/profiling.py)."""

import json
import os
import os.path as osp
import shutil

import numpy as np
import pytest

from deepmetv2_tpu.plotting import compute_weight_summary as j_summary
from deepmetv2_tpu.plotting.resolution import _FIGURES
from deepmetv2_tpu.utils import artifacts as j_artifacts
from tests.test_torch_serve import _boundary_pairs
from tests.torch_mesh_worker import REPO
from tests.torch_threads import few_torch_threads  # noqa: F401

MEAN_RTOL = 1e-5
WEIGHT_PNGS = ("weight_vs_pt.png", "weight_vs_eta.png", "weight_vs_puppi.png",
               "weight_ch_dist.png", "qt_spectra.png")


def _ckpt_copy(d, files=("config.json", "best.ckpt")):
    os.makedirs(d)
    for f in files:
        shutil.copy(osp.join(REPO, "ckpts_syn", f), d)
    return str(d)


def test_plot_cli_writes_the_jax_cli_files(tmp_path):
    """``cli.plot`` on a copy of ckpts_syn/best.resolutions writes the five
    PNGs the JAX CLI writes, under its names."""
    from deepmetv2_tpu_torch.cli import plot

    ck = _ckpt_copy(tmp_path / "ck", ("best.resolutions",))
    assert plot.main(["--ckpts", ck, "--restore_file", "best"]) == 0
    for _, suffix, _, _ in _FIGURES:
        path = osp.join(ck, "best_" + suffix)
        assert osp.getsize(path) > 1000, path


def _clean_events(n):
    """``n`` synthetic events of 50-250 candidates with no pair on the
    radius boundary (where the packages' graphs may differ by an ulp)."""
    from deepmetv2_tpu_torch.data import synthetic_events

    events = synthetic_events(3 * n, seed=3, n_min=50, n_max=250)
    return [e for e in events if not _boundary_pairs(e[0])][:n]


def test_weight_summary_matches_jax():
    """compute_weight_summary over 40 events (validation half of 80) with
    ckpts_syn's weights in the run config's graph mode (neighbor_list, as
    the CLIs take it), against the JAX package's on the same events."""
    import jax

    from deepmetv2_tpu.cli.common import load_run_config as j_config
    from deepmetv2_tpu.data import fetch_dataloader as j_loader
    from deepmetv2_tpu.train.checkpoint import load_checkpoint as j_load
    from deepmetv2_tpu.train.step import make_eval_step as j_eval_step
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.plotting import compute_weight_summary
    from deepmetv2_tpu_torch.train.step import make_eval_step

    events = _clean_events(80)
    assert len(events) == 80
    kw = dict(batch_size=20, validation_split=0.5, buckets=(256,))
    ck = osp.join(REPO, "ckpts_syn")
    jcfg = j_config(ck)
    state, _ = j_load(osp.join(ck, "best.ckpt"))
    want = j_summary(j_eval_step(jcfg), state.params, state.bn_state,
                     j_loader(events=events, **kw)["test"], jcfg)
    cfg = load_run_config(ck)
    assert cfg.graph.mode == jcfg.graph.mode == "neighbor_list"
    model = GraphMET(cfg.model).params_from_jax(
        *jax.tree_util.tree_map(np.asarray, (state.params, state.bn_state)))
    ld = fetch_dataloader(events=events, **kw)["test"]
    assert sum(len(ids) for ids in ld._batches) == 40
    got = compute_weight_summary(make_eval_step(cfg), model, ld)
    assert set(got) == set(want)
    for name, edges in want["bin_edges"].items():
        np.testing.assert_array_equal(got["bin_edges"][name], edges)
    for key in ("weight_CH_hist", "weight_qT_hist"):       # counts
        assert list(got[key]) == list(want[key])
        for lab, v in want[key].items():
            np.testing.assert_array_equal(got[key][lab], v, err_msg=lab)
    for key in ("weight_pt_hist", "weight_eta_hist", "weight_puppi_hist"):
        assert list(got[key]) == list(want[key])          # labels, in order
        for lab, v in want[key].items():
            np.testing.assert_allclose(got[key][lab], v, rtol=MEAN_RTOL,
                                       err_msg=lab)


def test_plot_weight_cli_writes_the_jax_cli_files(tmp_path):
    """``cli.plot_weight --device cpu`` on a copy of ckpts_syn: weight.plt,
    which both packages load with the summary's keys, and the JAX CLI's
    five PNGs."""
    from deepmetv2_tpu_torch.cli import plot_weight
    from deepmetv2_tpu_torch.utils import artifacts

    ck = _ckpt_copy(tmp_path / "ck")
    assert plot_weight.main(["--ckpts", ck, "--restore_file", "best",
                             "--synthetic", "8", "--batch_size", "4",
                             "--device", "cpu"]) == 0
    keys = {"bin_edges", "weight_pt_hist", "weight_eta_hist",
            "weight_puppi_hist", "weight_CH_hist", "weight_qT_hist"}
    for load in (artifacts.load, j_artifacts.load):
        assert set(load(osp.join(ck, "weight.plt"))) == keys
    for name in WEIGHT_PNGS:
        assert osp.getsize(osp.join(ck, "weight_" + name)) > 1000, name


def test_plot_weight_cli_without_gpu_exits_nonzero(tmp_path):
    """The default device is cuda: with no card the CLI exits non-zero."""
    import torch

    from deepmetv2_tpu_torch.cli import plot_weight

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    with pytest.raises(SystemExit) as exc:
        plot_weight.main(["--ckpts", str(tmp_path), "--synthetic", "4"])
    assert "no CUDA GPU" in str(exc.value.code)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    """``trace`` around an annotated CPU region writes trace.json with the
    annotation's event."""
    import torch

    from deepmetv2_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("deepmet_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "deepmet_region" for e in events)
