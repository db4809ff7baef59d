"""GraphMET in neighbor_list mode (the radius graph's lists, capped at the
nearest ``max_neighbors``) in the port against the JAX package, on the CPU:
the forward on the committed weights, the evaluate and predict CLIs,
resumed train steps, the BatchNorm refresh and the train CLI.

Tolerances: the forward atol 1e-5 on weights in (0, 1), train losses rtol
2e-5 and parameters as tests/test_torch_train.py holds them (its
``_assert_same_model``), the CLIs' loss and MET rtol 1e-4 and weights atol
1e-5, as tests/test_torch_serve.py holds window mode; an event may miss
those only where it has a pair on the radius boundary, which the packages
may decide differently (``_boundary_pairs``, ROADMAP C).

``python -c "from tests.test_torch_train import jax_nl_resume_losses;
print(jax_nl_resume_losses(10))"`` recomputes
``chip_smoke.GOLDEN_NL_TRAIN_LOSSES``.
"""

import contextlib
import dataclasses
import io
import itertools
import json
import os
import os.path as osp
import shutil

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import DataConfig as JDataConfig
from deepmetv2_tpu.config import GraphConfig as JGraphConfig
from deepmetv2_tpu.data import collate as j_collate
from deepmetv2_tpu.data import loader as jl
from deepmetv2_tpu.models.graph_met import graph_met_init as j_init
from deepmetv2_tpu.models.graph_met import net_apply as j_net
from deepmetv2_tpu.train import checkpoint as jck
from deepmetv2_tpu.train.step import build_graph as j_build
from deepmetv2_tpu.train.step import init_train_state
from deepmetv2_tpu.train.step import make_bn_refresh_step as j_refresh
from deepmetv2_tpu.utils import artifacts as j_artifacts
from deepmetv2_tpu_torch.config import Config, DataConfig, GraphConfig
from deepmetv2_tpu_torch.data.batching import Neighborhood, to_device
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.models.graph_met import GraphMET, net_apply
from deepmetv2_tpu_torch.train import step as tstep
from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
from tests.test_torch_serve import _boundary_pairs
from tests.test_torch_train import (CKPT, _assert_same_model, _jax_steps,
                                    _port_steps, jax_nl_resume_losses)
from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
K_SMALL = 32      # max_neighbors of the small train cases


def _configs(k=256, batch_size=4):
    g = dict(mode="neighbor_list", max_neighbors=k)
    return (JConfig(graph=JGraphConfig(**g),
                    data=JDataConfig(batch_size=batch_size)),
            Config(graph=GraphConfig(**g), data=DataConfig(batch_size=batch_size)))


@pytest.fixture(scope="module")
def small():
    """Unsorted train batches of 4 events in the 256 bucket."""
    events = synthetic_events(40, seed=3, n_min=60, n_max=250)
    ld = jl.fetch_dataloader(events=events, batch_size=4,
                             buckets=(256,))["train"]
    return list(itertools.islice(iter(ld), 4))


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax_from_checkpoint(train):
    batch = j_collate(synthetic_events(4, seed=8, n_min=60, n_max=250),
                      buckets=(256,), pad_events_to=5)
    p = j_artifacts.load(CKPT)
    jcfg, tcfg = _configs()
    jb, jg = j_build(batch, jcfg)
    jw, jstate = j_net(p["params"], p["bn_state"], jb, jg, train=train)
    model = GraphMET(tcfg.model).params_from_jax(p["params"], p["bn_state"])
    model.train(train)
    tb, tg = tstep.build_graph(to_device(batch, "cpu"), tcfg)
    assert isinstance(tg, Neighborhood)
    np.testing.assert_array_equal(tg.idx.numpy(), np.asarray(jg.idx))
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))
    with torch.no_grad():
        tw = net_apply(model, tb, tg)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-5)
    if train:
        want = GraphMET(tcfg.model).params_from_jax(p["params"], jstate)
        for (path, got), (_, ref) in zip(model.jax_layout(),
                                         want.jax_layout()):
            np.testing.assert_allclose(got.detach().numpy(),
                                       ref.detach().numpy(), rtol=0,
                                       atol=1e-5, err_msg=str(path))


def test_phi_wraparound_graph_matches_jax():
    batch = j_collate(synthetic_events(3, seed=9, n_min=60, n_max=250),
                      buckets=(256,))
    jcfg, tcfg = _configs(k=K_SMALL)
    jcfg = dataclasses.replace(jcfg, graph=dataclasses.replace(
        jcfg.graph, phi_wraparound=True, self_loops=False))
    tcfg = dataclasses.replace(tcfg, graph=dataclasses.replace(
        tcfg.graph, phi_wraparound=True, self_loops=False))
    _, jg = j_build(batch, jcfg)
    _, tg = tstep.build_graph(to_device(batch, "cpu"), tcfg)
    np.testing.assert_array_equal(tg.idx.numpy(), np.asarray(jg.idx))
    np.testing.assert_array_equal(tg.mask.numpy(), np.asarray(jg.mask))


def test_resumed_train_steps_match_jax(small):
    """3 steps from ckpts_syn/best.ckpt (weights, BatchNorm, AdamW state)
    at max_neighbors 32, then the BatchNorm refresh."""
    jcfg, tcfg = _configs(k=K_SMALL)
    template = init_train_state(*j_init(jax.random.PRNGKey(0)), jcfg)
    state, _ = jck.load_checkpoint(CKPT, template=template)
    state, want = _jax_steps(state, jcfg, small[:3])
    model = GraphMET(tcfg.model)
    opt = tstep.make_optimizer(tcfg, model)
    restore_checkpoint(CKPT, model, opt)
    got = _port_steps(model, opt, tcfg, small[:3])
    np.testing.assert_allclose(got, want, rtol=2e-5)
    _assert_same_model(model, state.params, state.bn_state, 3)

    new_bn = j_refresh(jcfg)(state.params, state.bn_state, small[3])
    tstep.make_bn_refresh_step(tstep.graphmet_objective(tcfg))(
        model, to_device(small[3], "cpu"))
    _assert_same_model(model, state.params, new_bn, 3)


def test_golden_nl_train_losses_guard():
    """The first of chip_smoke.GOLDEN_NL_TRAIN_LOSSES, recomputed with the
    JAX package and with the port on the CPU (rtol 1e-4, the smoke test's
    limit on the card)."""
    golden = chip_smoke.GOLDEN_NL_TRAIN_LOSSES
    assert len(golden) == 10
    np.testing.assert_allclose(jax_nl_resume_losses(1), golden[:1],
                               rtol=1e-6)
    ld = jl.fetch_dataloader(events=synthetic_events(2000, seed=42),
                             batch_size=8)["train"]
    _, tcfg = _configs(batch_size=8)
    model = GraphMET(tcfg.model)
    opt = tstep.make_optimizer(tcfg, model)
    restore_checkpoint(CKPT, model, opt)
    got = _port_steps(model, opt, tcfg, [next(iter(ld))])
    np.testing.assert_allclose(got, golden[:1], rtol=chip_smoke.LOSS_RTOL)


def _ckpt_copy(d):
    os.makedirs(d)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(osp.join(REPO, "ckpts_syn", f), d)
    return d


@pytest.fixture(scope="module")
def serve(tmp_path_factory):
    """JAX and port evaluate (40 events: one validation batch of 8) and
    predict (the same 40) in neighbor_list mode."""
    from deepmetv2_tpu.cli import evaluate as j_eval
    from deepmetv2_tpu.cli import predict as j_pred
    from deepmetv2_tpu_torch.cli import evaluate as t_eval
    from deepmetv2_tpu_torch.cli import predict as t_pred

    base = tmp_path_factory.mktemp("nl")
    jck_, tck = _ckpt_copy(str(base / "jax")), _ckpt_copy(str(base / "port"))
    ev = ["--synthetic", "40", "--batch_size", "8", "--graph_mode",
          "neighbor_list"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_eval.main(ev + ["--ckpts", jck_]) == 0
        assert j_pred.main(ev + ["--ckpts", jck_,
                                 "--out", str(base / "j.npz")]) == 0
    j_loss = float(out.getvalue().split("validation loss:")[1].split()[0])
    t_loss = t_eval.run(ev + ["--ckpts", tck, "--device", "cpu"])["loss"]
    assert t_pred.main(ev + ["--ckpts", tck, "--device", "cpu",
                             "--out", str(base / "t.npz")]) == 0
    return dict(j_loss=j_loss, t_loss=t_loss,
                j=dict(np.load(str(base / "j.npz"))),
                t=dict(np.load(str(base / "t.npz"))))


def test_evaluate_cli_matches_jax(serve):
    np.testing.assert_allclose(serve["t_loss"], serve["j_loss"], rtol=1e-4)


def test_predict_cli_matches_jax(serve):
    j, t = serve["j"], serve["t"]
    assert set(j) == set(t) and "weights" in t
    np.testing.assert_array_equal(t["event_index"], j["event_index"])
    np.testing.assert_array_equal(t["n_valid"], j["n_valid"])
    events = synthetic_events(len(t["met"]), seed=42)
    off = [e for e in range(len(events))
           if np.abs(t["weights"][e] - j["weights"][e]).max() > 1e-5
           or not np.allclose(t["met"][e], j["met"][e], rtol=1e-4)]
    assert len(off) <= len(events) // 10, off
    for e in off:
        assert _boundary_pairs(events[e][0]), e
    keep = np.setdiff1d(np.arange(len(events)), off)
    np.testing.assert_allclose(t["weights"][keep], j["weights"][keep],
                               rtol=0, atol=1e-5)


def test_train_cli_runs_chained_on_cpu(tmp_path):
    """One epoch of ``--graph_mode neighbor_list`` (chains of 8 as loops on
    the CPU), every artifact, no window line, an unsorted config."""
    from deepmetv2_tpu_torch.cli import train as train_cli

    ck = str(tmp_path / "ck")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_cli.main(["--synthetic", "20", "--batch_size", "4",
                               "--epochs", "1", "--ckpts", ck, "--device",
                               "cpu", "--graph_mode", "neighbor_list"]) == 0
    text = out.getvalue()
    assert "graph mode: window" not in text
    assert "feed: resident, chain 8, eager" in text.splitlines()
    for f in ("loss.log", "metrics_val_best.json", "best.ckpt", "last.ckpt",
              "best.resolutions", "config.json"):
        assert osp.exists(osp.join(ck, f)), f
    cfg = json.load(open(osp.join(ck, "config.json")))
    assert cfg["graph"]["mode"] == "neighbor_list"
    assert not cfg["graph"]["presorted"]
    with open(osp.join(ck, "metrics_val_best.json")) as f:
        assert np.isfinite(json.load(f)["loss"])
