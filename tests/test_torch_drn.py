"""The port's DRN serving path against the JAX package's, on the CPU.

The JAX side runs its fused graph build and fused edge-MLP conv as Pallas
kernels in interpret mode (``graph_force="fused", conv_force="fused"``):
the port's kernels compute that path, while JAX's own CPU CLI takes the
composed XLA path, whose graph differs at hubs and in the matching's
adjacency (ROADMAP C).

``jax_drn_eval(2000, 8)`` recomputes ``chip_smoke.GOLDEN_DRN_LOSS`` and the
per-event files ``tests/golden_drn_val_{met,graphs}.npy`` (about 10 s per
batch of 8 at N=2048 on the CPU); ``jax_drn_eval(2000, 8, fused=False)``
the composed path's ``tests/golden_drn_composed_val_{met,graphs}.npy``; ``drn_divergence(2000, 8)`` counts the
events whose graph decisions differ between the packages (ROADMAP C).
"""

import os
import os.path as osp
import shutil

import numpy as np
import pytest

from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
DRN_CKPTS = osp.join(REPO, "ckpts_syn_drn")


def _jax_drn(restore_file: str = "best"):
    """(params, bn_state, cfg) of ``ckpts_syn_drn`` through the JAX
    package's own loader."""
    import argparse

    from deepmetv2_tpu.cli.common import load_model_for_eval, load_run_config

    cfg = load_run_config(DRN_CKPTS)
    args = argparse.Namespace(model="drn", from_torch=None,
                              restore_file=restore_file)
    params, bn_state, _ = load_model_for_eval(args, cfg, DRN_CKPTS)
    return params, bn_state, cfg


def _jax_fused_apply(cfg, fused: bool = True):
    """JAX ``drn_net_apply`` with both fused paths in interpret mode
    (``fused=False``: its CPU default, the composed build and the XLA-form
    conv): ``(pred, rounds)``, with ``rounds`` each round's (mask, idx,
    slot mask, cluster, partner) as its ``cut_matching`` sees and returns
    them."""
    import functools
    from unittest import mock

    import jax

    from deepmetv2_tpu.models.drn import drn_net_apply
    from deepmetv2_tpu.ops import dyn_graph as jdg

    forces = (dict(graph_force="fused", graph_interpret=True,
                   conv_force="fused", conv_interpret=True) if fused
              else {})
    net = functools.partial(drn_net_apply, train=False, cfg=cfg.drn,
                            **forces)
    match = jdg.cut_matching

    def apply(params, bn_state, batch):
        rounds = []

        def recorded(g, h, mask, *a, **kw):
            cluster, partner = match(g, h, mask, *a, **kw)
            rounds.append((mask, g.nbr.idx, g.nbr.mask, cluster, partner))
            return cluster, partner

        # drn_apply imports cut_matching from the module at call time
        with mock.patch.object(jdg, "cut_matching", recorded):
            pred, _ = net(params, bn_state, batch)
        return pred, rounds

    return jax.jit(apply)


def jax_drn_eval(n_events: int, batch_size: int, fused: bool = True):
    """The JAX package's DRN validation pass on synthetic ``n_events``
    (seed 42, validation split 0.2, ``batch_size``) from
    ``ckpts_syn_drn/best.ckpt``, fused path in interpret mode (``fused=
    False``: its CPU default, the composed path, the source of
    ``chip_smoke.GOLDEN_DRN_COMPOSED_MET`` and ``_GRAPHS`` at (2000, 8)):
    ``(loss, met, graphs)`` with the loss the mean of the per-batch
    ``drn_loss_fn`` (as ``train.loop.evaluate`` takes it), ``met`` the
    cartesian MET estimate of every validation event ``[n_val, 2]`` in the
    loader's order and ``graphs`` its per-round graph digests ``[n_val,
    rounds]`` (``chip_smoke.drn_graph_digests``).  At (2000, 8) these are
    ``chip_smoke.GOLDEN_DRN_LOSS``, ``GOLDEN_DRN_MET`` and
    ``GOLDEN_DRN_GRAPHS``."""
    import jax.numpy as jnp

    import chip_smoke
    from deepmetv2_tpu.data import fetch_dataloader, synthetic_events
    from deepmetv2_tpu.train.loss import drn_loss_fn, drn_met_vector

    params, bn_state, cfg = _jax_drn()
    apply = _jax_fused_apply(cfg, fused)
    ld = fetch_dataloader(events=synthetic_events(n_events, seed=42),
                          batch_size=batch_size, validation_split=0.2,
                          buckets=cfg.data.node_buckets)["test"]
    losses, mets, graphs = [], [], []
    for batch, ids in zip(ld, ld._batches):
        pred, rounds = apply(params, bn_state, batch)
        losses.append(drn_loss_fn(pred, batch, cfg.drn.head))
        mets.append(np.asarray(drn_met_vector(pred, cfg.drn.head))[:len(ids)])
        graphs.append(chip_smoke.drn_graph_digests(
            [[np.asarray(a) for a in r] for r in rounds])[:len(ids)])
    return (float(jnp.mean(jnp.stack(losses))), np.concatenate(mets),
            np.concatenate(graphs))


def jax_drn_eval_loss(n_events: int, batch_size: int) -> float:
    """The loss of ``jax_drn_eval``: the source of
    ``chip_smoke.GOLDEN_DRN_LOSS`` at (2000, 8)."""
    return jax_drn_eval(n_events, batch_size)[0]


def drn_divergence(n_events: int, batch_size: int):
    """Which validation events (``jax_drn_eval``'s order) the port on the
    CPU decides differently from the JAX package's fused path: ``(graphs,
    same_h, met_off)``.  ``graphs [n, rounds]``: the round's graph
    decisions differ (``drn_graph_digests``, each package from its own
    features); ``same_h [n]``: the round-1 neighbour lists differ even with
    the port building from the JAX package's round-1 features, which leaves
    only the order of the d² sums (the JAX graph its fused kernel in
    interpret mode, the port's its plain version, bitwise the card's
    kernel); ``met_off [n]``: the MET is off by chip_smoke's rule.  ROADMAP
    C compares them."""
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from deepmetv2_tpu.data import fetch_dataloader, synthetic_events
    from deepmetv2_tpu.nn.core import mlp_apply
    from deepmetv2_tpu.ops.pallas.knn_und import knn_und_graph as j_knn
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph as t_knn

    params, bn_state, cfg = _jax_drn()
    model = _port_drn(params, bn_state, cfg)
    k, cap = cfg.drn.k, cfg.drn.und_cap or 2 * cfg.drn.k
    ld = fetch_dataloader(events=synthetic_events(n_events, seed=42),
                          batch_size=batch_size, validation_split=0.2,
                          buckets=cfg.data.node_buckets)["test"]

    def lists(nbr):
        idx = np.where(np.asarray(nbr.mask), np.asarray(nbr.idx), 1 << 30)
        return np.sort(idx, axis=-1)

    same_h = []
    for batch, ids in zip(ld, ld._batches):
        x = np.concatenate([batch.x_cont, batch.x_cat.astype(np.float32)],
                           axis=-1)
        hj = mlp_apply(params["inputnet"], params["datanorm"] * jnp.asarray(x),
                       final_act=True)
        want = lists(j_knn(hj, jnp.asarray(batch.mask), k=k, cap=cap,
                           interpret=True)[0])
        got = lists(t_knn(torch.as_tensor(np.asarray(hj)),
                          torch.as_tensor(batch.mask), k=k, cap=cap)[0])
        diff = ((got != want).any(-1) & batch.mask).any(-1)
        same_h.append(diff[:len(ids)])
    _, met, graphs = chip_smoke.drn_eval_pass(model, ld, "cpu")
    _, jmet, jgraphs = jax_drn_eval(n_events, batch_size)
    dev = np.abs(met - jmet).max(axis=1)
    off = dev > chip_smoke.DRN_EVENT_RTOL * np.maximum(
        np.abs(jmet).max(axis=1), 1.0)
    return graphs != jgraphs, np.concatenate(same_h), off


def _port_drn(params, bn_state, cfg):
    import dataclasses

    from deepmetv2_tpu_torch.config import DRNConfig
    from deepmetv2_tpu_torch.models.drn import DRN

    tcfg = DRNConfig(**dataclasses.asdict(cfg.drn))
    return DRN(tcfg).params_from_jax(params, bn_state).eval()


@pytest.fixture(scope="module")
def jax_drn():
    return _jax_drn()


def test_drn_net_apply_matches_jax(jax_drn):
    """4 events of at most 400 candidates padded to N=512: both rounds,
    the compaction to 384 between them, the cartesian head."""
    import torch

    import chip_smoke
    from deepmetv2_tpu.data.batching import EventBatch as JBatch
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
    from deepmetv2_tpu_torch.models.drn import drn_net_apply

    params, bn_state, cfg = jax_drn
    host = collate(synthetic_events(4, seed=3, n_min=150, n_max=400),
                   pad_to=512)
    jpred, jrounds = _jax_fused_apply(cfg)(params, bn_state, JBatch(*host))
    model = _port_drn(params, bn_state, cfg)
    diag = {}
    with torch.no_grad():
        tpred = drn_net_apply(model, to_device(host, "cpu"), diag)
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jpred).max()))
    assert [int(d) for d in diag["compact_dropped"]] == [0]
    # both rounds' neighbour lists and matchings, as chip_smoke digests them
    want = chip_smoke.drn_graph_digests(
        [[np.asarray(a) for a in r] for r in jrounds])
    got = chip_smoke.drn_graph_digests(
        [[t.numpy() for t in (m, nbr.idx, nbr.mask, c, p)]
         for m, nbr, c, p in diag["rounds"]])
    assert got.shape == (4, 2)
    np.testing.assert_array_equal(got, want)
    assert tpred.shape == (4, 2) and bool(torch.isfinite(tpred).all())


def test_drn_polar_head():
    """The polar head: MET = scale·softplus, φ = π·(2·sigmoid − 1)."""
    import torch

    from deepmetv2_tpu_torch.config import DRNConfig
    from deepmetv2_tpu_torch.models import drn as tdrn

    out = torch.tensor([[-30.0, -3.0], [0.0, 0.0], [30.0, 3.0]])
    model = tdrn.DRN(DRNConfig(head="polar", output_scale=2.0)).eval()
    orig = tdrn.drn_apply
    try:
        tdrn.drn_apply = lambda m, x, mask, diag=None, *forces: out
        batch = type("B", (), dict(x_cont=torch.zeros(3, 1, 8),
                                   x_cat=torch.zeros(3, 1, 3),
                                   mask=torch.ones(3, 1, dtype=torch.bool)))
        pred = tdrn.drn_net_apply(model, batch)
    finally:
        tdrn.drn_apply = orig
    np.testing.assert_allclose(pred[:, 0].numpy(),
                               2.0 * np.logaddexp(out[:, 0].numpy(), 0),
                               rtol=1e-6)
    np.testing.assert_allclose(pred[:, 1].numpy(),
                               np.pi * np.tanh(out[:, 1].numpy() / 2),
                               rtol=1e-6)


def _ckpt_copy(d):
    os.makedirs(d)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(osp.join(DRN_CKPTS, f), d)
    return d


def test_evaluate_cli_matches_jax(tmp_path):
    """``cli.evaluate --model drn --device cpu`` on 20 synthetic events
    (one validation batch of 4) against the JAX package's fused path."""
    from deepmetv2_tpu_torch.cli import evaluate as t_eval
    from deepmetv2_tpu_torch.utils import artifacts

    ck = _ckpt_copy(str(tmp_path / "port"))
    got = t_eval.run(["--model", "drn", "--synthetic", "20", "--batch_size",
                      "8", "--ckpts", ck, "--device", "cpu"])["loss"]
    want = jax_drn_eval_loss(20, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert "MET" in artifacts.load(osp.join(ck, "best.resolutions"))


def test_predict_cli_matches_jax(tmp_path, jax_drn):
    """``cli.predict --model drn --device cpu``: the JAX CLI's keys, event
    order and candidate counts, and the fused path's MET."""
    import contextlib
    import io

    from deepmetv2_tpu.cli import predict as j_pred
    from deepmetv2_tpu.data import fetch_dataloader, synthetic_events
    from deepmetv2_tpu.train.loss import drn_met_vector
    from deepmetv2_tpu_torch.cli import predict as t_pred

    ck = _ckpt_copy(str(tmp_path / "ck"))
    argv = ["--model", "drn", "--synthetic", "4", "--batch_size", "8",
            "--ckpts", ck]
    with contextlib.redirect_stdout(io.StringIO()):
        assert j_pred.main(argv + ["--out", str(tmp_path / "j.npz")]) == 0
    assert t_pred.main(argv + ["--device", "cpu",
                               "--out", str(tmp_path / "t.npz")]) == 0
    j = dict(np.load(str(tmp_path / "j.npz")))
    t = dict(np.load(str(tmp_path / "t.npz")))
    assert set(t) == set(j) == {"event_index", "met_x", "met_y", "met",
                                "met_phi", "n_valid"}
    np.testing.assert_array_equal(t["event_index"], np.arange(4))
    np.testing.assert_array_equal(t["event_index"], j["event_index"])
    np.testing.assert_array_equal(t["n_valid"], j["n_valid"])
    # the JAX CLI takes the composed path on the CPU: hold the MET to the
    # fused path instead, on the same (only) batch
    params, bn_state, cfg = jax_drn
    ld = fetch_dataloader(events=synthetic_events(4, seed=42), batch_size=8,
                          validation_split=0.0,
                          buckets=cfg.data.node_buckets)["train"]
    (batch,) = list(ld)
    pred, _ = _jax_fused_apply(cfg)(params, bn_state, batch)
    v = np.asarray(drn_met_vector(pred, cfg.drn.head))[:4]
    order = np.argsort(np.concatenate(ld._batches))
    np.testing.assert_allclose(t["met_x"], v[order, 0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t["met_y"], v[order, 1], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("cli", ["evaluate", "predict"])
def test_drn_cli_without_gpu_exits_nonzero(cli, tmp_path):
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    mod = importlib.import_module(f"deepmetv2_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit) as exc:
        mod.main(["--model", "drn", "--synthetic", "4",
                  "--ckpts", str(tmp_path)])
    assert "no CUDA GPU" in str(exc.value.code)
