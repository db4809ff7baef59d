"""The port's device-resident epoch feed (deepmetv2_tpu_torch/train/
resident.py), its streamed feed (data/loader.prefetch_to_device), the
capturable optimizer and ``fit`` under each feed, on the CPU.

As tests/test_resident.py holds the JAX package's feed: the epoch is
staged once and the same tensors come back in every epoch, and ``fit``
with the resident feed and chains of 3 writes the same ``loss.log`` and
``metrics_val_last.json`` as the streamed per-step feed, on one bucket and
on several; a resumed 2+2-epoch run writes what a 4-epoch run writes.
Sizes: 40 synthetic events, batches of 4 in the bucket of 64.
"""

import dataclasses
import warnings
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from deepmetv2_tpu.data import fetch_dataloader as j_fetch
from deepmetv2_tpu.train.resident import ResidentFeed as JResidentFeed
from deepmetv2_tpu_torch.config import (Config, DataConfig, GraphConfig,
                                        TrainConfig)
from deepmetv2_tpu_torch.data import fetch_dataloader
from deepmetv2_tpu_torch.data.loader import prefetch_to_device
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.train import resident as tres
from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
from deepmetv2_tpu_torch.train.loop import fit
from deepmetv2_tpu_torch.train.resident import ResidentFeed
from deepmetv2_tpu_torch.train.step import make_optimizer, set_learning_rate
from tests.test_torch_train import CKPT
from tests.torch_threads import few_torch_threads  # noqa: F401


def _events(n=40, seed=13, cap=64):
    return synthetic_events(n, seed=seed, n_min=8, n_max=cap - 1)


def _loaders(events, buckets=(64,), fetch=fetch_dataloader, **kw):
    return fetch(events=events, batch_size=4, validation_split=0.2,
                 buckets=buckets, **kw)


def _mixed_events():
    return (synthetic_events(16, seed=3, n_min=8, n_max=60)
            + synthetic_events(16, seed=4, n_min=70, n_max=120)
            + synthetic_events(8, seed=5, n_min=8, n_max=60))


def test_stages_once_and_replays_the_same_tensors():
    ld = _loaders(_events())["train"]
    calls = []
    real = tres.to_device

    def counting(batch, device):
        calls.append(1)
        return real(batch, device)

    feed = ResidentFeed(ld, chain=3, place="cpu")
    with mock.patch.object(tres, "to_device", counting):
        first = list(feed)
        staged = len(calls)
        second = list(feed)
    assert staged == len(first) == len(feed) == 3      # 8 batches: 3, 3, 2
    assert len(calls) == staged                        # nothing staged again
    for a, b in zip(first, second):
        assert all(x is y for x, y in zip(a, b))
    assert [k for k, _ in feed.meta] == [3, 3, 2] and feed.n_steps == 8
    assert feed.nbytes() == sum(t.nbytes for s in first for t in s) > 0
    hosts = list(ld)
    np.testing.assert_array_equal(first[1].x_cont[0].numpy(),
                                  hosts[3].x_cont)


@pytest.mark.parametrize("chain,buckets", [(1, (64,)), (3, (64,)),
                                           (4, (64, 128))])
def test_meta_matches_the_jax_feed(chain, buckets):
    """One ``(steps, real nodes)`` per stack, as the JAX feed's ``meta``
    on the same events."""
    events = _events() if len(buckets) == 1 else _mixed_events()
    ours = ResidentFeed(_loaders(events, buckets)["train"], chain=chain,
                        place="cpu")
    theirs = JResidentFeed(_loaders(events, buckets, j_fetch)["train"],
                           chain=chain, place=jax.device_put)
    assert len(list(ours)) == len(list(theirs))
    assert ours.meta == [(int(k), int(n)) for k, n in theirs.meta]


def test_max_bytes_streams_the_epoch():
    ld = _loaders(_events())["train"]
    feed = ResidentFeed(ld, chain=2, place="cpu", max_bytes=16)
    with pytest.warns(UserWarning, match="exceeds max_bytes"):
        streamed = list(feed)
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # one warning, not one per epoch
        again = list(feed)
    staged = list(ResidentFeed(ld, chain=2, place="cpu"))
    assert feed.nbytes() == 0 and len(streamed) == len(again) == len(staged)
    assert [k for k, _ in feed.meta] == [2, 2, 2, 2]
    for a, b in zip(again, staged):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_refuses_a_loader_without_the_replay_promise():
    batches = list(_loaders(_events())["train"])
    with pytest.raises(ValueError, match="replays_same_batches"):
        ResidentFeed(batches, chain=2, place="cpu")


def test_prefetch_yields_the_host_batches_in_order():
    hosts = list(_loaders(_events())["train"])
    got = list(prefetch_to_device(iter(hosts), place="cpu"))
    assert len(got) == len(hosts)
    for g, h in zip(got, hosts):
        for x, y in zip(g, h):
            assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            np.testing.assert_array_equal(x.numpy(), y)


def test_optimizer_is_capturable_only_when_asked_or_on_cuda():
    model = GraphMET()
    opt = make_optimizer(Config(), model)
    g = opt.param_groups[0]
    assert g["capturable"] is False and g["lr"] == 1e-3
    set_learning_rate(opt, 5e-4)
    assert g["lr"] == 5e-4
    cap = make_optimizer(Config(), model, capturable=True)
    g = cap.param_groups[0]
    assert g["capturable"] is True and isinstance(g["lr"], torch.Tensor)
    assert g["lr"].dtype == torch.float32 and g["lr"].dim() == 0
    lr = g["lr"]
    set_learning_rate(cap, 5e-4)
    assert g["lr"] is lr and float(lr) == np.float32(5e-4)


def test_jax_checkpoint_restores_into_a_capturable_optimizer():
    """A CUDA-free stand-in for the card's optimizer (``capturable=True``,
    the lr a tensor, on CPU parameters): the restore keeps the lr tensor
    and writes the checkpoint's lr into it, and the step counts land on
    the parameters' device as float32."""
    model = GraphMET()
    opt = make_optimizer(Config(), model, capturable=True)
    lr = opt.param_groups[0]["lr"]
    payload = restore_checkpoint(CKPT, model, opt)
    g = opt.param_groups[0]
    assert g["lr"] is lr and g["capturable"] is True
    want = float(payload["opt_state"].hyperparams["learning_rate"])
    assert float(lr) == np.float32(want)
    st = opt.state[model.encode_all.w]
    assert st["step"].dtype == torch.float32
    assert st["step"].device == model.encode_all.w.device
    assert int(st["step"]) == int(payload["step"])
    assert model.optimizer_state_to_jax(opt)["lr"] == float(np.float32(want))


def _fit(tmp_path, name, loaders, buckets, chain, resident, epochs=2,
         restore=None, seed=3):
    cfg = Config(graph=GraphConfig(mode="window", window_halo=max(buckets),
                                   presorted=True),
                 data=DataConfig(batch_size=4, node_buckets=buckets),
                 train=TrainConfig(epochs=epochs, chain_steps=chain,
                                   resident_feed=resident))
    model = GraphMET(cfg.model, generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(cfg, model)
    ck = tmp_path / name
    fit(model, opt, cfg, loaders["train"], loaders["test"], str(ck), "cpu",
        restore_file=restore, verbose=False)
    return ck


def _rows(ck):
    return [ln for ln in (ck / "loss.log").read_text().splitlines()
            if ln[:1].isdigit()]


@pytest.mark.parametrize("buckets", [(64,), (64, 128)])
def test_fit_resident_chained_equals_streaming_per_step(tmp_path, buckets):
    events = _events() if len(buckets) == 1 else _mixed_events()
    loaders = _loaders(events, buckets, presort_eta=True, presort_mode="cell")
    res = _fit(tmp_path, "res", loaders, buckets, chain=3, resident=True)
    seq = _fit(tmp_path, "seq", loaders, buckets, chain=1, resident=False)
    assert _rows(res) == _rows(seq) and len(_rows(res)) == 2
    assert ((res / "metrics_val_last.json").read_text()
            == (seq / "metrics_val_last.json").read_text())


def test_resume_under_the_resident_feed(tmp_path):
    """A 2-epoch run resumed to 4 writes the 4-epoch run's loss.log."""
    loaders = _loaders(_events(), presort_eta=True, presort_mode="cell")
    whole = _fit(tmp_path, "whole", loaders, (64,), 3, True, epochs=4)
    part = _fit(tmp_path, "part", loaders, (64,), 3, True, epochs=2)
    _fit(tmp_path, "part", loaders, (64,), 3, True, epochs=4,
         restore="last", seed=7)
    assert [r.split(",")[0] for r in _rows(part)] == ["1", "2", "3", "4"]
    assert _rows(part) == _rows(whole)
    assert ((part / "metrics_val_last.json").read_text()
            == (whole / "metrics_val_last.json").read_text())


def test_fit_reads_the_feed_from_the_config(tmp_path):
    """``fit`` wraps the loaders in resident feeds (chained for training)
    exactly when the config asks for it."""
    loaders = _loaders(_events(), presort_eta=True, presort_mode="cell")
    seen = []
    real = tres.ResidentFeed.__init__

    def recording(self, loader, chain=1, place=None, max_bytes=4 << 30,
                  **kw):
        seen.append(chain)
        real(self, loader, chain, place, max_bytes, **kw)

    with mock.patch.object(tres.ResidentFeed, "__init__", recording):
        _fit(tmp_path, "a", loaders, (64,), 3, True, epochs=1)
        _fit(tmp_path, "b", loaders, (64,), 3, False, epochs=1)
    assert seen == [3, 1]
    cfg = dataclasses.asdict(Config())["train"]
    assert cfg["chain_steps"] == 8 and cfg["resident_feed"] is True
