"""The port's chained train steps (deepmetv2_tpu_torch/train/chain.py)
against per-step dispatch and against the JAX package's, on the CPU.

On the CPU a chain runs its steps in a loop, so chained steps must equal
per-step dispatch bit for bit: losses, parameters, BatchNorm buffers and
AdamW moments and counts (as tests/test_chain.py holds the JAX package's
scan).  Against the JAX package's chained steps (``lax.scan``) from the
same parameters (``params_from_jax``): GraphMET's losses within
tests/test_torch_train.py's ``LOSS_RTOL``, the DRN's within
tests/test_torch_drn_train.py's ``RESUMED_LOSS_RTOL`` (the bound of its
multi-step comparison).  Sizes as in tests/test_chain.py: 4 events per
batch padded to the bucket of 64; the DRN's fused graph build takes N a
multiple of 128, so its batches are padded to 128.
"""

import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import DataConfig as JDataConfig
from deepmetv2_tpu.config import DRNConfig as JDRNConfig
from deepmetv2_tpu.config import GraphConfig as JGraphConfig
from deepmetv2_tpu.data import collate as j_collate
from deepmetv2_tpu.data.batching import EventBatch as JBatch
from deepmetv2_tpu.models import drn as jdrn
from deepmetv2_tpu.models.drn import drn_init
from deepmetv2_tpu.models.graph_met import graph_met_init
from deepmetv2_tpu.train import chain as jchain
from deepmetv2_tpu.train.step import init_train_state
from deepmetv2_tpu_torch.config import Config, DataConfig, DRNConfig
from deepmetv2_tpu_torch.config import GraphConfig, TrainConfig
from deepmetv2_tpu_torch.data import collate, fetch_dataloader, to_device
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.models.drn import DRN
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.train import chain as tchain
from deepmetv2_tpu_torch.train.loop import feed_line
from deepmetv2_tpu_torch.train.step import (make_drn_train_step,
                                            make_optimizer, make_train_step)
from tests.test_torch_drn_train import RESUMED_LOSS_RTOL
from tests.test_torch_train import LOSS_RTOL
from tests.torch_threads import few_torch_threads  # noqa: F401

HALO = 64     # the whole window at N = 64


def _batches(n, seed=0, n_max=64, bs=4, collate_fn=collate):
    """tests/test_chain.py's batches: ``n`` batches of ``bs`` synthetic
    events of 8 to n_max − 1 candidates padded to the bucket ``n_max``."""
    events = synthetic_events(n * bs, seed=seed, n_min=8, n_max=n_max - 1)
    return [collate_fn(events[i * bs:(i + 1) * bs], buckets=(n_max,))
            for i in range(n)]


def _mixed(collate_fn):
    """Batches of two buckets: 5 of 64, 2 of 128, 1 of 64."""
    return (_batches(5, n_max=64, collate_fn=collate_fn)
            + _batches(2, seed=9, n_max=128, collate_fn=collate_fn)
            + _batches(1, seed=11, n_max=64, collate_fn=collate_fn))


@pytest.mark.parametrize("k", [1, 3])
def test_chain_batches_match_jax(k):
    """Chains of the same lengths holding the same arrays as the JAX
    package's ``chain_batches`` on a dataset of two buckets; ``k = 1``
    passes the batches through."""
    ours = list(tchain.chain_batches(iter(_mixed(collate)), k))
    theirs = list(jchain.chain_batches(iter(_mixed(j_collate)), k))
    assert len(ours) == len(theirs) == (8 if k == 1 else 4)
    if k == 1:
        assert all(isinstance(b.x_cont, np.ndarray) and b.x_cont.ndim == 3
                   for b in ours)
    else:
        assert [tchain.chain_length(c) for c in ours] == [
            jchain.chain_length(c) for c in theirs] == [3, 2, 2, 1]
    for a, b in zip(ours, theirs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y))


def _state(model, opt):
    """Every parameter and BatchNorm buffer, then each parameter's AdamW
    moments and count."""
    out = [(str(p), t.detach().clone()) for p, t in model.jax_layout()]
    for path, t in model._param_paths():
        out += [(f"{path} {k}", opt.state[t][k].clone())
                for k in ("exp_avg", "exp_avg_sq", "step")]
    return out


def _assert_same_state(a, b):
    for (name, x), (_, y) in zip(a, b):
        assert torch.equal(x, y), name


def _graphmet_cfg():
    return Config(graph=GraphConfig(mode="window", window_halo=HALO),
                  data=DataConfig(batch_size=4, node_buckets=(64,)))


def _drn_cfg():
    return Config(data=DataConfig(batch_size=4, node_buckets=(128,)),
                  drn=DRNConfig(hidden_dim=16, k=4, head="cartesian",
                                output_scale=50.0))


def _run_per_step(model, opt, step, batches):
    return [step(model, opt, to_device(b, "cpu")) for b in batches]


def _run_chained(model, opt, runner, batches, k):
    out = []
    for stacked in tchain.chain_batches(iter(batches), k):
        losses = runner(model, opt, to_device(stacked, "cpu"))
        assert losses.shape == (tchain.chain_length(stacked),)
        out.extend(losses)
    return out


@pytest.mark.parametrize("family", ["graphmet", "drn"])
def test_chained_equals_per_step(family):
    """GraphMET: 7 batches in chains of 3, 3 and 1; the DRN: 5 batches in
    chains of 2, 2 and 1 (as tests/test_chain.py).  Losses, parameters,
    BatchNorm buffers and AdamW state bit for bit."""
    if family == "drn":
        cfg, n, k = _drn_cfg(), 5, 2
        batches = _batches(n, seed=5, n_max=128)

        def fresh():
            return DRN(cfg.drn, generator=torch.Generator().manual_seed(1))
        step = make_drn_train_step(cfg)
    else:
        cfg, n, k = _graphmet_cfg(), 7, 3
        batches = _batches(n, seed=3)

        def fresh():
            return GraphMET(cfg.model,
                            generator=torch.Generator().manual_seed(0))
        step = make_train_step(cfg)
    m1 = fresh()
    o1 = make_optimizer(cfg, m1)
    seq = _run_per_step(m1, o1, step, batches)
    m2 = fresh()
    o2 = make_optimizer(cfg, m2)
    runner = tchain.make_chained_train_step(cfg, family)
    ch = _run_chained(m2, o2, runner, batches, k)
    assert torch.equal(torch.stack(seq), torch.stack(ch))
    assert runner.n_graphs == runner.replays == 0       # no graphs on the CPU
    _assert_same_state(_state(m1, o1), _state(m2, o2))
    assert float(seq[-1]) != float(seq[0])


def test_graphmet_chained_matches_jax():
    """The port's chained GraphMET steps (chains of 3, 3 and 1) against the
    JAX package's scanned chains, from the same initial parameters, on
    cell-sorted batches in window mode: each loss within LOSS_RTOL."""
    events = synthetic_events(40, seed=13, n_min=8, n_max=63)
    ld = fetch_dataloader(events=events, batch_size=4, buckets=(64,),
                          presort_eta=True, presort_mode="cell")["train"]
    batches = list(ld)[:7]
    g = dict(mode="window", window_halo=HALO, presorted=True)
    jcfg = JConfig(graph=JGraphConfig(**g),
                   data=JDataConfig(batch_size=4, node_buckets=(64,)))
    tcfg = Config(graph=GraphConfig(**g),
                  data=DataConfig(batch_size=4, node_buckets=(64,)))
    params, bn_state = graph_met_init(jax.random.PRNGKey(0))
    model = GraphMET(tcfg.model).params_from_jax(params, bn_state)
    state = init_train_state(params, bn_state, jcfg)   # donated below
    jrun = jchain.make_chained_train_step(jcfg)
    jl = []
    for stacked in jchain.chain_batches(iter([JBatch(*b) for b in batches]),
                                        3):
        state, ls = jrun(state, stacked)
        jl.extend(np.asarray(ls).tolist())
    opt = make_optimizer(tcfg, model)
    tl = [float(x) for x in _run_chained(
        model, opt, tchain.make_chained_train_step(tcfg), batches, 3)]
    assert len(tl) == len(jl) == 7
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)


def test_drn_chained_matches_jax():
    """The port's chained DRN steps (chains of 2, 2 and 1) against the JAX
    package's scanned chains on its fused graph build and conv (the Pallas
    kernels in interpret mode), from the same initial parameters: each
    loss within RESUMED_LOSS_RTOL."""
    batches = _batches(5, seed=5, n_max=128)
    jcfg = JConfig(data=JDataConfig(batch_size=4, node_buckets=(128,)),
                   drn=JDRNConfig(hidden_dim=16, k=4, head="cartesian",
                                  output_scale=50.0))
    tcfg = _drn_cfg()
    params, bn_state = drn_init(jax.random.PRNGKey(1), jcfg.drn)
    model = DRN(tcfg.drn).params_from_jax(params, bn_state)
    state = init_train_state(params, bn_state, jcfg)   # donated below
    # the fused path in interpret mode, as tests/test_torch_drn_train.py
    # runs it: the step core binds drn_net_apply when it is made
    fused = functools.partial(jdrn.drn_net_apply, graph_interpret=True,
                              conv_force="fused", conv_interpret=True)
    with mock.patch.object(jdrn, "drn_net_apply", fused):
        jrun = jchain.make_chained_train_step(jcfg, model="drn",
                                              graph_force="fused")
    jl = []
    for stacked in jchain.chain_batches(iter([JBatch(*b) for b in batches]),
                                        2):
        state, ls = jrun(state, stacked)
        jl.extend(np.asarray(ls).tolist())
    opt = make_optimizer(tcfg, model)
    tl = [float(x) for x in _run_chained(
        model, opt, tchain.make_chained_train_step(tcfg, "drn"), batches, 2)]
    assert len(tl) == len(jl) == 5
    np.testing.assert_allclose(tl, jl, rtol=RESUMED_LOSS_RTOL)


def test_chained_step_refuses_a_mesh_and_unknown_family(monkeypatch):
    """Every mesh chain is ported (tests/test_torch_mesh.py,
    tests/test_torch_dyn.py): the node-sharded DRN's is the loop of its
    node-sharded step (parallel/dyn.py).  An unknown family is refused."""
    from deepmetv2_tpu_torch.parallel import dyn

    def step(model, optimizer, batch):
        return None

    monkeypatch.setattr(dyn, "make_drn_ep_train_step", lambda cfg, mesh: step)
    run = tchain.make_chained_train_step(_graphmet_cfg(), "drn",
                                         mesh=object(), shard_nodes=True)
    assert run.func is tchain._run_chain and run.args == (step,)
    with pytest.raises(ValueError, match="unknown model family"):
        tchain.make_chained_train_step(_graphmet_cfg(), "gnn")


def test_feed_line_names_the_feed():
    cfg = Config()          # the JAX package's defaults: chain 8, resident
    assert feed_line(cfg, "cuda") == "feed: resident, chain 8, CUDA graphs"
    assert feed_line(cfg, "cpu") == "feed: resident, chain 8, eager"
    per_step = Config(train=TrainConfig(chain_steps=1, resident_feed=False))
    assert feed_line(per_step, "cuda") == "feed: streaming, chain 1, eager"
