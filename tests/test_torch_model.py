"""The port's GraphMET against the JAX package's: weights carried from the
committed checkpoint and from a fresh JAX init, same batch, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import GraphConfig as JGraphConfig
from deepmetv2_tpu.data import collate
from deepmetv2_tpu.models.graph_met import graph_met_init as j_init
from deepmetv2_tpu.models.graph_met import net_apply as j_net
from deepmetv2_tpu.models.graph_met import pdg_remap as j_pdg
from deepmetv2_tpu.train.step import build_graph as j_build
from deepmetv2_tpu.utils import artifacts as j_artifacts
from deepmetv2_tpu_torch.config import Config, GraphConfig, ModelConfig
from deepmetv2_tpu_torch.data.batching import to_device
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.models.graph_met import GraphMET, net_apply
from deepmetv2_tpu_torch.ops.cat_embed import pdg_remap
from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint
from deepmetv2_tpu_torch.train.step import build_graph
from tests.torch_threads import few_torch_threads  # noqa: F401

CKPT = "ckpts_syn/best.ckpt"


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def batch():
    events = synthetic_events(4, seed=8, n_min=60, n_max=250)
    return collate(events, buckets=(256,), pad_events_to=5)


def _forward_both(params, bn_state, batch, train=False):
    jcfg = JConfig(graph=JGraphConfig(mode="window", window_halo=128))
    jb, jg = j_build(batch, jcfg)
    jw, jstate = j_net(params, bn_state, jb, jg, train=train)
    model = GraphMET(ModelConfig()).params_from_jax(params, bn_state)
    model.train(train)
    cfg = Config(graph=GraphConfig(mode="window", window_halo=128))
    tb, tg = build_graph(to_device(batch, "cpu"), cfg)
    with torch.no_grad():
        tw = net_apply(model, tb, tg)
    return np.asarray(jw), jstate, tw.numpy(), model


def test_checkpoint_reader_and_params_from_jax():
    want = j_artifacts.load(CKPT)
    got = load_checkpoint(CKPT)
    assert got["epoch"] == want["epoch"] and got["step"] == want["step"]
    assert got["sched_state"] == want["sched_state"]
    model = GraphMET().params_from_jax(got["params"], got["bn_state"])
    n = 0
    for path, t in model.jax_layout():
        ref = _leaf(want[path[0]], path[1:])
        np.testing.assert_array_equal(t.detach().numpy(), ref)
        n += 1
    assert n == 3 + 3 * 2 + 2 * 2 + 2 * 2 + 3 * 5   # every leaf carried
    # the optimizer state reads without optax, field names intact
    assert set(got["opt_state"].hyperparams) == set(
        want["opt_state"].hyperparams)
    np.testing.assert_array_equal(got["opt_state"].inner_state[0].mu["encode_all"]["w"],
                                  want["opt_state"].inner_state[0].mu["encode_all"]["w"])


def test_net_apply_matches_jax_from_checkpoint(batch):
    p = j_artifacts.load(CKPT)
    jw, _, tw, _ = _forward_both(p["params"], p["bn_state"], batch)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5)
    assert np.all(tw[~batch.mask] == 0.0)


@pytest.mark.parametrize("train", [False, True])
def test_net_apply_matches_jax_from_fresh_init(batch, train):
    params, bn_state = j_init(jax.random.PRNGKey(3))
    jw, jstate, tw, model = _forward_both(params, bn_state, batch, train)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5)
    if train:   # batch statistics and the running buffers they update
        for d, conv in enumerate(model.convs):
            np.testing.assert_allclose(conv.bn.running_mean.numpy(),
                                       np.asarray(jstate["convs"][d].mean),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(conv.bn.running_var.numpy(),
                                       np.asarray(jstate["convs"][d].var),
                                       rtol=1e-5, atol=1e-5)


def test_pdg_remap_and_clips_match_jax():
    pdg = np.array([[1, -2, 11, -13, 22, 130, -211, 0, 5, 999]], np.int32)
    np.testing.assert_array_equal(pdg_remap(torch.as_tensor(pdg),
                                            ModelConfig.pdgs).numpy(),
                                  np.asarray(j_pdg(jnp.asarray(pdg))))


def test_own_init_is_seeded_and_bf16_raises():
    """The seeded init; a bf16 GraphMET builds with the same float32
    parameters (only its EdgeConvs compute in bf16); a compute_dtype other
    than float32 or bfloat16 raises."""
    a = GraphMET(generator=torch.Generator().manual_seed(1))
    b = GraphMET(generator=torch.Generator().manual_seed(1))
    bf = GraphMET(ModelConfig(compute_dtype="bfloat16"),
                  generator=torch.Generator().manual_seed(1))
    for (pa, ta), (_, tb), (_, tc) in zip(a.jax_layout(), b.jax_layout(),
                                          bf.jax_layout()):
        assert torch.equal(ta, tb) and torch.equal(ta, tc), pa
    assert all(p.dtype == torch.float32 for p in bf.parameters())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        GraphMET(ModelConfig(compute_dtype="float16"))
