"""The port's composed DRN path (ops/dyn_graph.py with ``force='composed'``,
the gather-reduce conv ``models/drn.py:_xla_edgeconv``) against the JAX
package's composed XLA path, the one its CPU run takes by default, on the
CPU.

Tolerances: graphs equal exactly on features whose squared distances are
exact (small integers); the conv's output and running statistics rtol
1e-5 (with atol 1e-5 of the largest output: f32 products and sums in other
orders), its gradients rtol 1e-4 with atol 1e-5 of the largest (train-mode
BatchNorm's mean subtraction cancels, which amplifies those orders); a
whole forward rtol 1e-4 (two rounds of the above, on
continuous features whose graphs are checked equal first); the mirror
gather's gradients within 1e-5 of the largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.config import DRNConfig as JDRNConfig
from deepmetv2_tpu.data.batching import Neighborhood as JNbr
from deepmetv2_tpu.models import drn as jdrn
from deepmetv2_tpu.nn.core import BatchNormState
from deepmetv2_tpu.ops import dyn_graph as jdg
from deepmetv2_tpu_torch.config import DRNConfig
from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.models import drn as tdrn
from deepmetv2_tpu_torch.ops import dyn_graph as tdg
from deepmetv2_tpu_torch.ops.segment import (gather_neighbors,
                                             gather_neighbors_mirror,
                                             mirror_slots_sorted)
from tests.torch_threads import few_torch_threads  # noqa: F401


def _int_features(B, N, H, seed):
    rng = np.random.default_rng(seed)
    h = rng.integers(-3, 4, (B, N, H)).astype(np.float32)
    mask = rng.random((B, N)) < 0.85
    return h, mask


@pytest.mark.parametrize("N,k,cap", [(100, 4, None), (128, 16, 256),
                                     (100, 16, 8)])
def test_composed_build_and_matching_match_jax(N, k, cap):
    h, mask = _int_features(2, N, 12, seed=N + k)
    jg = jdg.build_dyn_graph(jnp.asarray(h), jnp.asarray(mask), k=k,
                             cap=cap, force="composed", want_mirror=True)
    tg = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=k,
                             cap=cap, force="composed", want_mirror=True)
    assert tg.rel is None and tg.t is None
    for a, b in ((tg.nbr.idx, jg.nbr.idx), (tg.nbr.mask, jg.nbr.mask),
                 (tg.mirror, jg.mirror)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the matching on the composed graph: dense from the lists up to
    # DENSE_MATCH_MAX_N, as the JAX package takes it (post-conv features
    # stand-in: the same integers, exact distances)
    jc, jp = jdg.cut_matching(jg, jnp.asarray(h), jnp.asarray(mask))
    tc, tp = tdg.cut_matching(tg, torch.as_tensor(h), torch.as_tensor(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_auto_takes_composed_where_fused_does_not_apply():
    h, mask = _int_features(1, 100, 8, seed=1)
    auto = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=4)
    comp = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=4,
                               force="composed")
    assert torch.equal(auto.nbr.idx, comp.nbr.idx) and auto.t is None
    h2, mask2 = _int_features(1, 128, 8, seed=1)
    assert tdg.build_dyn_graph(torch.as_tensor(h2), torch.as_tensor(mask2),
                               k=4).t is not None                  # fused


def test_list_matching_above_the_dense_limit(monkeypatch):
    """Above DENSE_MATCH_MAX_N a composed graph matches on its lists, as
    JAX does."""
    h, mask = _int_features(2, 100, 8, seed=3)
    monkeypatch.setattr(tdg, "DENSE_MATCH_MAX_N", 64)
    monkeypatch.setattr(jdg, "DENSE_MATCH_MAX_N", 64)
    jg = jdg.build_dyn_graph(jnp.asarray(h), jnp.asarray(mask), k=4,
                             force="composed")
    tg = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=4,
                             force="composed")
    jc, jp = jdg.cut_matching(jg, jnp.asarray(h), jnp.asarray(mask))
    tc, tp = tdg.cut_matching(tg, torch.as_tensor(h), torch.as_tensor(mask))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def _conv_case(seed=7, B=2, N=40, H=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, H)).astype(np.float32)
    mask = rng.random((B, N)) < 0.85
    h, _ = _int_features(B, N, 6, seed)
    g = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=3,
                            force="composed")
    jparams, jstate = jdrn.drn_init(jax.random.PRNGKey(seed),
                                    JDRNConfig(hidden_dim=H, pool_rounds=1))
    st = jstate["convs"][0]
    st = BatchNormState(st.mean + 0.1, st.var * 1.5, st.count)
    model = tdrn.DRN(DRNConfig(hidden_dim=H, pool_rounds=1)).params_from_jax(
        jparams, {"convs": [st]})
    return x, g.nbr, jparams["convs"][0], st, model.convs[0]


@pytest.mark.parametrize("aggr", ["add", "max", "mean"])
@pytest.mark.parametrize("train", [False, True])
def test_xla_conv_forward_and_gradients_match_jax(aggr, train):
    x, nbr, jconv, jst, conv = _conv_case()
    jn = JNbr(jnp.asarray(nbr.idx.numpy()), jnp.asarray(nbr.mask.numpy()))
    ct = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)

    def jloss(params, x):
        out, new = jdrn._drn_edgeconv(params, jst, x, jn, aggr, train,
                                      conv_force="xla")
        return jnp.sum(out * ct), (out, new)

    (_, (jout, jnew)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jconv, jnp.asarray(x))
    if train:
        conv.train()
    tx = torch.tensor(x, requires_grad=True)
    out = tdrn._drn_edgeconv(conv, tx, nbr, aggr, train, force="xla")
    (out * torch.as_tensor(ct)).sum().backward()
    scale = float(np.abs(np.asarray(jout)).max())
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(conv.bn.running_mean.numpy(),
                               np.asarray(jnew.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(conv.bn.running_var.numpy(),
                               np.asarray(jnew.var), rtol=1e-5, atol=1e-6)
    pairs = [(tx.grad, jgx)] + [
        (getattr(conv.mlp.layers[i], n).grad, jgp["mlp"][f"lin{i}"][n])
        for i in range(2) for n in ("w", "b")] + [
        (conv.bn.gamma.grad, jgp["bn"]["gamma"]),
        (conv.bn.beta.grad, jgp["bn"]["beta"])]
    for got, want in pairs:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(want).max()))


def test_drn_apply_composed_matches_jax_cpu_default():
    """ckpts_syn_drn's weights on 4 events padded to 256: the port with
    ``graph_force='composed', conv_force='xla'`` against the JAX
    package's CPU default (its composed build and XLA conv)."""
    import chip_smoke
    from deepmetv2_tpu.data.batching import EventBatch as JBatch
    from tests.test_torch_drn import _jax_drn, _port_drn
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device

    params, bn_state, cfg = _jax_drn()
    host = collate(synthetic_events(4, seed=11, n_min=100, n_max=200),
                   pad_to=256)
    rounds = []
    match = jdg.cut_matching

    def recorded(g, h, mask, *a, **kw):
        c, p = match(g, h, mask, *a, **kw)
        rounds.append([np.asarray(v) for v in (mask, g.nbr.idx, g.nbr.mask,
                                               c, p)])
        return c, p

    jdg.cut_matching = recorded
    try:
        jpred, _ = jdrn.drn_net_apply(params, bn_state, JBatch(*host),
                                      cfg=cfg.drn)
    finally:
        jdg.cut_matching = match
    model = _port_drn(params, bn_state, cfg)
    diag = {}
    with torch.no_grad():
        tpred = tdrn.drn_net_apply(model, to_device(host, "cpu"), diag,
                                   graph_force="composed", conv_force="xla")
    got = chip_smoke.drn_graph_digests(
        [[t.numpy() for t in (m, n.idx, n.mask, c, p)]
         for m, n, c, p in diag["rounds"]])
    np.testing.assert_array_equal(got, chip_smoke.drn_graph_digests(rounds))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jpred).max()))


def test_mirror_gather_gives_the_same_gradients():
    """A train-mode loss through the composed build and the XLA conv, with
    ``mirror_gather`` off (the gather's scatter adjoint) and on (a gather
    through the mirror table): equal gradients within 1e-5 of the largest
    |gradient| (the train-mode BatchNorm's mean subtraction cancels, so a
    small tensor's sums, taken in other orders, differ by more than their
    own ulps: in f64 the two agree to 2e-12).  The forwards are equal."""
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device

    batch = to_device(collate(synthetic_events(3, seed=5, n_min=60,
                                               n_max=120), pad_to=128),
                      "cpu")
    grads, preds = [], []
    for mirror in (False, True):
        cfg = DRNConfig(hidden_dim=16, mirror_gather=mirror,
                        head="cartesian")
        model = tdrn.DRN(cfg, generator=torch.Generator().manual_seed(0))
        model.train()
        pred = tdrn.drn_net_apply(model, batch, graph_force="composed",
                                  conv_force="xla")
        (pred ** 2).sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        preds.append(pred.detach())
    assert torch.equal(preds[0], preds[1])
    top = max(float(a.abs().max()) for a in grads[0])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-5 * top


def test_mirror_gather_is_used_on_a_composed_graph():
    h, mask = _int_features(1, 50, 6, seed=2)
    g = tdg.build_dyn_graph(torch.as_tensor(h), torch.as_tensor(mask), k=3,
                            force="composed", want_mirror=True)
    mirror, found = mirror_slots_sorted(g.nbr)
    assert torch.equal(g.mirror, mirror) and torch.equal(found, g.nbr.mask)
    x = torch.randn(1, 50, 4, generator=torch.Generator().manual_seed(1))
    got = gather_neighbors_mirror(x, g.nbr, g.mirror)
    want = gather_neighbors(x, g.nbr)
    assert torch.equal(got, torch.where(g.nbr.mask[..., None], want,
                                        torch.zeros_like(want)))
