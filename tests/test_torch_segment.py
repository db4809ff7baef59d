"""The port's masked reductions and neighbour gathers (ops/segment.py)
against the JAX package's, forward and gradient, on the CPU.

Tolerance: forwards rtol 1e-6 (both sum in f32, in other orders; max and
min are exact), the scalar Σ out·ct that the gradients are taken of atol
1e-5 (a sum of O(1) terms of either sign), gradients rtol 1e-5, atol 1e-6
(against ``jax.grad``).  Values are small integers where ties matter, so ties are exact: a max's
gradient splits evenly among its tied entries in both packages.  The mirror
gather's backward sums each node's cotangents in slot order, the scatter
adjoint in another order: within f32 of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.ops import graph as jg
from deepmetv2_tpu.ops import segment as js
from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops import segment as ts
from tests.torch_threads import few_torch_threads  # noqa: F401

RTOL, SUM_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-6, 1e-5, 1e-5, 1e-6


def _inputs(B=2, N=30, H=5, seed=0, ties=True):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-3, 4, (B, N, H)) if ties
         else rng.normal(size=(B, N, H))).astype(np.float32)
    mask = rng.random((B, N)) < 0.7
    mask[1, :] = False                     # an empty event
    return x, mask


def _grad_pair(jfn, tfn, x, seed=1):
    """(JAX value, port value, JAX grad, port grad) of sum(out · ct)."""
    ct = np.random.default_rng(seed).normal(
        size=np.shape(jfn(jnp.asarray(x)))).astype(np.float32)
    jv, jgrad = jax.value_and_grad(
        lambda v: jnp.sum(jfn(v) * ct))(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tv = (tfn(tx) * torch.as_tensor(ct)).sum()
    tv.backward()
    return float(jv), float(tv.detach()), np.asarray(jgrad), tx.grad.numpy()


@pytest.mark.parametrize("name", ["masked_sum", "masked_mean", "masked_max",
                                  "masked_softmax"])
def test_masked_reductions_match_jax(name):
    x, mask = _inputs()
    axis = -1 if name == "masked_softmax" else 1
    m = mask if axis == 1 else np.random.default_rng(3).random(x.shape) < .6
    jf = lambda v: getattr(js, name)(v, jnp.asarray(m), axis=axis)  # noqa
    tf = lambda v: getattr(ts, name)(v, torch.as_tensor(m), axis=axis)  # noqa
    np.testing.assert_allclose(tf(torch.as_tensor(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))), rtol=RTOL,
                               atol=1e-7)
    jv, tv, jgr, tgr = _grad_pair(jf, tf, x)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=SUM_ATOL)
    np.testing.assert_allclose(tgr, jgr, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def _graph(x, mask, k=6):
    j = jg.radius_graph(jnp.asarray(x[..., :2]), jnp.asarray(mask), r=2.5,
                        k=k)
    return j, Neighborhood(torch.as_tensor(np.array(j.idx)),
                           torch.as_tensor(np.array(j.mask)))


@pytest.mark.parametrize("reduction", ["sum", "mean", "max", "min"])
def test_neighbor_reduce_and_its_gradient_match_jax(reduction):
    x, mask = _inputs(seed=2)
    jn, tn = _graph(x, mask)
    jf = lambda v: js.neighbor_reduce(v, jn, reduction)  # noqa: E731
    tf = lambda v: ts.neighbor_reduce(v, tn, reduction)  # noqa: E731
    np.testing.assert_allclose(tf(torch.as_tensor(x)).numpy(),
                               np.asarray(jf(jnp.asarray(x))), rtol=RTOL)
    jv, tv, jgr, tgr = _grad_pair(jf, tf, x)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=SUM_ATOL)
    np.testing.assert_allclose(tgr, jgr, rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_max_gradient_splits_ties_evenly():
    """Three equal maxima each take a third of the cotangent."""
    x = torch.tensor([[[1.0], [5.0], [5.0], [5.0]]], requires_grad=True)
    nbr = Neighborhood(torch.tensor([[[1, 2, 3, 0]] * 4], dtype=torch.int32),
                       torch.tensor([[[True, True, True, False]] * 4]))
    ts.neighbor_reduce(x, nbr, "max")[0, 0, 0].backward()
    np.testing.assert_allclose(x.grad[0, :, 0].numpy(),
                               [0.0, 1 / 3, 1 / 3, 1 / 3], rtol=1e-7)


def _symmetric(seed=4, B=2, N=40, k=4):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, N, 6)).astype(np.float32)
    mask = rng.random((B, N)) < 0.9
    j = jg.to_undirected(jg.knn_graph(jnp.asarray(h), jnp.asarray(mask), k=k))
    return j, Neighborhood(torch.as_tensor(np.array(j.idx)),
                           torch.as_tensor(np.array(j.mask)))


def test_mirror_slots_match_jax():
    jn, tn = _symmetric()
    jm, jf = js.mirror_slots(jn)
    tm, tf = ts.mirror_slots(tn)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert torch.equal(tf, tn.mask)         # a symmetric list
    sm, sf = ts.mirror_slots_sorted(tn)
    assert torch.equal(sf, tf) and torch.equal(sm[sf], tm[tf])
    # a one-sided edge has no mirror
    mask = tn.mask.clone()
    b, i, s = map(int, torch.nonzero(mask)[0])
    mask[b, int(tn.idx[b, i, s])] = False
    _, found = ts.mirror_slots(Neighborhood(tn.idx, mask))
    assert not found[b, i, s]


@pytest.mark.parametrize("H", [1, 7])
def test_gather_neighbors_mirror(H):
    """Forward equal to the masked gather; backward a gather through the
    mirror table, within f32 of the scatter adjoint and of JAX's custom
    VJP."""
    jn, tn = _symmetric(seed=5)
    mirror, _ = ts.mirror_slots_sorted(tn)
    rng = np.random.default_rng(6)
    v = rng.normal(size=tn.idx.shape[:2] + (H,)).astype(np.float32)
    ct = rng.normal(size=tn.idx.shape + (H,)).astype(np.float32)

    a = torch.tensor(v, requires_grad=True)
    out = ts.gather_neighbors_mirror(a, tn, mirror)
    (out * torch.as_tensor(ct)).sum().backward()
    b = torch.tensor(v, requires_grad=True)
    g = ts.gather_neighbors(b, tn)
    plain = torch.where(tn.mask[..., None], g, torch.zeros_like(g))
    (plain * torch.as_tensor(ct)).sum().backward()
    assert torch.equal(out, plain)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-5,
                               atol=1e-6)

    jm = jnp.asarray(mirror.numpy())
    jgrad = jax.grad(lambda x: jnp.sum(
        js.gather_neighbors_mirror(x, jn, jm) * ct))(jnp.asarray(v))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-6)
