"""The port's EdgeConv over neighbour lists (ops/edgeconv.py:
edgeconv_linear, edgeconv_mlp, and the dispatch of ``edgeconv``) against
the JAX package's, forward and gradient, on the CPU.

Tolerance: rtol 1e-5, atol 1e-6.  Both packages compute in f32; their
matrix products and sums take other orders, a few ulps of O(1) values.
Gradients are of Σ out·ct, with respect to x, the weight and the bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.ops import edgeconv as je
from deepmetv2_tpu.ops import graph as jg
from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops import edgeconv as te
from tests import oracles
from tests.torch_threads import few_torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _case(B=2, N=48, H=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, H)).astype(np.float32)
    mask = rng.random((B, N)) < 0.8
    mask[1, 5:] = False                  # a small event
    w = (rng.normal(size=(2 * H, H)) / np.sqrt(2 * H)).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32)
    # r 0.6 on points in [-2, 2]²: some real nodes have no other node near;
    # without self-loops their lists are empty
    pos = rng.uniform(-2, 2, (B, N, 2)).astype(np.float32)
    j = jg.radius_graph(jnp.asarray(pos), jnp.asarray(mask), r=0.6, k=8,
                        loop=False)
    t = Neighborhood(torch.as_tensor(np.array(j.idx)),
                     torch.as_tensor(np.array(j.mask)))
    assert (~t.mask.any(-1) & torch.as_tensor(mask)).any()
    return x, w, b, j, t


@pytest.mark.parametrize("reduction", ["max", "mean", "sum"])
def test_edgeconv_linear_matches_jax(reduction):
    x, w, b, jn, tn = _case()
    ct = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)

    def jf(x, w, b):
        return jnp.sum(je.edgeconv(x, jn, w, b, reduction) * ct)

    jv, jgr = jax.value_and_grad(jf, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
    out = te.edgeconv(tx, tn, tw, tb, reduction)
    (out * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(je.edgeconv(jnp.asarray(x), jn, jnp.asarray(w),
                               jnp.asarray(b), reduction)),
        rtol=RTOL, atol=ATOL)
    empty = ~tn.mask.any(-1)
    assert not out.detach()[empty].any()       # an empty list gives 0
    for got, want in zip((tx, tw, tb), jgr):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL * max(
                                       1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("reduction", ["max", "mean", "sum"])
def test_edgeconv_mlp_matches_jax_and_oracle(reduction):
    """A two-layer edge MLP over query tiles; N a multiple of the tile (the
    JAX package's tiles clamp the last start otherwise)."""
    x, w, b, jn, tn = _case(N=64, seed=2)
    H = x.shape[-1]
    rng = np.random.default_rng(3)
    w1 = rng.normal(size=(2 * H, 5)).astype(np.float32)
    w2 = rng.normal(size=(5, 4)).astype(np.float32)

    def jmlp(e):
        return jnp.tanh(e @ w1) @ w2

    def tmlp(e):
        return torch.tanh(e @ torch.as_tensor(w1)) @ torch.as_tensor(w2)

    want = np.asarray(je.edgeconv_mlp(jnp.asarray(x), jn, jmlp, reduction,
                                      tile=16))
    for tile in (16, 256):
        got = te.edgeconv_mlp(torch.as_tensor(x), tn, tmlp, reduction,
                              tile=tile).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ev = 0
    lists = [tn.idx[ev, i][tn.mask[ev, i]].tolist() for i in range(64)]
    ref = oracles.edgeconv(x[ev].astype(np.float64), lists, None, None,
                           reduction, mlp=lambda e: np.tanh(e @ w1) @ w2)
    np.testing.assert_allclose(got[ev], ref, rtol=1e-4, atol=1e-5)


def test_linear_equals_mlp_path():
    x, w, b, _, tn = _case(seed=4)
    fast = te.edgeconv_linear(torch.as_tensor(x), tn, torch.as_tensor(w),
                              torch.as_tensor(b), "max")
    slow = te.edgeconv_mlp(torch.as_tensor(x), tn,
                           lambda e: e @ torch.as_tensor(w)
                           + torch.as_tensor(b), "max")
    np.testing.assert_allclose(fast.numpy(), slow.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_edgeconv_mlp_tile_does_not_change_rows():
    """N not a multiple of the tile: the last tile is the rows left, each
    row's output the same under any tile (the JAX package's last tile
    clamps its start instead, which moves rows 256.. at N=300, tile 256;
    ROADMAP C)."""
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.normal(size=(1, 300, 4)).astype(np.float32))
    j = jg.knn_graph(jnp.asarray(x.numpy()), jnp.ones((1, 300), bool), k=4)
    nbr = Neighborhood(torch.as_tensor(np.array(j.idx)),
                       torch.as_tensor(np.array(j.mask)))
    w = torch.as_tensor(rng.normal(size=(8, 3)).astype(np.float32))
    a = te.edgeconv_mlp(x, nbr, lambda e: e @ w, "max", tile=256)
    b = te.edgeconv_mlp(x, nbr, lambda e: e @ w, "max", tile=300)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=ATOL)
