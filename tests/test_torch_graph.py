"""The port's graph construction (ops/graph.py: radius_graph, knn_graph,
to_undirected) against the JAX package's and against the numpy oracles of
tests/oracles.py, on the CPU.

Tolerance: none.  Index sets, slot order and masks are equal.  Ties are
exercised on dyadic lattices (coordinates multiples of 1/8), whose squared
distances are exact in any summation order and with or without a fused
multiply-add, so equal distances are equal in both packages and only the
lower-index rule orders them.  Random points in (eta, phi) use the
difference form, where a pair is decided the same way unless it lies
within an ulp of the radius (none here); random knn features are small
integers, exact in the |a|² + |b|² − 2a·b form too.  to_undirected is
integer work and equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.data.batching import Neighborhood as JNbr
from deepmetv2_tpu.ops import graph as jg
from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops import graph as tg
from tests import oracles
from tests.torch_threads import few_torch_threads  # noqa: F401


def _points(B=3, N=200, seed=0, frac=0.85):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2, 2, (B, N, 2)).astype(np.float32)
    mask = rng.random((B, N)) < frac
    return pos, mask


def _lattice(side=12, step=0.125):
    """Two events on a side x side lattice; the second's last rows
    padded."""
    g = np.stack(np.meshgrid(np.arange(side), np.arange(side)), -1)
    g = (g.reshape(-1, 2) * step).astype(np.float32)
    pos = np.broadcast_to(g, (2,) + g.shape).copy()
    mask = np.ones(pos.shape[:2], bool)
    mask[1, 100:] = False
    return pos, mask


def _equal(j, t):
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    assert t.idx.dtype == torch.int32 and t.mask.dtype == torch.bool


def _radius(pos, mask, **kw):
    j = jg.radius_graph(jnp.asarray(pos), jnp.asarray(mask), **kw)
    t = tg.radius_graph(torch.as_tensor(pos), torch.as_tensor(mask), **kw)
    _equal(j, t)
    return t


def _against_oracle(t, pos, mask, r, k, loop, knn=False):
    """Each real row's valid slots, in order, are the oracle's nearest k
    (ascending d², then index) among the real nodes."""
    for b in range(pos.shape[0]):
        real = np.flatnonzero(mask[b])
        sub = pos[b][real]
        want = (oracles.knn_neighbors(sub, k, loop) if knn
                else oracles.radius_neighbors(sub, r, loop, max_k=k))
        for q, i in enumerate(real):
            got = t.idx[b, i][t.mask[b, i]].numpy()
            assert got.tolist() == real[want[q]].tolist(), (b, i)
        assert not t.mask[b][~mask[b]].any()


@pytest.mark.parametrize("kw", [dict(r=0.4, k=16), dict(r=0.6, k=256),
                                dict(r=0.4, k=8, loop=False)])
def test_radius_graph_random_points(kw):
    pos, mask = _points()
    t = _radius(pos, mask, **kw)
    _against_oracle(t, pos, mask, kw["r"], kw["k"], kw.get("loop", True))


@pytest.mark.parametrize("kw", [dict(r=0.3, k=8), dict(r=0.3, k=8,
                                                       loop=False),
                                dict(r=0.4, k=30), dict(r=0.3, k=400)])
def test_radius_graph_lattice_ties(kw):
    """Degree above k with many equal distances: the lower index first."""
    pos, mask = _lattice()
    t = _radius(pos, mask, **kw)
    if kw["k"] <= 30:
        assert int(t.mask.sum(-1).max()) == kw["k"]
    _against_oracle(t, pos, mask, kw["r"], kw["k"], kw.get("loop", True))


def test_radius_graph_wraps_phi():
    pos, mask = _points(seed=1)
    pos[..., 1] = np.float32(np.pi) * pos[..., 1] / 2   # phi in [-pi, pi)
    t = _radius(pos, mask, r=0.5, k=32, wrap_axes=(0.0, 2 * np.pi))
    plain = tg.radius_graph(torch.as_tensor(pos), torch.as_tensor(mask),
                            r=0.5, k=32)
    assert int(t.mask.sum()) > int(plain.mask.sum())   # pairs across ±pi


def test_tile_does_not_change_the_graph():
    pos, mask = _points(B=2, N=300, seed=2)
    a = tg.radius_graph(torch.as_tensor(pos), torch.as_tensor(mask), r=0.5,
                        k=32, tile=64)
    b = tg.radius_graph(torch.as_tensor(pos), torch.as_tensor(mask), r=0.5,
                        k=32, tile=512)
    assert torch.equal(a.idx, b.idx) and torch.equal(a.mask, b.mask)
    _radius(pos, mask, r=0.5, k=32, tile=64)


def test_padded_rows_and_empty_event():
    pos, mask = _points(B=3, N=64, seed=4)
    mask[1] = False
    mask[2, 3:] = False
    t = _radius(pos, mask, r=3.0, k=16)
    assert not t.mask[1].any() and int(t.mask[2].sum()) == 9
    assert not t.idx[~t.mask].any()


@pytest.mark.parametrize("k,loop", [(4, False), (16, False), (5, True),
                                    (300, False)])
def test_knn_graph_matches_jax_and_oracle(k, loop):
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, (3, 200, 16)).astype(np.float32)
    mask = rng.random((3, 200)) < 0.85
    j = jg.knn_graph(jnp.asarray(x), jnp.asarray(mask), k=k, loop=loop)
    t = tg.knn_graph(torch.as_tensor(x), torch.as_tensor(mask), k=k,
                     loop=loop)
    _equal(j, t)
    _against_oracle(t, x, mask, None, k, loop, knn=True)


def _to_undirected_both(idx, mask, cap):
    j = jg.to_undirected(JNbr(jnp.asarray(idx), jnp.asarray(mask)), cap=cap)
    t = tg.to_undirected(Neighborhood(torch.as_tensor(idx),
                                      torch.as_tensor(mask)), cap=cap)
    _equal(j, t)
    return t


@pytest.mark.parametrize("cap", [None, 8, 20])
def test_to_undirected_bitwise(cap):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 150, 8)).astype(np.float32)
    mask = rng.random((3, 150)) < 0.9
    nbr = jg.knn_graph(jnp.asarray(x), jnp.asarray(mask), k=6)
    t = _to_undirected_both(np.array(nbr.idx), np.array(nbr.mask), cap)
    # symmetric: j in i's list exactly when i in j's
    B, N, _ = t.idx.shape
    U = np.zeros((B, N, N), bool)
    for b, i, s in zip(*np.nonzero(t.mask.numpy())):
        U[b, i, t.idx[b, i, s]] = True
    assert (U == U.transpose(0, 2, 1)).all()


def test_to_undirected_hub_drops_mutually():
    """Node 0 listed by every node: past the cap its highest-indexed
    neighbours go, from both ends."""
    N, K = 40, 3
    idx = np.zeros((1, N, K), np.int32)
    idx[0, :, 1] = (np.arange(N) + 1) % N
    idx[0, :, 2] = (np.arange(N) + 2) % N
    mask = np.ones((1, N, K), bool)
    mask[0, 0, 0] = False
    t = _to_undirected_both(idx, mask, 6)
    hub = t.idx[0, 0][t.mask[0, 0]].tolist()
    assert len(hub) == 6 and hub == sorted(hub)
    dropped = [i for i in range(3, N - 2) if 0 not in
               t.idx[0, i][t.mask[0, i]].tolist()]
    assert dropped and all(i not in hub for i in dropped)
