"""The port's window max (the plain PyTorch version of the CUDA kernel)
against JAX ``window_max_xla`` and the Pallas ``window_max`` in interpret
mode: exact equality on real rows, for eta-sorted, clustered (value ties,
pairs on the radius boundary), cell-sorted and padded batches.  The whole
``window_edgeconv_linear`` against JAX's at rtol/atol 1e-5.

The backward: ``window_max_bwd_torch`` against the VJP of the Pallas
``window_max`` in interpret mode on the same cases, ties included (every
tied source gets the full gradient), equal up to the order of the sums
(rtol 1e-6, atol 1e-6 on gradients of O(1)); and the gradients of x, w and
b through the port's EdgeConv against those through
``window_edgeconv_linear_pallas`` at rtol 1e-5 and an atol of 2e-6 of the
largest entry (the gradients of w and b sum over every node, so their
rounding scales with their size)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.data import collate
from deepmetv2_tpu.data.sorting import (cell_sort_batch, required_halo,
                                        required_span_batch, sort_by_eta)
from deepmetv2_tpu.ops.pallas import edgeconv_window as jpal
from deepmetv2_tpu.ops.window import WindowGraph as JWindowGraph
from deepmetv2_tpu.ops.window import window_edgeconv_linear as j_wecl
from deepmetv2_tpu.ops.window import window_max_xla
from deepmetv2_tpu_torch.ops.window import window_max_bwd_torch
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.ops.cuda import edgeconv_window as tcu
from deepmetv2_tpu_torch.ops.edgeconv import edgeconv
from deepmetv2_tpu_torch.ops.window import WindowGraph, window_edgeconv_linear
from deepmetv2_tpu_torch.ops.window import window_max_torch
from tests.torch_threads import few_torch_threads  # noqa: F401

R2 = 0.4 ** 2


def _etaphi(batch):
    phi = np.arctan2(np.asarray(batch.x_cont[..., 1]),
                     np.asarray(batch.x_cont[..., 0]))
    return np.stack([np.asarray(batch.x_cont[..., 3]), phi], -1
                    ).astype(np.float32)


def _eta_sorted(seed):
    events = synthetic_events(3, seed=seed, n_min=120, n_max=250)
    batch, _ = sort_by_eta(collate(events, buckets=(256,)))
    return _etaphi(batch), np.array(batch.mask), required_halo(batch, 0.4)


def _clustered(seed):
    """Clusters at eta -2, 0, 2 on a 0.1 lattice (many pairs at exactly
    0.4 in decimal, a rounding question in f32), phi on the same lattice."""
    rng = np.random.default_rng(seed)
    B, N = 3, 256
    eta = np.sort(rng.choice([-2.0, 0.0, 2.0], size=(B, N))
                  + np.round(rng.normal(0, 0.2, (B, N)), 1), axis=1)
    phi = np.round(rng.uniform(-1.0, 1.0, (B, N)), 1)
    mask = np.arange(N)[None, :] < np.array([[256], [200], [9]])
    eta = np.where(mask, eta, 0.0)
    pos = np.stack([eta, np.where(mask, phi, 0.0)], -1).astype(np.float32)
    span = max(int(np.sum(np.abs(e[m][:, None] - e[m][None, :]) < 0.41, 1).max())
               for e, m in zip(eta, mask))
    return pos, mask, span


def _cell_sorted(seed):
    events = synthetic_events(3, seed=seed, n_min=120, n_max=250)
    batch = cell_sort_batch(collate(events, buckets=(256,)), r=0.4)
    return _etaphi(batch), np.array(batch.mask), required_span_batch(batch, 0.4)


def _padded(seed):
    rng = np.random.default_rng(seed)
    B, N = 3, 128
    eta = np.sort(rng.uniform(-3, 3, (B, N)), axis=1)
    phi = rng.uniform(-np.pi, np.pi, (B, N))
    mask = np.arange(N)[None, :] < np.array([[100], [0], [57]])
    return np.stack([eta, phi], -1).astype(np.float32), mask, 40


CASES = {"eta_sorted": _eta_sorted, "clustered_ties": _clustered,
         "cell_sorted": _cell_sorted, "padded": _padded}


@pytest.mark.parametrize("case", list(CASES))
def test_window_max_equals_jax_exactly(case):
    pos, mask, halo = CASES[case](seed=3)
    rng = np.random.default_rng(7)
    c = rng.normal(size=pos.shape[:2] + (8,)).astype(np.float32)
    if case == "clustered_ties":
        c = np.round(c, 1)                         # exact value ties

    got = window_max_torch(torch.as_tensor(c), torch.as_tensor(pos),
                           torch.as_tensor(mask), R2, halo).numpy()
    xla = np.asarray(window_max_xla(jnp.asarray(c), jnp.asarray(pos),
                                    jnp.asarray(mask), R2, halo))
    np.testing.assert_array_equal(got[mask], xla[mask])
    assert np.all(got[~mask] == -np.inf)

    pos_pad = np.where(mask[..., None], pos, jpal.PAD_POS).astype(np.float32)
    pallas = np.asarray(jpal.window_max(jnp.asarray(c), jnp.asarray(pos_pad),
                                        R2, halo, 128, True))
    np.testing.assert_array_equal(got[mask], pallas[mask])

    # the kernel's wrapper on a CPU tensor: the plain version with padded
    # rows placed at PAD_POS, equal on real rows
    wrapped = tcu.window_max(torch.as_tensor(c), torch.as_tensor(pos_pad),
                             R2, halo).numpy()
    np.testing.assert_array_equal(wrapped[mask], got[mask])


@pytest.mark.parametrize("case", list(CASES))
def test_window_edgeconv_linear_matches_jax(case):
    pos, mask, halo = CASES[case](seed=5)
    rng = np.random.default_rng(11)
    H = 8
    x = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    w = rng.normal(size=(2 * H, H)).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32)
    want = np.asarray(j_wecl(jnp.asarray(x),
                             JWindowGraph(jnp.asarray(pos), jnp.asarray(mask),
                                          r=0.4, halo=halo),
                             jnp.asarray(w), jnp.asarray(b)))
    g = WindowGraph(torch.as_tensor(pos), torch.as_tensor(mask), r=0.4,
                    halo=halo)
    args = (torch.as_tensor(x), g, torch.as_tensor(w), torch.as_tensor(b))
    got = window_edgeconv_linear(*args).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[~mask] == 0.0)
    # the CUDA wrapper's CPU path and the dispatcher give the same bits
    np.testing.assert_array_equal(tcu.window_edgeconv_linear_cuda(*args).numpy(),
                                  got)
    np.testing.assert_array_equal(edgeconv(*args).numpy(), got)


@pytest.mark.parametrize("case", list(CASES))
def test_window_max_bwd_matches_pallas_vjp(case):
    pos, mask, halo = CASES[case](seed=3)
    rng = np.random.default_rng(9)
    c = rng.normal(size=pos.shape[:2] + (8,)).astype(np.float32)
    if case == "clustered_ties":
        c = np.round(c, 1)                         # exact value ties
    g = rng.normal(size=c.shape).astype(np.float32)
    pos_pad = np.where(mask[..., None], pos, jpal.PAD_POS).astype(np.float32)

    _, vjp = jax.vjp(lambda cc: jpal.window_max(cc, jnp.asarray(pos_pad), R2,
                                                halo, 128, True),
                     jnp.asarray(c))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    ct, pt = torch.as_tensor(c), torch.as_tensor(pos_pad)
    m = tcu.window_max(ct, pt, R2, halo)
    got = window_max_bwd_torch(ct, pt, m, torch.as_tensor(g), R2, halo)
    # padded rows: the Pallas window reaches past ±halo, and padded rows
    # all sit at one coordinate, so only real rows are comparable
    np.testing.assert_allclose(got.numpy()[mask], want[mask], rtol=1e-6,
                               atol=1e-6)
    if case == "clustered_ties":   # ties took the full gradient, not a share
        tied = (c[..., None, :] == c[..., None, :, :]).sum(-2) > 1
        assert (tied & mask[..., None]).any()
    # the autograd function's backward on a CPU tensor is the same function
    cg = ct.clone().requires_grad_(True)
    tcu.WindowMax.apply(cg, pt, R2, halo).backward(torch.as_tensor(g))
    assert torch.equal(cg.grad, got)


@pytest.mark.parametrize("case", list(CASES))
def test_window_edgeconv_linear_grads_match_pallas(case):
    pos, mask, halo = CASES[case](seed=5)
    rng = np.random.default_rng(13)
    H = 8
    x = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    w = rng.normal(size=(2 * H, H)).astype(np.float32)
    b = rng.normal(size=(H,)).astype(np.float32)
    G = rng.normal(size=pos.shape[:2] + (H,)).astype(np.float32)
    jg = JWindowGraph(jnp.asarray(pos), jnp.asarray(mask), r=0.4, halo=halo)

    def jloss(xx, ww, bb):
        out = jpal.window_edgeconv_linear_pallas(xx, jg, ww, bb, tile=128,
                                                 interpret=True)
        return jnp.sum(out * jnp.asarray(G))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b))
    g = WindowGraph(torch.as_tensor(pos), torch.as_tensor(mask), r=0.4,
                    halo=halo)
    for fn in (window_edgeconv_linear, edgeconv):   # plain autograd, kernel path
        args = [torch.as_tensor(a).requires_grad_(True) for a in (x, w, b)]
        (fn(args[0], g, args[1], args[2]) * torch.as_tensor(G)).sum().backward()
        for a, ref in zip(args, want):
            ref = np.asarray(ref)
            np.testing.assert_allclose(a.grad.numpy(), ref, rtol=1e-5,
                                       atol=2e-6 * np.abs(ref).max())
        assert np.all(args[0].grad.numpy()[~mask] == 0.0)


def test_unported_paths_raise():
    x = torch.zeros(1, 4, 8)
    w = torch.zeros(16, 8)
    g = WindowGraph(torch.zeros(1, 4, 2), torch.ones(1, 4, dtype=torch.bool))
    with pytest.raises(NotImplementedError):
        edgeconv(x, object(), w, None)
    with pytest.raises(NotImplementedError):
        edgeconv(x, g, w, None, "sum")
    with pytest.raises(ValueError, match="unsupported device"):
        tcu.window_max(torch.zeros(1, 4, 8, device="meta"),
                       torch.zeros(1, 4, 2, device="meta"), R2, 2)
    meta = torch.zeros(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tcu.window_max_bwd(meta, torch.zeros(1, 4, 2, device="meta"), meta,
                           meta, R2, 2)
