"""The port's window max (the plain PyTorch version of the CUDA kernel)
against JAX ``window_max_xla`` and the Pallas ``window_max`` in interpret
mode: exact equality on real rows, for eta-sorted, clustered (value ties,
pairs on the radius boundary), cell-sorted and padded batches.  The whole
``window_edgeconv_linear`` against JAX's at rtol/atol 1e-5."""

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
from deepmetv2_tpu_torch.data.synthetic import synthetic_events
from deepmetv2_tpu_torch.ops.cuda import edgeconv_window as tcu
from deepmetv2_tpu_torch.ops.edgeconv import edgeconv
from deepmetv2_tpu_torch.ops.window import WindowGraph, window_edgeconv_linear
from deepmetv2_tpu_torch.ops.window import window_max_torch

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
