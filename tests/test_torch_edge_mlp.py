"""The port's fused DRN edge-MLP conv (ops/edge_mlp.py, the plain version
of the csrc/edge_mlp.cu kernel, with the BatchNorm combine around it)
against the JAX package's ``edge_mlp_conv`` with its Pallas kernel in
interpret mode.

Tolerance rtol 1e-5 plus 2e-6 of the largest |value| (the form
chip_smoke.py holds the kernel to): the same f32 arithmetic with the GEMMs
and the sums over slots and edges taken in other orders, and a row's sum
of messages cancels, so its error scales with the messages, not with the
row's value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.ops.pallas.edge_mlp import edge_mlp_conv as j_conv
from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops import edge_mlp as te
from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_conv as t_conv
from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_fwd
from deepmetv2_tpu_torch.ops.segment import gather_neighbors
from tests.torch_threads import few_torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 2e-6


def _close(actual, desired):
    np.testing.assert_allclose(actual, desired, rtol=RTOL,
                               atol=ATOL * float(np.abs(desired).max()))


def _setup(B=2, N=32, K=8, H=16, seed=0):
    """Inputs with masked slots, one empty row per event, a negative gamma
    channel (the max aggregation's min branch) and non-trivial running
    statistics, as numpy."""
    rng = np.random.default_rng(seed)
    F1 = 3 * H // 2
    x = rng.normal(size=(B, N, H)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, N, K)).astype(np.int32)
    mask = (rng.random((B, N, K)) < 0.7) & (idx != np.arange(N)[None, :, None])
    mask[:, 3] = False
    idx = np.where(mask, idx, 0).astype(np.int32)

    def lin(i, o):
        s = 1.0 / np.sqrt(i)
        return {"w": rng.uniform(-s, s, (i, o)).astype(np.float32),
                "b": rng.uniform(-s, s, (o,)).astype(np.float32)}

    mlp = {"lin0": lin(2 * H, F1), "lin1": lin(F1, H)}
    gamma = (1.0 + 0.3 * rng.normal(size=H)).astype(np.float32)
    gamma[0] = -0.7
    beta = (0.1 + 0.1 * rng.normal(size=H)).astype(np.float32)
    mean = (0.05 * rng.normal(size=H)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, size=H).astype(np.float32)
    return x, idx, mask, mlp, gamma, beta, mean, var


def _run(args, train, aggr):
    x, idx, mask, mlp, gamma, beta, mean, var = args
    nbr = Neighborhood(torch.as_tensor(idx), torch.as_tensor(mask))
    xt = torch.as_tensor(x)
    jout = j_conv(jnp.asarray(x),
                  jnp.asarray(gather_neighbors(xt, nbr).numpy()),
                  jnp.asarray(mask),
                  {k: {n: jnp.asarray(v) for n, v in d.items()}
                   for k, d in mlp.items()},
                  jnp.asarray(gamma), jnp.asarray(beta), jnp.asarray(mean),
                  jnp.asarray(var), train, aggr, interpret=True)
    tmlp = {k: {n: torch.as_tensor(v) for n, v in d.items()}
            for k, d in mlp.items()}
    tout = t_conv(xt, nbr, tmlp, torch.as_tensor(gamma),
                  torch.as_tensor(beta), torch.as_tensor(mean),
                  torch.as_tensor(var), train, aggr)
    return [np.asarray(v) for v in jout], [v.numpy() for v in tout]


@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
@pytest.mark.parametrize("train", [False, True])
def test_edge_mlp_conv_matches_jax(aggr, train):
    (jo, jm, jv), (to, tm, tv) = _run(_setup(), train, aggr)
    _close(to, jo)
    _close(tm, jm)
    _close(tv, jv)
    assert np.all(to[:, 3] == 0.0)          # empty rows give exactly 0


@pytest.mark.parametrize("aggr", ["add", "max"])
def test_edge_mlp_conv_drn_widths(aggr):
    """The DRN's own widths: H=64, F1=96, K=32, at N=128."""
    (jo, _, _), (to, _, _) = _run(_setup(B=2, N=128, K=32, H=64, seed=4),
                                  False, aggr)
    _close(to, jo)


def test_edge_pass_outputs():
    """The plain edge pass against a message-by-message loop: sums, max
    and min with ±inf on empty rows, and the statistics over valid edges
    only."""
    x, idx, mask, mlp, *_ = _setup(B=1, N=16, K=4, H=8, seed=2)
    H = x.shape[-1]
    w0, b0 = mlp["lin0"]["w"], mlp["lin0"]["b"]
    w1, b1 = mlp["lin1"]["w"], mlp["lin1"]["b"]
    a = x[0] @ (w0[:H] - w0[H:]) + b0
    nbr = Neighborhood(torch.as_tensor(idx), torch.as_tensor(mask))
    t = lambda v: torch.as_tensor(v)  # noqa: E731
    s, none, stats = edge_mlp_fwd(t(a[None]), t(x), nbr, t(w0[H:]), t(w1),
                                  t(b1), "add")
    mx, mn, _ = edge_mlp_fwd(t(a[None]), t(x), nbr, t(w0[H:]), t(w1), t(b1),
                             "max")
    assert none is None

    def elu(z):
        return np.where(z > 0, z, np.exp(np.minimum(z, 0)) - 1)

    msgs = {}
    for i in range(16):
        for k in range(4):
            if mask[0, i, k]:
                z0 = x[0, idx[0, i, k]].astype(np.float64) @ w0[H:] + a[i]
                msgs.setdefault(i, []).append(elu(elu(z0) @ w1 + b1))
    allm = np.concatenate([np.stack(v) for v in msgs.values()])
    np.testing.assert_allclose(stats[0].numpy(), allm.sum(0), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(stats[1].numpy(), (allm ** 2).sum(0),
                               rtol=1e-5, atol=1e-5)
    for i in range(16):
        if i in msgs:
            m = np.stack(msgs[i])
            np.testing.assert_allclose(s[0, i].numpy(), m.sum(0), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(mx[0, i].numpy(), m.max(0), rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(mn[0, i].numpy(), m.min(0), rtol=1e-5,
                                       atol=1e-5)
        else:
            assert np.all(s[0, i].numpy() == 0)
            assert np.all(mx[0, i].numpy() == -np.inf)
            assert np.all(mn[0, i].numpy() == np.inf)


def test_supported_shapes():
    """The kernel's own limits: any node count, widths up to MAX_DIM, at
    least one slot."""
    assert te.supported(32, 64, 96, 64)
    assert te.supported(32, 60, 90, 100)              # no multiple of 8
    assert te.supported(1, 128, 128, 128)
    assert not te.supported(0, 64, 96, 64)            # no slot
    assert not te.supported(32, 64, 256, 64)          # wider than the kernel
