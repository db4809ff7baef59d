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
    """The kernel's own limits: any node count, widths up to MAX_DIM, from
    one slot up to MAX_DIM slots (a node's slots fit one edge tile)."""
    assert te.supported(32, 64, 96, 64)
    assert te.supported(32, 60, 90, 100)              # no multiple of 8
    assert te.supported(1, 128, 128, 128)
    assert not te.supported(0, 64, 96, 64)            # no slot
    assert not te.supported(32, 64, 256, 64)          # wider than the kernel
    assert te.supported(128, 64, 96, 64)
    assert not te.supported(129, 64, 96, 64)          # more slots than a tile


# ------------------------------------------------------------ the backward


def _grads(args, train, aggr, nbr_t=None):
    """Gradients of x, the MLP's four tensors, gamma and beta of
    ``Σ out·G + Σ mean·Gm + Σ var·Gv`` (random cotangents; the statistics
    terms reach the kernel's stats cotangent in train mode) through JAX's
    ``edge_mlp_conv`` VJP (Pallas in interpret mode, the gather's adjoint
    by XLA) and through the port's ``edge_mlp_conv`` (``EdgeMLP`` with the
    plain backward), as two lists of numpy arrays."""
    import jax

    x, idx, mask, mlp, gamma, beta, mean, var = args
    B, N, H = x.shape
    rng = np.random.default_rng(7)
    G = rng.normal(size=(B, N, H)).astype(np.float32)
    Gm, Gv = rng.normal(size=(2, H)).astype(np.float32)
    from deepmetv2_tpu.data.batching import Neighborhood as JNbr
    from deepmetv2_tpu.ops.segment import gather_neighbors as j_gather

    jn = JNbr(jnp.asarray(idx), jnp.asarray(mask))

    def jloss(xx, m, g, b):
        out, mu, v = j_conv(xx, j_gather(xx, jn), jn.mask, m, g, b,
                            jnp.asarray(mean), jnp.asarray(var), train, aggr,
                            interpret=True)
        return (jnp.sum(out * G) + jnp.sum(mu * Gm) * train
                + jnp.sum(v * Gv) * train)

    jmlp = {k: {n: jnp.asarray(v) for n, v in d.items()}
            for k, d in mlp.items()}
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jmlp, jnp.asarray(gamma), jnp.asarray(beta))
    want = [jg[0]] + [jg[1][k][n] for k in ("lin0", "lin1")
                      for n in ("w", "b")] + [jg[2], jg[3]]

    nbr = nbr_t or Neighborhood(torch.as_tensor(idx), torch.as_tensor(mask))
    leaves = [torch.as_tensor(v).requires_grad_(True)
              for v in [x] + [mlp[k][n] for k in ("lin0", "lin1")
                              for n in ("w", "b")] + [gamma, beta]]
    tx, w0, b0, w1, b1, tg, tb = leaves
    out, mu, v = t_conv(tx, nbr, {"lin0": {"w": w0, "b": b0},
                                  "lin1": {"w": w1, "b": b1}},
                        tg, tb, torch.as_tensor(mean), torch.as_tensor(var),
                        train, aggr)
    loss = ((out * torch.as_tensor(G)).sum()
            + (mu * torch.as_tensor(Gm)).sum() * train
            + (v * torch.as_tensor(Gv)).sum() * train)
    loss.backward()
    return [np.asarray(w) for w in want], [t.grad.numpy() for t in leaves]


NAMES = ("x", "W0", "b0", "W1", "b1", "gamma", "beta")
# Gradients: rtol 1e-4 plus 2e-5 of the largest |gradient| of the tensor.
# In train mode the statistics' cotangent reaches every edge as
# gst0 + 2h·gst1, and the biases' gradients sum those terms over all edges
# with cancellation to about 1e-3 of their size, so the two packages'
# summation orders show there at about 1e-5 of the result (measured up to
# 1.3e-5 for b1); elsewhere they agree within 1e-6.
GRAD_RTOL, GRAD_ATOL = 1e-4, 2e-5


def _close_grads(want, got):
    for name, w, g in zip(NAMES, want, got):
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * float(np.abs(w).max()),
                                   err_msg=name)


@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
@pytest.mark.parametrize("train", [False, True])
def test_edge_mlp_grads_match_jax(aggr, train):
    """Random lists (duplicate targets in a row, an empty row per event,
    a target listed by many rows), eval and train BatchNorm."""
    _close_grads(*_grads(_setup(seed=5), train, aggr))


@pytest.mark.parametrize("aggr", ["add", "max"])
def test_edge_mlp_grads_ties_match_jax(aggr):
    """Lattice features: many slots of a row carry the same message, so
    the max and min tie and their cotangent is split evenly."""
    x, idx, mask, mlp, gamma, beta, mean, var = _setup(B=2, N=32, K=12,
                                                       H=8, seed=6)
    rng = np.random.default_rng(6)
    x = rng.integers(-1, 2, size=x.shape).astype(np.float32)
    x[:, ::2] = x[:, :1]                 # half the rows are one row
    args = (x, idx, mask, mlp, gamma, beta, mean, var)
    # rows whose valid slots reach two copies of the shared row: their
    # messages are equal, so the max and min tie there
    even = (idx % 2 == 0) & mask
    assert int((even.sum(-1) >= 2).sum()) > 10
    _close_grads(*_grads(args, True, aggr))


def test_edge_mlp_grads_knn_hub_match_jax():
    """A fused kNN list with a hub past the cap, so the list is not
    symmetric: x's gradient needs the list's real transpose."""
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph

    x, _, _, mlp, gamma, beta, mean, var = _setup(B=2, N=128, K=8, H=8,
                                                  seed=8)
    x[:, :60] *= 0.05                    # a dense core around row 0
    x[:, 0] = 0.0
    nbr, _, _ = knn_und_graph(torch.as_tensor(x),
                               torch.ones(2, 128, dtype=torch.bool),
                               k=4, cap=8)
    idx, mask = nbr.idx.numpy(), nbr.mask.numpy()
    back = {(b, int(j), i) for b in range(2) for i in range(128)
            for j in idx[b, i][mask[b, i]]}
    one_sided = sum((b, i, int(j)) not in back for b in range(2)
                    for i in range(128) for j in idx[b, i][mask[b, i]])
    assert one_sided > 0
    args = (x, idx, mask, mlp, gamma, beta, mean, var)
    for aggr in ("add", "max"):
        _close_grads(*_grads(args, True, aggr, nbr))


def test_slot_sum_and_mirror():
    """The gather's adjoint through the reverse index (each target's slots
    in ascending order) against a loop, and on a symmetric list against
    the gather through its mirror table (JAX's _gather_mirror_bwd)."""
    from deepmetv2_tpu_torch.ops.segment import (batched_take,
                                                 mirror_slots_sorted)

    rng = np.random.default_rng(9)
    B, N, K, H = 2, 24, 6, 5
    idx = torch.as_tensor(rng.integers(0, N, (B, N, K)), dtype=torch.int32)
    mask = torch.as_tensor(rng.random((B, N, K)) < 0.6)
    dxj = torch.as_tensor(rng.normal(size=(B, N, K, H)), dtype=torch.float32)
    want = torch.zeros(B, N, H)
    for b in range(B):
        for i in range(N):
            for k in range(K):
                if mask[b, i, k]:
                    want[b, idx[b, i, k]] += dxj[b, i, k]
    nbr = Neighborhood(idx, mask)
    np.testing.assert_allclose(te.slot_sum_torch(dxj, nbr).numpy(),
                               want.numpy(), rtol=1e-6, atol=1e-6)
    order, off = te.reverse_slots(nbr)
    for b in range(B):
        for j in range(N):
            slots = order[b, off[b, j]:off[b, j + 1]].tolist()
            assert slots == sorted(slots)
            assert all(int(idx[b, s // K, s % K]) == j
                       and bool(mask[b, s // K, s % K]) for s in slots)
    assert int(off[0, -1]) == int(mask[0].sum())
    # a symmetric list: each row's sum is the gather of its own slots'
    # mirror rows
    sym_idx = torch.zeros(B, N, 2, dtype=torch.int32)
    sym_idx[:, :, 0] = (torch.arange(N) + 1) % N
    sym_idx[:, :, 1] = (torch.arange(N) - 1) % N
    sym = Neighborhood(sym_idx, torch.ones(B, N, 2, dtype=torch.bool))
    mirror, found = mirror_slots_sorted(sym)
    assert bool(found.all())
    d2 = dxj[:, :, :2].contiguous()
    flat = sym_idx.to(torch.int64) * 2 + mirror.to(torch.int64)
    gathered = batched_take(d2.reshape(B, N * 2, H), flat).sum(dim=2)
    np.testing.assert_allclose(te.slot_sum_torch(d2, sym).numpy(),
                               gathered.numpy(), rtol=1e-6, atol=1e-6)


def _hub_lists():
    """The knn hub case's lists (a hub past the cap: not symmetric)."""
    from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph

    x, _, _, mlp, *_ = _setup(B=2, N=128, K=8, H=8, seed=8)
    x[:, :60] *= 0.05
    x[:, 0] = 0.0
    nbr, _, _ = knn_und_graph(torch.as_tensor(x),
                              torch.ones(2, 128, dtype=torch.bool), k=4, cap=8)
    return x, nbr, mlp


def _per_edge_grads(a, x, nbr, w_diff, w1, b1, aggr, g0, g1, gst):
    """Autograd of the per-edge formulation (x_j gathered per slot, every
    product per edge) in the inputs' dtype: the gradients of a, x, W_diff,
    W1, b1 and the per-slot dz0 ``[B, N, K, F1]`` (0 at masked slots)."""
    from deepmetv2_tpu_torch.nn.core import elu

    leaves = [t.detach().clone().requires_grad_(True)
              for t in (a, x, w_diff, w1, b1)]
    a, x, w_diff, w1, b1 = leaves
    z0 = torch.matmul(gather_neighbors(x, nbr), w_diff) + a[:, :, None, :]
    z0.retain_grad()
    h = elu(torch.matmul(elu(z0), w1) + b1)
    m = nbr.mask[..., None]
    hm = torch.where(m, h, torch.zeros_like(h))
    loss = ((hm.sum(dim=(0, 1, 2)) * gst[0]).sum()
            + ((hm * hm).sum(dim=(0, 1, 2)) * gst[1]).sum())
    if aggr == "max":
        has = nbr.mask.any(dim=-1)[..., None]
        inf = torch.full_like(h, float("inf"))
        for v, g in ((torch.where(m, h, -inf).amax(dim=2), g0),
                     (torch.where(m, h, inf).amin(dim=2), g1)):
            loss = loss + torch.where(has, v * g, torch.zeros_like(v)).sum()
    else:
        loss = loss + (hm.sum(dim=2) * g0).sum()
    loss.backward()
    return [t.grad for t in leaves], z0.grad


@pytest.mark.parametrize("aggr", ["add", "mean", "max"])
@pytest.mark.parametrize("case", ["lists", "hub"])
def test_edge_mlp_bwd_first_layer_per_node(case, aggr):
    """The backward's first layer per node: ``dzs`` is the gather's
    adjoint (``slot_sum_torch``) of the per-slot dz0, and ``dx =
    dzs·W_diffᵀ``, ``dW_diff = Xᵀ·dzs`` equal the per-edge formulation's
    gradients (autograd through the per-slot gather), on random lists
    (duplicate targets in a row, an empty row per event) and on a knn
    list with a hub past the cap.  In f64 to 1e-10 relative; in f32
    within the tolerance that holds the port to JAX."""
    if case == "lists":
        x, idx, mask, mlp, *_ = _setup(seed=5)
        nbr = Neighborhood(torch.as_tensor(idx), torch.as_tensor(mask))
    else:
        x, nbr, mlp = _hub_lists()
    B, N, H = x.shape
    rng = np.random.default_rng(17)
    w0, b0 = mlp["lin0"]["w"], mlp["lin0"]["b"]
    H2 = mlp["lin1"]["w"].shape[1]
    a = x @ (w0[:H] - w0[H:]) + b0
    g0, g1 = rng.normal(size=(2, B, N, H2))
    gst = rng.normal(size=(2, H2)) * 1e-2
    for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-12),
                              (torch.float32, GRAD_RTOL, GRAD_ATOL)):
        t = [torch.as_tensor(v, dtype=dtype) for v in
             (a, x, w0[H:], mlp["lin1"]["w"], mlp["lin1"]["b"], g0, g1, gst)]
        a_, x_, wd, w1, b1, g0_, g1_, gst_ = t
        agg0, agg1, _ = te.edge_mlp_fwd_torch(a_, x_, nbr, wd, w1, b1, aggr)
        gr = te.edge_mlp_bwd_torch(a_, x_, nbr, wd, w1, b1, aggr, agg0, agg1,
                                   g0_, g1_ if aggr == "max" else None, gst_)
        ref = [v.double() for v in t[:5]]
        (da, dx, dwd, dw1, db1), dz0 = _per_edge_grads(
            ref[0], ref[1], nbr, *ref[2:], aggr, g0_.double(), g1_.double(),
            gst_.double())
        dzs = te.slot_sum_torch(dz0, nbr)
        want = {"da": da, "dx": dx, "dzs": dzs, "dw_diff": dwd, "dw1": dw1,
                "db1": db1}
        for name in gr._fields:
            w = want[name].numpy()
            np.testing.assert_allclose(
                getattr(gr, name).double().numpy(), w, rtol=rtol,
                atol=atol * float(np.abs(w).max()), err_msg=f"{name} {dtype}")
        # the per-node products of dzs are dx and dW_diff
        np.testing.assert_allclose(
            dx.numpy(), (dzs @ ref[2].t()).numpy(), rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(
            dwd.numpy(), torch.einsum("bnh,bnf->hf", ref[1], dzs).numpy(),
            rtol=1e-10, atol=1e-12)
