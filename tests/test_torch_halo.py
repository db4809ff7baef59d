"""The port's edge-partitioned window path (deepmetv2_tpu_torch/parallel/
halo.py, collectives.py, ep.py) against the JAX package's
(``parallel/halo.py:window_max_sharded``, ``parallel/ep.py:
make_ep_train_step``) on the tests' 8-device virtual CPU mesh, the port's
side as 4 gloo ranks (tests/torch_mesh_worker.py), on the same
numpy-seeded inputs; the cases of tests/test_halo.py.

Tolerances: the sharded forward is bitwise the JAX package's and the
port's single-device window max on real rows (a max selects one of its
operands; the random positions put no pair on the radius, where the two
packages' rounding of the predicate may differ); its gradient within
1e-5 of the largest gradient (a boundary source's terms are summed in two
parts, its own rank's and the exchange's; no exact ties in the data, where
the JAX twin's rule differs); the EP step's loss rtol 1e-5, parameters
within 1e-5 of each tensor's largest value, the EdgeConv biases by the
2·lr-per-step rule of tests/test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import DataConfig as JDataConfig
from deepmetv2_tpu.config import GraphConfig as JGraphConfig
from deepmetv2_tpu.models.graph_met import graph_met_init as j_init
from deepmetv2_tpu.parallel.ep import make_ep_train_step
from deepmetv2_tpu.parallel.halo import window_max_sharded as j_sharded
from deepmetv2_tpu.parallel.mesh import make_mesh, shard_batch
from deepmetv2_tpu.train.step import init_train_state
from deepmetv2_tpu_torch.config import Config, DataConfig, GraphConfig
from deepmetv2_tpu_torch.data import collate, synthetic_events
from deepmetv2_tpu_torch.data.sorting import (cell_sort_batch,
                                              presort_batch, required_halo,
                                              required_span_batch)
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import WindowMax
from deepmetv2_tpu_torch.ops.window import PAD_POS
from deepmetv2_tpu_torch.parallel.halo import halo_pad
from tests.torch_mesh_worker import run_ranks
from tests.torch_threads import few_torch_threads  # noqa: F401

WORLD = 4
R2 = 0.16
GRAD_ATOL = 1e-5      # times the largest |gradient|
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5

# (name, B, N, H, halo, n_node, overlap, positions) — tests/test_halo.py's
CASES = [
    ("n2_overlap", 2, 512, 4, 64, 2, True, "sorted"),
    ("n2_serial", 2, 512, 4, 64, 2, False, "sorted"),
    ("n4_overlap", 2, 512, 4, 64, 4, True, "sorted"),
    ("n4_serial", 2, 512, 4, 64, 4, False, "sorted"),
    # 64 <= shard 96 < 2·64: the serial schedule though overlap is asked
    ("below_two_halo", 2, 384, 4, 64, 4, True, "sorted"),
    # every node at one position, shard == halo: no phantom ring rows.
    # Every pair is adjacent, so the in-radius span exceeds any halo and
    # the result is the window's own: ±halo rows for each query in the
    # port's kernels, whole query tiles ± halo in the JAX package's XLA
    # twin; this case is held to the port's single-device kernel only.
    ("boundary", 2, 256, 4, 128, 2, True, "zeros"),
    # padded rows at the end of every event, some shards all padded
    ("padded", 2, 512, 8, 100, 4, True, "padded"),
    # shard 64 < halo_pad 128: refused
    ("refused", 2, 256, 4, 100, 4, True, "sorted"),
]


def _inputs(case):
    name, B, N, H, halo, n_node, overlap, kind = case
    rng = np.random.default_rng(len(name) + N + H)
    c = rng.normal(size=(B, N, H)).astype(np.float32)
    if kind == "zeros":
        return c, np.zeros((B, N, 2), np.float32)
    eta = np.sort(rng.uniform(-4, 4, (B, N)).astype(np.float32), axis=1)
    phi = rng.uniform(-np.pi, np.pi, (B, N)).astype(np.float32)
    pos = np.stack([eta, phi], -1)
    if kind == "padded":
        pos[0, 300:] = PAD_POS
        pos[1, 130:] = PAD_POS
    return c, pos


def _jax_window(case, c, pos):
    """The JAX package's sharded forward and its gradient (interpret
    mode: its XLA window twin on the CPU)."""
    _, _, _, _, halo, n_node, overlap, _ = case
    mesh = make_mesh(n_data=1, n_node=n_node)

    def f(c):
        return j_sharded(c, jnp.asarray(pos), r2=R2, halo=halo, mesh=mesh,
                         data_axis=None, interpret=True, overlap=overlap)

    def loss(c):
        m = f(c)
        return jnp.sum(jnp.where(jnp.isfinite(m), m, 0.0) ** 2)

    with mesh:
        return (np.asarray(jax.jit(f)(jnp.asarray(c))),
                np.asarray(jax.jit(jax.grad(loss))(jnp.asarray(c))))


def _port_single(case, c, pos):
    """The port's single-device window max (its plain versions on the CPU)
    at ``halo_pad`` and its gradient."""
    halo = case[4]
    ct = torch.tensor(c, requires_grad=True)
    m = WindowMax.apply(ct, torch.tensor(pos), R2, halo_pad(halo))
    torch.where(torch.isfinite(m), m, torch.zeros_like(m)).pow(2).sum(
    ).backward()
    return m.detach().numpy(), ct.grad.numpy()


@pytest.fixture(scope="module")
def port_windows(tmp_path_factory):
    """Every case through the port's window_max_sharded on 4 gloo ranks
    (one rank group for all): the shards' m and dc put back together."""
    cases = []
    for case in CASES:
        c, pos = _inputs(case)
        n_node = case[5]
        cases.append(dict(c=c, pos=pos, r2=R2, halo=case[4],
                          overlap=case[6], mesh=(WORLD // n_node, n_node)))
    outs = run_ranks("window", {"cases": cases}, WORLD,
                     str(tmp_path_factory.mktemp("window")))
    results = {}
    for i, case in enumerate(CASES):
        n_data, n_node = cases[i]["mesh"]
        per = [outs[r][i] for r in range(WORLD)]
        if "error" in per[0]:
            results[case[0]] = per[0]["error"]
            continue
        rows = [np.concatenate([per[d * n_node + n][k] for n in range(n_node)],
                               axis=1) for d in range(n_data)
                for k in ("m", "dc")]
        results[case[0]] = (np.concatenate(rows[0::2], 0),
                            np.concatenate(rows[1::2], 0))
    return results


def _real(pos):
    return pos[..., 0] < PAD_POS / 2


def _assert_grad_close(got, want):
    atol = GRAD_ATOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] != "refused"],
                         ids=lambda c: c[0])
def test_window_max_sharded_matches_jax_and_single_device(port_windows,
                                                          case):
    c, pos = _inputs(case)
    m, dc = port_windows[case[0]]
    real = _real(pos)
    sm, sdc = _port_single(case, c, pos)
    np.testing.assert_array_equal(m[real], sm[real])
    assert np.all(np.isneginf(m[~real]))      # padded rows: −inf
    _assert_grad_close(dc, sdc)
    if case[7] != "zeros":
        jm, jdc = _jax_window(case, c, pos)
        np.testing.assert_array_equal(m[real], jm[real])
        _assert_grad_close(dc, jdc)


def test_window_max_sharded_refuses_a_shard_below_the_halo(port_windows):
    case = [c for c in CASES if c[0] == "refused"][0]
    c, pos = _inputs(case)
    with pytest.raises(ValueError) as want:
        _jax_window(case, c, pos)
    assert port_windows["refused"] == str(want.value)


def test_halo_exchange_gradient_matches_autograd(tmp_path):
    """The exchange's written-out backward against autograd of the same
    strips cut from the whole tensor in one process: each rank's received
    strips are its neighbours' edge rows (0 and PAD_POS at the ring ends),
    and each edge row's gradient is what its neighbour's strip received."""
    rng = np.random.default_rng(11)
    B, N, H, h = 2, 64, 3, 8
    n_loc = N // WORLD
    c = rng.normal(size=(B, N, H)).astype(np.float32)
    pos = rng.normal(size=(B, N, 2)).astype(np.float32)
    wl, wr = (rng.normal(size=(WORLD, B, h, H)).astype(np.float32)
              for _ in range(2))
    outs = run_ranks("exchange", dict(c=c, pos=pos, h=h, wl=wl, wr=wr),
                     WORLD, str(tmp_path))
    ct = torch.tensor(c, requires_grad=True)
    total = 0
    for r, out in enumerate(outs):
        lo, hi = r * n_loc, (r + 1) * n_loc
        if r > 0:
            np.testing.assert_array_equal(out["cl"], c[:, lo - h:lo])
            np.testing.assert_array_equal(out["pl"], pos[:, lo - h:lo])
            total = total + (ct[:, lo - h:lo] * torch.tensor(wl[r])).sum()
        else:
            assert not out["cl"].any() and np.all(out["pl"] == PAD_POS)
        if r < WORLD - 1:
            np.testing.assert_array_equal(out["cr"], c[:, hi:hi + h])
            np.testing.assert_array_equal(out["pr"], pos[:, hi:hi + h])
            total = total + (ct[:, hi:hi + h] * torch.tensor(wr[r])).sum()
        else:
            assert not out["cr"].any() and np.all(out["pr"] == PAD_POS)
    total.backward()
    got = np.concatenate([o["dc"] for o in outs], axis=1)
    np.testing.assert_allclose(got, ct.grad.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the EP step


def _assert_same_state(state, params, bn_state, n_steps, lr=1e-3):
    """Every parameter and buffer within PARAM_ATOL of its tensor's largest
    value; the biases before a masked BatchNorm and the running means
    after them to 2·lr per step (tests/test_torch_mesh.py:noise_path)."""
    from tests.test_torch_mesh import noise_path

    want = GraphMET().params_from_jax(params, bn_state)
    for path, ref in want.jax_layout():
        ref = ref.detach().numpy()
        noise = noise_path(path)
        atol = (2 * lr * n_steps if noise
                else PARAM_ATOL * max(float(np.abs(ref).max()), 1.0))
        np.testing.assert_allclose(state[path], ref, rtol=0, atol=atol,
                                   err_msg=str(path))


def _ep_case(tmp_path, batch, halo, seed, n_node, j_mesh):
    g = dict(mode="window", window_halo=halo, presorted=True)
    N = batch.x_cont.shape[1]
    jcfg = JConfig(graph=JGraphConfig(**g),
                   data=JDataConfig(node_buckets=(N,)))
    tcfg = Config(graph=GraphConfig(**g), data=DataConfig(node_buckets=(N,)))
    params, bn_state = j_init(jax.random.PRNGKey(seed))
    jparams = jax.tree_util.tree_map(np.asarray, (params, bn_state))
    outs = run_ranks("train", dict(cfg=tcfg.to_json(), params=jparams,
                                   batches=[tuple(batch)],
                                   mesh=(WORLD // n_node, n_node)),
                     WORLD, str(tmp_path))
    mesh = make_mesh(*j_mesh)
    state = init_train_state(params, bn_state, jcfg)
    with mesh:
        from deepmetv2_tpu.data.batching import EventBatch as JBatch

        sharded = shard_batch(JBatch(*batch), mesh, shard_nodes=True)
        state, loss = make_ep_train_step(jcfg, mesh, interpret=True)(
            state, sharded)
    for out in outs[1:]:       # every rank holds the same model
        assert out["losses"] == outs[0]["losses"]
        for k, v in out["state"].items():
            np.testing.assert_array_equal(v, outs[0]["state"][k])
    np.testing.assert_allclose(outs[0]["losses"][0], float(loss),
                               rtol=LOSS_RTOL)
    _assert_same_state(outs[0]["state"], state.params, state.bn_state, 1)


def test_ep_step_matches_jax(tmp_path):
    """tests/test_halo.py's window step: 4 eta-sorted events at N=1024,
    halo 128, the JAX package on a 2x4 mesh, the port on 2x2 ranks."""
    events = synthetic_events(4, seed=7, n_min=1024 - 128, n_max=1023)
    batch = presort_batch(collate(events, buckets=(1024,)))
    assert required_halo(batch, 0.4) <= 128
    _ep_case(tmp_path, batch, 128, 7, 2, (2, 4))


def test_cell_order_ep_matches_jax(tmp_path):
    """The cell-sorted layout composes with edge partitioning, its own span
    as the halo (tests/test_halo.py's cell case): the JAX package on 2x2,
    the port on 2x2 ranks."""
    events = synthetic_events(4, seed=9, n_min=896, n_max=1023)
    batch = cell_sort_batch(collate(events, buckets=(1024,)), r=0.4)
    halo = max(64, -(-required_span_batch(batch, 0.4) // 64) * 64)
    assert 1024 // 2 >= halo_pad(halo)
    _ep_case(tmp_path, batch, halo, 9, 2, (2, 2))
