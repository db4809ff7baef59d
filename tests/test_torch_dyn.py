"""The port's node-sharded DRN (deepmetv2_tpu_torch/parallel/knn.py,
dyn.py; ``fit(mesh=, shard_nodes=True)`` and ``cli.train --model drn
--mesh DxN [--ring_knn]``) against the JAX package's
(``parallel/knn.py``, ``parallel/dyn.py``) on the tests' 8-device virtual
CPU mesh, the port's side as gloo ranks (tests/torch_mesh_worker.py), on
the same numpy-seeded inputs and initial parameters; the cases of
tests/test_parallel.py.  One group of 4 ranks computes every kNN, forward
and train-step case.

The JAX forwards run their conv as on a TPU (``_jax_tpu_conv``): the
sharded trace reaches the fused edge-MLP conv (ops/pallas/edge_mlp.py),
here in interpret mode; the port's runs its fused conv (on the CPU the
kernels' plain versions).  The train step's JAX reference keeps the XLA
conv (see test_train_step_matches_jax).

Tolerances: kNN masks exact; indices exact in order on rows without a
near tie at the (k+1)-th place (two candidates within 1e-5 of the row's
largest squared norm, in f64) and as sets on the others; on lattice
features (exact arithmetic in f32) exact everywhere, ties included.
Forwards rtol/atol 1e-5 (JAX's own test); BatchNorm buffers within 1e-5
of their largest value; the train step's loss rtol 1e-5, its parameters by
tests/test_torch_mesh.py's rule (1e-5 of each tensor's largest value,
``noise_path`` tensors 2·lr per step).
"""

import contextlib
import json
import os
import os.path as osp
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import DataConfig as JDataConfig
from deepmetv2_tpu.config import DRNConfig as JDRNConfig
from deepmetv2_tpu.data.batching import EventBatch as JBatch
from deepmetv2_tpu.models.drn import drn_init as j_drn_init
from deepmetv2_tpu.parallel.dyn import drn_net_apply_sharded as j_apply
from deepmetv2_tpu.parallel.dyn import make_drn_ep_train_step
from deepmetv2_tpu.parallel.knn import knn_graph_sharded as j_knn
from deepmetv2_tpu.parallel.knn import knn_graph_sharded_ring as j_ring
from deepmetv2_tpu.parallel.mesh import (batch_sharding, make_mesh,
                                         replicate, shard_batch)
from deepmetv2_tpu.train.step import init_train_state
from deepmetv2_tpu_torch.config import Config, DataConfig, DRNConfig
from deepmetv2_tpu_torch.data import collate, synthetic_events
from deepmetv2_tpu_torch.data.batching import to_device
from deepmetv2_tpu_torch.models.drn import DRN, _compact_size, drn_net_apply
from tests.test_torch_mesh import (_assert_same_state, _fit_spec,
                                   _np_trees, _ranks_agree)
from tests.torch_mesh_worker import REPO, run_ranks
from tests.torch_threads import few_torch_threads  # noqa: F401

FWD_RTOL = FWD_ATOL = 1e-5
BN_ATOL = 1e-5
LOSS_RTOL = 1e-5
NEAR_TIE = 1e-5
WORLD = 4


@contextlib.contextmanager
def _jax_tpu_conv():
    """The JAX DRN's conv as a TPU backend picks it
    (models/drn.py:_fused_conv_available true at the shapes the Pallas
    conv takes), the Pallas conv in interpret mode."""
    import deepmetv2_tpu.models.drn as jdrn
    import deepmetv2_tpu.ops.pallas.edge_mlp as jem

    available, conv = jdrn._fused_conv_available, jem.edge_mlp_conv

    def on_tpu(mlp, x, nbr, force, interpret):
        return available(mlp, x, nbr, force, True)

    def interpreted(*args, interpret=False, **kw):
        return conv(*args, interpret=True, **kw)

    with mock.patch.object(jdrn, "_fused_conv_available", on_tpu), \
            mock.patch.object(jem, "edge_mlp_conv", interpreted):
        yield


def _knn_cases():
    """tests/test_parallel.py's shapes (B=4, N=64, D=8, k=5): random
    features, the same with self-loops, and lattice features in {0, 1, 2}
    with shard 1's rows copies of shard 0's (exact ties across shards)."""
    rng = np.random.default_rng(0)
    B, N, D, k = 4, 64, 8, 5
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = rng.random((B, N)) < 0.9
    lat = rng.integers(0, 3, (B, N, D)).astype(np.float32)
    lat[:, 16:32] = lat[:, 0:16]
    lmask = rng.random((B, N)) < 0.9
    lmask[:, 16:32] = lmask[:, 0:16]
    return [dict(name="random", x=x, mask=mask, k=k, loop=False),
            dict(name="loop", x=x, mask=mask, k=k, loop=True),
            dict(name="lattice", x=lat, mask=lmask, k=k, loop=False)]


def _fwd_case():
    """tests/test_parallel.py's forward: 4 events of 40-63 candidates in
    the 64 bucket, DRNConfig(hidden_dim=16, k=4)."""
    events = synthetic_events(4, seed=11, n_min=40, n_max=63)
    batch = collate(events, buckets=(64,), pad_events_to=4)
    jcfg = JDRNConfig(hidden_dim=16, k=4)
    return batch, jcfg, j_drn_init(jax.random.PRNGKey(4), jcfg)


def _big_case():
    """4 events of 300-511 candidates in the 512 bucket, where the
    single-device path compacts between rounds (512 -> 384)."""
    events = synthetic_events(4, seed=13, n_min=300, n_max=511)
    batch = collate(events, buckets=(512,), pad_events_to=4)
    jcfg = JDRNConfig(hidden_dim=16, k=4)
    return batch, jcfg, j_drn_init(jax.random.PRNGKey(7), jcfg)


def _train_case():
    """tests/test_parallel.py's node-sharded train step."""
    events = synthetic_events(4, seed=12, n_min=40, n_max=63)
    batch = collate(events, buckets=(64,), pad_events_to=4)
    kw = dict(drn=dict(hidden_dim=16, k=4),
              data=dict(batch_size=4, node_buckets=(64,)))
    jcfg = JConfig(drn=JDRNConfig(**kw["drn"]),
                   data=JDataConfig(**kw["data"]))
    return batch, jcfg, kw, j_drn_init(jax.random.PRNGKey(5), jcfg.drn)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case on one group of 4 ranks; rank 0's and all ranks'
    results."""
    fwd = []
    for (batch, jcfg, params), mesh in ((_fwd_case(), (1, 4)),
                                        (_big_case(), (2, 2))):
        tcfg = Config(drn=DRNConfig(hidden_dim=jcfg.hidden_dim, k=jcfg.k))
        fwd.append(dict(cfg=tcfg.to_json(), family="drn", mesh=mesh,
                        params=_np_trees(*params), batch=tuple(batch)))
    batch, _, kw, params = _train_case()
    train = []
    for ring in (False, True):
        tcfg = Config(drn=DRNConfig(ring_knn=ring, **kw["drn"]),
                      data=DataConfig(**kw["data"]))
        train.append(dict(cfg=tcfg.to_json(), family="drn", mesh=(2, 2),
                          params=_np_trees(*params),
                          batches=[tuple(batch)]))
    spec = dict(knn=[dict(c, mesh=(1, WORLD)) for c in _knn_cases()],
                forward=fwd, train=train)
    return run_ranks("dyn", spec, WORLD, str(tmp_path_factory.mktemp("dyn")))


def _assemble(outs, get, dims):
    """The whole ``[B, N, ...]`` array from each rank's shard ``get(out)``
    on a (data, node) mesh ``dims``."""
    D, N = dims
    return np.concatenate([np.concatenate([get(outs[d * N + n])
                                           for n in range(N)], axis=1)
                           for d in range(D)], axis=0)


def _jax_knn(case, ring: bool):
    mesh = make_mesh(n_data=2, n_node=WORLD)
    build = j_ring if ring else j_knn
    with mesh:
        got = jax.jit(lambda x, m: build(x, m, k=case["k"], mesh=mesh,
                                         loop=case["loop"]))(case["x"],
                                                             case["mask"])
    return np.asarray(got.idx), np.asarray(got.mask)


def _near_tie_rows(case):
    """[B, N] bool: rows whose k-th and (k+1)-th candidate d² (f64) differ
    by a nonzero amount within NEAR_TIE of the largest squared norm, where
    f32 rounding may order them either way."""
    x = case["x"].astype(np.float64)
    d2 = ((x[:, :, None] - x[:, None, :]) ** 2).sum(-1)
    ok = case["mask"][:, :, None] & case["mask"][:, None, :]
    if not case["loop"]:
        ok &= ~np.eye(x.shape[1], dtype=bool)[None]
    s = np.sort(np.where(ok, d2, np.inf), axis=-1)
    k = case["k"]
    with np.errstate(invalid="ignore"):       # inf − inf past the valid
        gap = s[..., k] - s[..., k - 1]
    return (gap > 0) & (gap <= NEAR_TIE * (x * x).sum(-1).max())


@pytest.mark.parametrize("which", range(3), ids=["random", "loop", "lattice"])
def test_knn_builds_match_jax(ranks, which):
    """Both builds on a 1x4 node group against the JAX package's on its
    2x4 virtual mesh: the masks exact, the indices exact (in order) on
    rows without a near tie, as sets on the others."""
    case = _knn_cases()[which]
    near = _near_tie_rows(case)
    for build, ring in (("gather", False), ("ring", True)):
        idx = _assemble(ranks, lambda o: o["knn"][which][build][0],
                        (1, WORLD))
        mask = _assemble(ranks, lambda o: o["knn"][which][build][1],
                         (1, WORLD))
        jidx, jmask = _jax_knn(case, ring)
        np.testing.assert_array_equal(mask, jmask, err_msg=build)
        np.testing.assert_array_equal(idx[~near], jidx[~near],
                                      err_msg=build)
        big = 1 << 20
        np.testing.assert_array_equal(
            np.sort(np.where(mask, idx, big), -1)[near],
            np.sort(np.where(jmask, jidx, big), -1)[near], err_msg=build)
    if case["name"] == "lattice":
        assert not near.any()


def test_ring_visit_order_on_ties(ranks):
    """On exact ties across shards the ring keeps the neighbour it visited
    first (own shard, then shard − 1, ...), the all-gather build the lower
    global index: on the lattice case the two builds differ, each equal to
    its JAX counterpart (test_knn_builds_match_jax), and every row's
    neighbours have the same d² in both."""
    case = _knn_cases()[2]
    gi, ri = (_assemble(ranks, lambda o: o["knn"][2][b][0], (1, WORLD))
              for b in ("gather", "ring"))
    gm = _assemble(ranks, lambda o: o["knn"][2]["gather"][1], (1, WORLD))
    assert (gi != ri).any()
    x = case["x"]
    b = np.arange(x.shape[0])[:, None, None]
    q = np.arange(x.shape[1])[None, :, None]

    def d2(idx):
        return np.where(gm, ((x[b, q] - x[b, idx]) ** 2).sum(-1), 0)

    np.testing.assert_array_equal(d2(gi), d2(ri))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(ranks, train):
    """drn_net_apply_sharded on a 1x4 node group against the JAX
    package's on its 2x4 virtual mesh (tests/test_parallel.py's case) with
    the TPU's conv, in eval and train mode; the ring build's forward
    equals the all-gather build's bit for bit (the same graphs); in train
    mode the BatchNorm buffers too."""
    batch, jcfg, (params, bn_state) = _fwd_case()
    mesh = make_mesh(n_data=2, n_node=WORLD)
    rep, bsh = replicate(mesh), batch_sharding(mesh, shard_nodes=True)
    with mesh, _jax_tpu_conv():
        sb = jax.tree_util.tree_map(jax.device_put, JBatch(*batch), bsh)
        want, new_bn = jax.jit(
            lambda p, s, b: j_apply(p, s, b, train, jcfg, mesh),
            in_shardings=(rep, rep, bsh))(params, bn_state, sb)
    got = ranks[0]["forward"][0]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["forward"][0][False, train]["pred"],
                                      got[False, train]["pred"])
    np.testing.assert_allclose(got[False, train]["pred"], np.asarray(want),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    np.testing.assert_array_equal(got[True, train]["pred"],
                                  got[False, train]["pred"])
    ref = DRN(DRNConfig(hidden_dim=16, k=4)).params_from_jax(params, new_bn)
    for path, t in ref.jax_layout():
        if path[0] != "bn_state":
            continue
        t = t.detach().numpy()
        np.testing.assert_allclose(
            got[False, train]["state"][path], t, rtol=0,
            atol=BN_ATOL * max(float(np.abs(t).max()), 1.0), err_msg=str(path))


def _x(batch):
    return np.concatenate([batch.x_cont, batch.x_cat.astype(np.float32)],
                          axis=-1)


def test_drn_apply_sharded_matches_jax(ranks):
    """drn_apply_sharded (no head) on the 1x4 node group against the JAX
    package's on its 2x4 virtual mesh with the TPU's conv, eval mode."""
    from deepmetv2_tpu.parallel.dyn import drn_apply_sharded as j_raw

    batch, jcfg, (params, bn_state) = _fwd_case()
    mesh = make_mesh(n_data=2, n_node=WORLD)
    with mesh, _jax_tpu_conv():
        want, _ = jax.jit(lambda p, s, x, m: j_raw(p, s, x, m, False, jcfg,
                                                   mesh))(
            params, bn_state, _x(batch), batch.mask)
    np.testing.assert_allclose(ranks[0]["forward"][0]["raw"],
                               np.asarray(want), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


@pytest.mark.parametrize("conv", ["fused", "xla"])
def test_knn_fn_hook_on_one_device_matches_jax(conv):
    """drn_apply's graph-build hook without a mesh (``knn_fn`` the
    single-device knn_graph, the whole node axis) against the JAX
    package's drn_apply with its knn_graph injected, each conv forced (the
    JAX fused conv in interpret mode), eval mode: rtol/atol 1e-5."""
    from deepmetv2_tpu.models.drn import drn_apply as j_drn_apply
    from deepmetv2_tpu.ops.graph import knn_graph as j_knn_graph
    from deepmetv2_tpu_torch.models.drn import drn_apply
    from deepmetv2_tpu_torch.ops.graph import knn_graph

    batch, jcfg, (params, bn_state) = _fwd_case()
    want, _ = jax.jit(lambda p, s, x, m: j_drn_apply(
        p, s, x, m, False, jcfg,
        knn_fn=lambda h, hm: j_knn_graph(h, hm, k=jcfg.k), conv_force=conv,
        conv_interpret=conv == "fused"))(
        params, bn_state, _x(batch), batch.mask)
    model = DRN(DRNConfig(hidden_dim=16, k=4)).params_from_jax(params,
                                                                bn_state)
    with torch.no_grad():
        got = drn_apply(model.eval(), torch.tensor(_x(batch)),
                        torch.tensor(batch.mask), conv_force=conv,
                        knn_fn=lambda h, m: knn_graph(h, m, k=jcfg.k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FWD_RTOL, atol=FWD_ATOL)


def test_forward_without_compaction_matches_single_device(ranks):
    """At N=512 the single-device path compacts between rounds
    (_compact_size(512) = 384) and the node-sharded one does not; on a 2x2
    mesh its output equals the port's single-device composed forward
    (graph_force='composed', the fused conv as the sharded path takes it)
    within 1e-5."""
    assert _compact_size(512) == 384
    batch, jcfg, params = _big_case()
    model = DRN(DRNConfig(hidden_dim=16, k=4)).params_from_jax(*params)
    diag = {}
    with torch.no_grad():
        want = drn_net_apply(model.eval(), to_device(batch, "cpu"), diag,
                             graph_force="composed")
    assert [int(d) for d in diag["compact_dropped"]] == [0]
    got = _assemble(ranks, lambda o: o["forward"][1][False, False]["pred"][
        :, None], (2, 2))
    for n in range(2):      # both ranks of a node group hold the output
        np.testing.assert_array_equal(got[:, n], got[:, 0])
    np.testing.assert_allclose(got[:, 0], want.numpy(), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def test_train_step_matches_jax(ranks):
    """One node-sharded train step on a 2x2 mesh against the JAX package's
    make_drn_ep_train_step on a 2x2 virtual mesh: the loss, every rank's
    identical model, and the parameters; the ring build's step is bitwise
    the all-gather build's.  The JAX step runs its XLA conv here: with the
    Pallas conv interpreted under the sharded trace its gradient is not
    the single-device one (``test_jax_sharded_pallas_conv_gradient``)."""
    batch, jcfg, _, params = _train_case()
    outs = [r["train"][0] for r in ranks]
    _ranks_agree(outs)
    mesh = make_mesh(n_data=2, n_node=2)
    state = init_train_state(*params, jcfg)
    with mesh:
        state, loss = make_drn_ep_train_step(jcfg, mesh)(
            state, shard_batch(JBatch(*batch), mesh, shard_nodes=True))
    np.testing.assert_allclose(outs[0]["losses"], [float(loss)],
                               rtol=LOSS_RTOL)
    _assert_same_state(outs[0]["state"], DRN(DRNConfig(
        hidden_dim=16, k=4)).params_from_jax(state.params, state.bn_state),
        1)
    ring = ranks[0]["train"][1]
    assert ring["losses"] == outs[0]["losses"]
    for k, v in ring["state"].items():
        np.testing.assert_array_equal(v, outs[0]["state"][k])


def test_fit_node_sharded_drn_writes_a_jax_checkpoint(tmp_path):
    """``fit`` on a 1x2 mesh with shard_nodes for the DRN: both ranks end
    with the same model, rank 0 writes the artifacts, the JAX package
    loads its checkpoint, and the validation loss it wrote is the port's
    single-device evaluation of that model."""
    from deepmetv2_tpu.train.checkpoint import load_checkpoint as j_load
    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.train import step as tstep
    from deepmetv2_tpu_torch.train.loop import evaluate

    events, loader, spec = _fit_spec(tmp_path, "drn", (1, 2))
    outs = run_ranks("fit", spec, 2, str(tmp_path / "run"))
    for k, v in outs[1]["state"].items():
        np.testing.assert_array_equal(v, outs[0]["state"][k])
    ck = spec["ckpts"]
    cfg = Config.from_json(spec["cfg"])
    state, payload = j_load(osp.join(ck, "last.ckpt"))
    assert payload["epoch"] == 1 and int(state.step) > 0
    model = DRN(cfg.drn).params_from_jax(state.params, state.bn_state)
    for path, t in model.jax_layout():
        np.testing.assert_array_equal(t.detach().numpy(),
                                      outs[0]["state"][path])
    single, _ = evaluate(model, tstep.make_drn_eval_step(cfg),
                         fetch_dataloader(events=events, **loader)["test"],
                         cfg, "cpu", verbose=False)
    with open(osp.join(ck, "metrics_val_last.json")) as f:
        assert np.isclose(json.load(f)["loss"], single["loss"],
                          rtol=LOSS_RTOL)


def test_train_cli_node_sharded_drn_ring(tmp_path):
    """``cli.train --model drn --mesh 1x2 --ring_knn`` spawns its two
    ranks: the mesh line names the node-sharded DRN and its ring build,
    one epoch's checkpoint, and no kernel launch on either rank (the
    CPU's: the kernels' plain versions)."""
    ck = str(tmp_path / "ck")
    r = subprocess.run(
        [sys.executable, "-m", "deepmetv2_tpu_torch.cli.train", "--model",
         "drn", "--drn_head", "cartesian", "--synthetic", "5",
         "--batch_size", "4", "--epochs", "1", "--ckpts", ck, "--device",
         "cpu", "--mesh", "1x2", "--ring_knn"], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert ("mesh: 1 data x 2 node over 2 ranks, backend gloo, collectives "
            "on the CPU (node-sharded DRN, ring kNN)") in lines
    assert "feed: resident, chain 8, eager (mesh)" in lines
    counts = json.loads([ln for ln in lines if ln.startswith(
        "launches by rank:")][0].split(":", 1)[1])
    assert len(counts) == 2 and not any(sum(c.values()) for c in counts)
    with open(osp.join(ck, "config.json")) as f:
        assert json.load(f)["drn"]["ring_knn"] is True
    assert osp.exists(osp.join(ck, "best.ckpt"))
