"""The port's data-parallel mesh (deepmetv2_tpu_torch/parallel/mesh.py,
multihost.py, dp.py; train/loop.py:fit and cli/train.py with a mesh)
against the JAX package's (``parallel/dp.py:make_dp_train_step``,
``make_drn_dp_train_step``, ``train/loop.py:make_sharded_eval``) on the
tests' 8-device virtual CPU mesh, the port's side as gloo ranks
(tests/torch_mesh_worker.py), on the same numpy-seeded inputs and the
same initial parameters; the cases of tests/test_parallel.py and
tests/test_multihost.py.

Tolerances: losses rtol 1e-5; parameters after 2 AdamW steps within 1e-5
of each tensor's largest value, except the biases before a masked
BatchNorm and the running means after them (``noise_path``: 2·lr per step,
the rule of tests/test_torch_train.py, as their exact gradient is about
0); evaluation losses rtol 1e-5 and weights within 1e-5.  The
ranks of one run hold bitwise the same model.
"""

import ast
import json
import os
import os.path as osp
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepmetv2_tpu.config import Config as JConfig
from deepmetv2_tpu.config import DataConfig as JDataConfig
from deepmetv2_tpu.config import DRNConfig as JDRNConfig
from deepmetv2_tpu.config import GraphConfig as JGraphConfig
from deepmetv2_tpu.data.batching import EventBatch as JBatch
from deepmetv2_tpu.models import graph_met_init as j_init
from deepmetv2_tpu.models.drn import drn_init as j_drn_init
from deepmetv2_tpu.parallel.dp import (make_dp_train_step,
                                       make_drn_dp_train_step)
from deepmetv2_tpu.parallel.mesh import make_mesh, shard_batch
from deepmetv2_tpu.train.loop import make_sharded_eval
from deepmetv2_tpu.train.step import init_train_state
from deepmetv2_tpu_torch.config import Config, DataConfig, DRNConfig
from deepmetv2_tpu_torch.config import GraphConfig
from deepmetv2_tpu_torch.data import collate, synthetic_events
from deepmetv2_tpu_torch.data.batching import to_device
from deepmetv2_tpu_torch.data.sorting import cell_sort_batch, required_halo
from deepmetv2_tpu_torch.models.drn import DRN
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.train import step as tstep
from tests.torch_mesh_worker import REPO, run_ranks
from tests.torch_threads import few_torch_threads  # noqa: F401

LOSS_RTOL, PARAM_ATOL, EVAL_ATOL = 1e-5, 1e-5, 1e-5


def _np_trees(params, bn_state):
    return jax.tree_util.tree_map(np.asarray, (params, bn_state))


def noise_path(path) -> bool:
    """A bias whose exact gradient is 0, or about 0, because a masked
    BatchNorm follows it (directly, or through an ELU on its positive
    side): GraphMET's EdgeConv biases and ``encode_all``'s, the DRN's last
    edge-MLP biases, and the running means of those BatchNorms, which
    track them.  AdamW turns their f32 rounding noise, which the mesh sums
    in another order, into steps of up to lr of either sign."""
    return (path[1:2] == ("encode_all",) and path[-1] == "b"
            or path[1:3] == ("bn_all", 0)
            or path[1] == "convs" and (path[3:] in (("edge", "b"), (0,))
                                       or path[3:] == ("mlp", "lin1", "b")))


def _assert_same_state(state, model, n_steps, lr=1e-3):
    """``state`` ({JAX path: numpy}) against ``model``: within PARAM_ATOL
    of each tensor's largest value; the ``noise_path`` tensors to 2·lr per
    step (the rule of tests/test_torch_train.py)."""
    for path, ref in model.jax_layout():
        ref = ref.detach().numpy()
        noise = noise_path(path)
        atol = (2 * lr * n_steps if noise
                else PARAM_ATOL * max(float(np.abs(ref).max()), 1.0))
        np.testing.assert_allclose(state[path], ref, rtol=0, atol=atol,
                                   err_msg=str(path))


def _ranks_agree(outs):
    for out in outs[1:]:
        assert out["losses"] == outs[0]["losses"]
        for k, v in out["state"].items():
            np.testing.assert_array_equal(v, outs[0]["state"][k])


def _jax_dp_steps(jcfg, params, bn_state, batches, n_data, drn=False):
    mesh = make_mesh(n_data=n_data)
    state = init_train_state(params, bn_state, jcfg)
    losses = []
    with mesh:
        step = (make_drn_dp_train_step(jcfg, mesh) if drn
                else make_dp_train_step(jcfg, mesh))
        for b in batches:
            state, loss = step(state, shard_batch(JBatch(*b), mesh))
            losses.append(float(loss))
    return state, losses


def _window_batches(n, B=8, seed=0, N=128):
    """``n`` cell-sorted batches of ``B`` events of 20-100 candidates."""
    return [cell_sort_batch(collate(synthetic_events(
        B, seed=seed + i, n_min=20, n_max=100), buckets=(N,)), r=0.4)
        for i in range(n)]


@pytest.mark.parametrize("world", [2, 4])
def test_dp_steps_match_jax(world, tmp_path):
    """Two data-parallel GraphMET steps (window mode, cell-sorted batches:
    the window kernels' plain versions on every rank) against the JAX
    package's DP step on 8 virtual devices and the port's single-device
    step."""
    batches = _window_batches(2)
    halo = max(64, -(-max(required_halo(b, 0.4) for b in batches) // 64)
               * 64)
    g = dict(mode="window", window_halo=halo, presorted=True)
    jcfg = JConfig(graph=JGraphConfig(**g), data=JDataConfig(
        batch_size=8, node_buckets=(128,)))
    tcfg = Config(graph=GraphConfig(**g), data=DataConfig(
        batch_size=8, node_buckets=(128,)))
    params, bn_state = j_init(jax.random.PRNGKey(0))
    trees = _np_trees(params, bn_state)   # the JAX step donates its state
    outs = run_ranks("train", dict(cfg=tcfg.to_json(), params=trees,
                                   batches=[tuple(b) for b in batches],
                                   mesh=(world, 1)), world, str(tmp_path))
    _ranks_agree(outs)
    state, jlosses = _jax_dp_steps(jcfg, params, bn_state, batches, 8)
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=LOSS_RTOL)
    _assert_same_state(outs[0]["state"], GraphMET().params_from_jax(
        state.params, state.bn_state), 2)
    # the port's own single-device steps
    model = GraphMET(tcfg.model).params_from_jax(*trees)
    opt = tstep.make_optimizer(tcfg, model)
    step = tstep.make_train_step(tcfg)
    single = [float(step(model, opt, to_device(b, "cpu"))) for b in batches]
    np.testing.assert_allclose(outs[0]["losses"], single, rtol=LOSS_RTOL)
    _assert_same_state(outs[0]["state"], model, 2)


def test_drn_dp_steps_match_jax(tmp_path):
    """Two data-parallel DRN steps on 2 ranks (the composed graph build and
    the gather-reduce conv, the JAX mesh path) against the JAX package's
    DRN DP step on 4 virtual devices (tests/test_parallel.py's batch)."""
    events = synthetic_events(16, seed=5, n_min=20, n_max=60)
    batches = [collate(events[:8], buckets=(64,), pad_events_to=8),
               collate(events[8:], buckets=(64,), pad_events_to=8)]
    jcfg = JConfig(drn=JDRNConfig(hidden_dim=16, k=4),
                   data=JDataConfig(batch_size=8, node_buckets=(64,)))
    tcfg = Config(drn=DRNConfig(hidden_dim=16, k=4),
                  data=DataConfig(batch_size=8, node_buckets=(64,)))
    params, bn_state = j_drn_init(jax.random.PRNGKey(2), jcfg.drn)
    outs = run_ranks("train", dict(cfg=tcfg.to_json(), family="drn",
                                   params=_np_trees(params, bn_state),
                                   batches=[tuple(b) for b in batches],
                                   mesh=(2, 1)), 2, str(tmp_path))
    _ranks_agree(outs)
    state, jlosses = _jax_dp_steps(jcfg, params, bn_state, batches, 4,
                                   drn=True)
    np.testing.assert_allclose(outs[0]["losses"], jlosses, rtol=LOSS_RTOL)
    _assert_same_state(outs[0]["state"], DRN(tcfg.drn).params_from_jax(
        state.params, state.bn_state), 2)


@pytest.mark.parametrize("family", ["graphmet", "drn"])
def test_dp_eval_pads_an_odd_batch_and_matches_jax(family, tmp_path):
    """6 events on a 4-wide data axis: padded to 8 with empty events, the
    loss and the weights (GraphMET) or MET vectors (DRN) those of the JAX
    package's make_sharded_eval on the same mesh width."""
    if family == "drn":
        events = synthetic_events(6, seed=5, n_min=20, n_max=60)
        batch = collate(events, buckets=(64,))
        jcfg = JConfig(drn=JDRNConfig(hidden_dim=16, k=4))
        tcfg = Config(drn=DRNConfig(hidden_dim=16, k=4))
        params, bn_state = j_drn_init(jax.random.PRNGKey(3), jcfg.drn)
    else:
        events = synthetic_events(6, seed=0, n_min=20, n_max=100)
        batch = collate(events, buckets=(128,))
        g = dict(mode="window", window_halo=64)
        jcfg = JConfig(graph=JGraphConfig(**g))
        tcfg = Config(graph=GraphConfig(**g))
        params, bn_state = j_init(jax.random.PRNGKey(5))
    outs = run_ranks("eval", dict(cfg=tcfg.to_json(), family=family,
                                  params=_np_trees(params, bn_state),
                                  batches=[tuple(batch)], mesh=(4, 1)),
                     4, str(tmp_path))
    mesh = make_mesh(n_data=4)
    jstep, _ = make_sharded_eval(jcfg, mesh, model=family)
    jw, jloss, _ = jstep(params, bn_state, JBatch(*batch))
    got = outs[0][0]
    assert got["padded_to"] == 8
    for out in outs[1:]:
        np.testing.assert_array_equal(out[0]["v_met"], got["v_met"])
    np.testing.assert_allclose(got["loss"], float(jloss), rtol=LOSS_RTOL)
    want = np.asarray(jw)[:6]
    if family == "graphmet":
        np.testing.assert_allclose(got["w"][:6], want, rtol=0,
                                   atol=EVAL_ATOL)
        assert not got["w"][6:].any()
    else:
        np.testing.assert_allclose(got["v_met"][:6], want, rtol=1e-5,
                                   atol=EVAL_ATOL * np.abs(want).max())


def _multihost_case():
    """tests/test_multihost.py's global batch and configuration."""
    events = synthetic_events(8, seed=7, n_min=32, n_max=127)
    batch = collate(events, buckets=(128,), pad_events_to=8)
    cfg = dict(graph=dict(max_neighbors=32),
               data=dict(batch_size=8, node_buckets=(128,)))
    return batch, cfg


def test_two_process_cluster_matches_single_process(tmp_path):
    """Two ranks, each feeding only its own 4 events
    (``local_batch_to_global``), two DP steps: both ranks see the same
    losses, which are those of the port's single process over the global
    batch and of the JAX package's (tests/test_multihost.py)."""
    from tests.test_multihost import _single_process_losses

    batch, kw = _multihost_case()
    tcfg = Config(graph=GraphConfig(**kw["graph"]),
                  data=DataConfig(**kw["data"]))
    trees = _np_trees(*j_init(jax.random.PRNGKey(0)))
    outs = run_ranks("train", dict(cfg=tcfg.to_json(), local=True,
                                   params=trees,
                                   batches=[tuple(batch)] * 2, mesh=(2, 1)),
                     2, str(tmp_path))
    _ranks_agree(outs)
    assert [o["primary"] for o in outs] == [True, False]
    model = GraphMET(tcfg.model).params_from_jax(*trees)
    opt = tstep.make_optimizer(tcfg, model)
    step = tstep.make_train_step(tcfg)
    single = [float(step(model, opt, to_device(batch, "cpu")))
              for _ in range(2)]
    np.testing.assert_allclose(outs[0]["losses"], single, rtol=LOSS_RTOL)
    np.testing.assert_allclose(outs[0]["losses"], _single_process_losses(),
                               rtol=LOSS_RTOL)


def test_world_of_one_is_the_single_device_step(tmp_path):
    """A 1x1 mesh (gloo, in this process) runs the single-device step's
    arithmetic: losses, parameters and buffers bitwise over 3 steps."""
    from torch import distributed as dist

    from deepmetv2_tpu_torch.parallel import multihost
    from deepmetv2_tpu_torch.parallel.dp import make_dp_train_step
    from deepmetv2_tpu_torch.parallel.mesh import Mesh

    batches = _window_batches(3, B=4, seed=20)
    tcfg = Config(graph=GraphConfig(mode="window", window_halo=128,
                                    presorted=True))
    gen = torch.Generator().manual_seed(0)
    models = [GraphMET(tcfg.model, generator=gen)]
    models.append(GraphMET(tcfg.model).params_from_jax(
        *models[0].params_to_jax()))
    opts = [tstep.make_optimizer(tcfg, m) for m in models]
    multihost.initialize("gloo", "file://" + str(tmp_path / "store"), 1, 0)
    try:
        mesh = Mesh(1, 1)
        steps = [tstep.make_train_step(tcfg), make_dp_train_step(tcfg, mesh)]
        losses = [[float(s(m, o, to_device(b, "cpu"))) for b in batches]
                  for s, m, o in zip(steps, models, opts)]
    finally:
        dist.destroy_process_group()
    assert losses[0] == losses[1]
    for (path, a), (_, b) in zip(models[0].jax_layout(),
                                 models[1].jax_layout()):
        assert torch.equal(a, b), path


def _fit_spec(tmp_path, family, mesh):
    if family == "drn":
        events = synthetic_events(16, seed=8, n_min=20, n_max=60)
        cfg = Config(drn=DRNConfig(hidden_dim=16, k=4, head="cartesian",
                                   output_scale=100.0),
                     data=DataConfig(batch_size=4, node_buckets=(64,)))
        params = _np_trees(*j_drn_init(jax.random.PRNGKey(6), JDRNConfig(
            hidden_dim=16, k=4, head="cartesian", output_scale=100.0)))
        buckets = (64,)
    elif mesh[1] > 1:       # tests/test_parallel.py's EP fit
        events = synthetic_events(8, seed=4, n_min=150, n_max=255)
        cfg = Config(graph=GraphConfig(mode="window", window_halo=64,
                                       presorted=True),
                     data=DataConfig(batch_size=2, node_buckets=(256,)))
        params = _np_trees(*j_init(jax.random.PRNGKey(1)))
        buckets = (256,)
    else:
        events = synthetic_events(16, seed=7, n_min=20, n_max=100)
        cfg = Config(graph=GraphConfig(mode="window", window_halo=64,
                                       presorted=True),
                     data=DataConfig(batch_size=4, node_buckets=(128,)))
        params = _np_trees(*j_init(jax.random.PRNGKey(0)))
        buckets = (128,)
    presort = family == "graphmet"
    loader = dict(batch_size=cfg.data.batch_size, validation_split=0.25,
                  buckets=buckets, presort_eta=presort,
                  presort_mode="eta" if mesh[1] > 1 else "cell")
    return events, loader, dict(
        cfg=cfg.to_json(), family=family, params=params, events=events,
        loader=loader, halo_from_loaders=presort, mesh=mesh, epochs=1,
        ckpts=str(tmp_path / "ckpts"))


@pytest.mark.parametrize("family,mesh", [("graphmet", (2, 1)),
                                         ("graphmet", (1, 2)),
                                         ("drn", (2, 1))],
                         ids=["dp", "ep", "drn_dp"])
def test_fit_on_a_mesh(family, mesh, tmp_path):
    """``fit`` on DP and EP meshes (tests/test_parallel.py's TestFitWithMesh
    and the DRN's): every rank ends with the same model, rank 0 writes the
    artifacts, and the validation loss it wrote is the port's
    single-device evaluation of that model."""
    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint
    from deepmetv2_tpu_torch.train.loop import evaluate

    events, loader, spec = _fit_spec(tmp_path, family, mesh)
    world = mesh[0] * mesh[1]
    outs = run_ranks("fit", spec, world, str(tmp_path / "run"))
    for out in outs[1:]:
        for k, v in out["state"].items():
            np.testing.assert_array_equal(v, outs[0]["state"][k])
    ck = spec["ckpts"]
    for f in ("last.ckpt", "best.ckpt", "loss.log", "config.json",
              "metrics_val_last.json", "last.resolutions"):
        assert osp.exists(osp.join(ck, f)), f
    cfg = Config.from_json(spec["cfg"])
    if family == "graphmet":
        import dataclasses

        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
            cfg.graph, window_halo=outs[0]["halo"]))
        model, eval_step = GraphMET(cfg.model), tstep.make_eval_step(cfg)
    else:
        model, eval_step = DRN(cfg.drn), tstep.make_drn_eval_step(cfg)
    payload = load_checkpoint(osp.join(ck, "last.ckpt"))
    model.params_from_jax(payload["params"], payload["bn_state"])
    for path, t in model.jax_layout():
        np.testing.assert_array_equal(t.detach().numpy(),
                                      outs[0]["state"][path])
    single, _ = evaluate(model, eval_step,
                         fetch_dataloader(events=events, **loader)["test"],
                         cfg, "cpu", verbose=False)
    with open(osp.join(ck, "metrics_val_last.json")) as f:
        assert np.isclose(json.load(f)["loss"], single["loss"],
                          rtol=LOSS_RTOL)


@pytest.mark.parametrize("mesh", ["2", "1x2"])
def test_train_cli_mesh_runs(mesh, tmp_path):
    """``cli.train --mesh`` spawns its ranks itself: the mesh and feed
    lines, one epoch's artifacts, and each rank's kernel launches (none on
    the CPU)."""
    ck = str(tmp_path / "ck")
    r = subprocess.run(
        [sys.executable, "-m", "deepmetv2_tpu_torch.cli.train", "--synthetic",
         "16", "--batch_size", "4", "--epochs", "1", "--ckpts", ck,
         "--device", "cpu", "--mesh", mesh], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    ep = mesh == "1x2"
    assert ("mesh: " + ("1 data x 2 node" if ep else "2 data x 1 node")
            + " over 2 ranks, backend gloo, collectives on the CPU"
            + (" (edge-partitioned)" if ep else "")) in lines
    assert "feed: resident, chain 8, eager (mesh)" in lines
    assert any(ln.startswith("graph mode: window (halo ")
               and ln.endswith("order eta)" if ep else "order cell)")
               for ln in lines)
    counts = json.loads([ln for ln in lines if ln.startswith(
        "launches by rank:")][0].split(":", 1)[1])
    assert len(counts) == 2 and not any(sum(c.values()) for c in counts)
    assert osp.exists(osp.join(ck, "best.ckpt"))


@pytest.mark.parametrize("argv,message", [
    (["--mesh", "1x2", "--ring_knn"], "--ring_knn requires --model drn"),
    (["--mesh", "3"], "not divisible by data axis 3"),
    (["--mesh", "1x3"], "not divisible by node axis 3"),
    (["--mesh", "2x"], "expected 'D' or 'DxN'"),
    (["--mesh", "1x2", "--graph_mode", "neighbor_list"], "window mode"),
])
def test_train_cli_mesh_refusals(argv, message, tmp_path):
    from deepmetv2_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--synthetic", "8", "--batch_size", "4", "--ckpts",
                        str(tmp_path), "--device", "cpu"] + argv)
    assert message in str(exc.value.code)


def test_train_cli_mesh_failed_rank_exits_nonzero(tmp_path):
    """A rank that fails (here: no data where --data points) fails the
    spawned run, which exits non-zero naming the rank."""
    from deepmetv2_tpu_torch.cli import train as train_cli

    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--data", str(tmp_path / "none"), "--batch_size",
                        "4", "--ckpts", str(tmp_path / "ck"), "--device",
                        "cpu", "--mesh", "2"])
    assert exc.value.code not in (0, None)
    assert "--mesh 2: rank" in str(exc.value.code)
    assert "no npz slices" in str(exc.value.code)


def test_rank_worker_imports_no_jax():
    """The rank processes, and the port's modules they and the mesh paths
    reach, never import JAX or the JAX package."""
    port = osp.join(REPO, "deepmetv2_tpu_torch")
    for path in [osp.join(REPO, "tests", "torch_mesh_worker.py")] + [
            osp.join(port, f) for f in (
                "parallel/collectives.py", "parallel/knn.py",
                "parallel/dyn.py", "utils/profiling.py",
                "plotting/__init__.py", "plotting/resolution.py",
                "plotting/weights.py", "cli/plot.py", "cli/plot_weight.py")]:
        tree = ast.parse(open(path).read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
        mods += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in mods if m.split(".")[0] in (
            "jax", "deepmetv2_tpu")], path
