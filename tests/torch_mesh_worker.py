"""Rank processes for the port's mesh tests (tests/test_torch_mesh.py,
tests/test_torch_halo.py): imports only the port, never JAX, as
tests/multihost_worker.py does for the JAX package.

``run_ranks(task, spec, world, workdir)`` writes ``spec`` (numpy arrays and
plain values) into ``workdir``, starts ``world`` processes

    python -m tests.torch_mesh_worker <task> <rank> <world> <workdir>

which join a gloo process group through a ``file://`` store in
``workdir`` (parallel test workers never race for a port), run
``TASKS[task](spec, rank, world)`` on the CPU with one thread, and write
its result; it returns each rank's result, in rank order, and raises with
a rank's output if any failed.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(task: str, spec: dict, world: int, workdir: str,
              timeout: float = 240.0) -> list:
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "spec.pkl"), "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_mesh_worker", task, str(r),
         str(world), workdir], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {task} failed:\n{out}"
    results = []
    for r in range(world):
        with open(os.path.join(workdir, f"out_{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ------------------------------------------------------------------ tasks


def _config(spec):
    from deepmetv2_tpu_torch.config import Config

    return Config.from_json(spec["cfg"])


def _model(spec, cfg):
    from deepmetv2_tpu_torch.models.drn import DRN
    from deepmetv2_tpu_torch.models.graph_met import GraphMET

    model = (DRN(cfg.drn) if spec.get("family") == "drn"
             else GraphMET(cfg.model))
    return model.params_from_jax(*spec["params"])


def _batch(fields):
    from deepmetv2_tpu_torch.data.batching import EventBatch

    return EventBatch(*(np.asarray(f) for f in fields))


def _state(model):
    """Every parameter and BatchNorm buffer, ``{JAX path: numpy}``."""
    return {path: t.detach().numpy().copy() for path, t in model.jax_layout()}


def train_task(spec, rank, world):
    """One mesh train step on each of ``spec['batches']``: the
    data-parallel step, or the edge-partitioned one when the mesh's node
    axis is > 1; each rank takes its slice of the global batch, or, with
    ``spec['local']``, feeds its own rows through
    ``local_batch_to_global``."""
    from deepmetv2_tpu_torch.data.batching import to_device
    from deepmetv2_tpu_torch.parallel import multihost
    from deepmetv2_tpu_torch.parallel.mesh import Mesh, shard_batch
    from deepmetv2_tpu_torch.train.chain import mesh_train_step
    from deepmetv2_tpu_torch.train.step import make_optimizer

    cfg = _config(spec)
    model = _model(spec, cfg)
    opt = make_optimizer(cfg, model)
    mesh = Mesh(*spec["mesh"])
    step = mesh_train_step(cfg, spec.get("family", "graphmet"), mesh,
                           shard_nodes=mesh.n_node > 1)
    losses = []
    for fields in spec["batches"]:
        b = _batch(fields)
        if spec.get("local"):
            rows = b.batch_size // world
            local = multihost.local_batch_to_global(
                _batch(f[rank * rows:(rank + 1) * rows] for f in b), mesh)
        else:
            local = to_device(shard_batch(b, mesh, mesh.n_node > 1), "cpu")
        losses.append(float(step(model, opt, local)))
    return {"losses": losses, "state": _state(model),
            "primary": multihost.is_primary()}


def eval_task(spec, rank, world):
    """The mesh evaluation step on each global batch: (v_met, loss,
    weights) on every rank."""
    from deepmetv2_tpu_torch.parallel.dp import make_sharded_eval
    from deepmetv2_tpu_torch.parallel.mesh import Mesh

    cfg = _config(spec)
    model = _model(spec, cfg)
    mesh = Mesh(*spec["mesh"])
    step, place = make_sharded_eval(cfg, mesh, spec.get("family", "graphmet"))
    out = []
    for fields in spec["batches"]:
        placed = place(_batch(fields))
        v, loss, w = step(model, placed)
        out.append({"v_met": v.numpy(), "loss": float(loss),
                    "w": None if w is None else w.numpy(),
                    "padded_to": placed.batch_size})
    return out


def window_task(spec, rank, world):
    """For each case: ``window_max_sharded`` on this rank's shard of c and
    pos and the gradient of ``Σ where(finite, m, 0)²`` with respect to c;
    or the refusal's message."""
    from deepmetv2_tpu_torch.parallel.halo import window_max_sharded
    from deepmetv2_tpu_torch.parallel.mesh import Mesh, shard_batch
    from deepmetv2_tpu_torch.data.batching import EventBatch

    out = []
    for case in spec["cases"]:
        mesh = Mesh(*case["mesh"])
        c_all, pos_all = case["c"], case["pos"]
        fake = EventBatch(c_all, pos_all, pos_all[..., 0], pos_all[:, 0],
                          pos_all[:, 0, 0])
        local = shard_batch(fake, mesh, shard_nodes=True)
        c = torch.tensor(local.x_cont, requires_grad=True)
        pos = torch.tensor(local.x_cat)
        try:
            m = window_max_sharded(c, pos, case["r2"], case["halo"], mesh,
                                   overlap=case["overlap"])
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        torch.where(torch.isfinite(m), m, torch.zeros_like(m)).pow(2).sum(
        ).backward()
        out.append({"m": m.detach().numpy(), "dc": c.grad.numpy()})
    return out


def exchange_task(spec, rank, world):
    """The halo exchange of this rank's shard, then ``Σ cl·wl + Σ cr·wr``
    with the rank's own weights, and its gradient with respect to c."""
    from deepmetv2_tpu_torch.parallel.collectives import HaloExchange
    from deepmetv2_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(1, world)
    h, n_loc = spec["h"], spec["c"].shape[1] // world
    c = torch.tensor(spec["c"][:, rank * n_loc:(rank + 1) * n_loc],
                     requires_grad=True)
    pos = torch.tensor(spec["pos"][:, rank * n_loc:(rank + 1) * n_loc])
    cl, cr, pl, pr = HaloExchange.apply(c, pos, h, mesh, None)
    wl, wr = (torch.tensor(spec[k][rank]) for k in ("wl", "wr"))
    ((cl * wl).sum() + (cr * wr).sum()).backward()
    return {"cl": cl.detach().numpy(), "cr": cr.detach().numpy(),
            "pl": pl.detach().numpy(), "pr": pr.detach().numpy(),
            "dc": c.grad.numpy()}


def fit_task(spec, rank, world):
    """``fit`` on a mesh over the spec's events; rank 0 writes into
    ``spec['ckpts']``."""
    import dataclasses

    from deepmetv2_tpu_torch.data import fetch_dataloader
    from deepmetv2_tpu_torch.parallel.mesh import Mesh
    from deepmetv2_tpu_torch.train.loop import fit
    from deepmetv2_tpu_torch.train.step import make_optimizer

    cfg = _config(spec)
    loaders = fetch_dataloader(events=spec["events"], **spec["loader"])
    if spec.get("halo_from_loaders"):
        halo = max(64, -(-max(ld.required_halo(cfg.graph.delta_r)
                              for ld in loaders.values()) // 64) * 64)
        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
            cfg.graph, window_halo=halo))
    model = _model(spec, cfg)
    mesh = Mesh(*spec["mesh"])
    fit(model, make_optimizer(cfg, model), cfg, loaders["train"],
        loaders["test"], spec["ckpts"], "cpu", epochs=spec["epochs"],
        verbose=False, mesh=mesh, shard_nodes=mesh.n_node > 1)
    return {"state": _state(model), "halo": cfg.graph.window_halo}


def _shard(a, mesh, nodes: bool = True):
    """This rank's events (axis 0) and, with ``nodes``, node shard (axis
    1) of ``a``."""
    rows = a.shape[0] // mesh.n_data
    a = a[mesh.data_index * rows:(mesh.data_index + 1) * rows]
    if nodes:
        n = a.shape[1] // mesh.n_node
        a = a[:, mesh.node_index * n:(mesh.node_index + 1) * n]
    return torch.tensor(np.ascontiguousarray(a))


def dyn_task(spec, rank, world):
    """The node-sharded DRN's cases: for each of ``spec['knn']`` both kNN
    builds on this rank's shard; for each of ``spec['forward']`` the
    sharded forward with its head in eval and train mode by each build
    (its output, and the BatchNorm buffers after the train-mode pass) and
    without it in eval mode (``raw``); each of ``spec['train']`` through
    ``train_task``."""
    from deepmetv2_tpu_torch.parallel.dyn import (drn_apply_sharded,
                                                  drn_net_apply_sharded)
    from deepmetv2_tpu_torch.parallel.knn import (knn_graph_sharded,
                                                  knn_graph_sharded_ring)
    from deepmetv2_tpu_torch.parallel.mesh import Mesh, shard_batch
    from deepmetv2_tpu_torch.data.batching import to_device

    meshes = {}

    def mesh_of(dims):          # every rank builds the same meshes in order
        dims = tuple(dims)
        if dims not in meshes:
            meshes[dims] = Mesh(*dims)
        return meshes[dims]

    out = {"knn": [], "forward": [], "train": []}
    for case in spec["knn"]:
        mesh = mesh_of(case["mesh"])
        x, m = _shard(case["x"], mesh), _shard(case["mask"], mesh)
        out["knn"].append({
            name: tuple(t.numpy() for t in build(x, m, k=case["k"],
                                                 mesh=mesh, loop=case["loop"]))
            for name, build in (("gather", knn_graph_sharded),
                                ("ring", knn_graph_sharded_ring))})
    for case in spec["forward"]:
        mesh = mesh_of(case["mesh"])
        cfg = _config(case)
        local = to_device(shard_batch(_batch(case["batch"]), mesh, True),
                          "cpu")
        res = {}
        for ring in (False, True):
            for train in (False, True):
                model = _model(case, cfg).train(train)
                with torch.set_grad_enabled(train):
                    pred = drn_net_apply_sharded(model, local, mesh, ring)
                res[ring, train] = {"pred": pred.detach().numpy(),
                                    "state": _state(model)}
        x = torch.cat([local.x_cont, local.x_cat.to(local.x_cont.dtype)], -1)
        with torch.no_grad():
            res["raw"] = drn_apply_sharded(_model(case, cfg).eval(), x,
                                           local.mask, mesh).numpy()
        out["forward"].append(res)
    for case in spec["train"]:
        out["train"].append(train_task(case, rank, world))
    return out


TASKS = {"train": train_task, "eval": eval_task, "window": window_task,
         "exchange": exchange_task, "fit": fit_task, "dyn": dyn_task}


def main(argv) -> None:
    task, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    torch.set_num_threads(1)
    with open(os.path.join(workdir, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    from torch import distributed as dist

    from deepmetv2_tpu_torch.parallel import multihost

    multihost.initialize("gloo", "file://" + os.path.join(workdir, "store"),
                         world, rank)
    try:
        out = TASKS[task](spec, rank, world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1:])
