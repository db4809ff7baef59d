"""Training CLI (reference train.py:62-145; the JAX package's
``cli/train.py``):

    python -m deepmetv2_tpu_torch.cli.train --data data_dytt --ckpts ckpts_dytt
    python -m deepmetv2_tpu_torch.cli.train --synthetic 2000 --batch_size 8 \\
        --ckpts ckpts_port [--restore_file last] [--device cpu]
    python -m deepmetv2_tpu_torch.cli.train --model drn --drn_head cartesian \\
        --synthetic 2000 --batch_size 16 --grad_clip 10 --plateau_patience 10 \\
        --bn_refresh 30 --ckpts ckpts_drn [--restore_file last] [--device cpu]
    python -m deepmetv2_tpu_torch.cli.train --model particlenet \
        --synthetic 2000 --batch_size 16 --ckpts ckpts_pn [--device cpu]

GraphMET in window mode: the loaders presort each batch on the host (cell
order by default), the halo is sized from the order they emit.  GraphMET
with ``--graph_mode neighbor_list``: no presort; each step builds the
radius graph's lists (capped at 256, self-loops).  The DRN (``--model
drn``): no presort (it builds its own graphs), ``datanorm`` set to 1/std
of each feature over the training candidates and the output scale to the
training set's mean |genMET|, as the JAX CLI does.  ParticleNet (``--model
particlenet``, the port's own family, one device): no presort, its output
scale the training set's mean |genMET|.  AdamW with the plateau
scheduler trains either on one device, through the config's feed (chains
of ``chain_steps`` = 8 steps as CUDA graph replays, the epoch resident on
the device; the line "feed: ..." names it), as the JAX CLI has no flag
for it; ``--restore_file`` resumes from a checkpoint of either package,
``--from_torch`` warm-starts GraphMET from a reference ``.pth.tar``;
``--compute_dtype bfloat16`` runs GraphMET's EdgeConvs in bf16 and is
recorded in ``config.json``.

``--mesh D`` trains data parallel over D ranks, ``--mesh DxN`` over
D×N ranks with each event's nodes split N ways: GraphMET edge-partitioned
with the halo exchange, the DRN node-sharded (parallel/dyn.py; its kNN
graph by the all-gather build, or with ``--ring_knn`` the ring build);
the batch size must divide by D and the node buckets by N, and the host
sort defaults to eta order for GraphMET's DxN runs.  Not under torchrun,
the CLI spawns its D·N ranks itself (``--mesh 1`` runs its one rank
in-process); under torchrun (RANK, WORLD_SIZE, MASTER_ADDR in the
environment) each process is one rank.  Each rank gets a card of its own
where there are enough (NCCL), else all share the requested one (gloo,
collectives staged through host copies), or the CPU (gloo); the "mesh:"
line says which.  Mesh chains are eager steps.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile

import torch

from deepmetv2_tpu_torch.cli.common import (apply_graph_mode,
                                            check_from_torch,
                                            graph_mode_line, resolve_device)
from deepmetv2_tpu_torch.config import Config, DataConfig
from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
from deepmetv2_tpu_torch.parallel import multihost
from deepmetv2_tpu_torch.train.family import DEFAULT, FAMILIES
from deepmetv2_tpu_torch.train.loop import feed_line, fit
from deepmetv2_tpu_torch.train.step import make_optimizer
from deepmetv2_tpu_torch.utils.cache import enable_compilation_cache


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_file", default=None,
                   help="checkpoint stem in --ckpts to resume from "
                        "('best' or 'last')")
    p.add_argument("--data", default="data", help="data folder (npz slices)")
    p.add_argument("--ckpts", default="ckpts", help="checkpoint folder")
    p.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N generated events instead of --data")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0, help="model init seed")
    p.add_argument("--grad_clip", type=float, default=None,
                   help="global-norm gradient clipping (default: off, "
                        "matching the reference)")
    p.add_argument("--plateau_patience", type=int, default=None,
                   help="ReduceLROnPlateau patience in epochs (default 500, "
                        "the reference's setting)")
    p.add_argument("--bn_refresh", type=int, default=None, metavar="M",
                   help="refresh BatchNorm running statistics with M "
                        "training batches before each validation pass")
    p.add_argument("--mode", choices=["sequential", "bucketed"],
                   default="sequential", help="batching mode")
    p.add_argument("--sort_mode", choices=["cell", "eta"], default=None,
                   help="window-mode row order: 'cell' (eta-quantile "
                        "blocks x phi; default) or 'eta'")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--model", choices=list(FAMILIES), default=DEFAULT,
                   help="model family: the weight regressor GraphMET, the "
                        "DynamicReductionNetwork or ParticleNet")
    p.add_argument("--drn_aggr", choices=["add", "max", "mean"], default=None,
                   help="DRN EdgeConv aggregation (default add)")
    p.add_argument("--drn_head", choices=["polar", "cartesian"], default=None,
                   help="DRN output head (default polar)")
    p.add_argument("--graph_mode", choices=["window", "neighbor_list"],
                   default="window",
                   help="'window': implicit sorted-order radius graph (the "
                        "window kernels); 'neighbor_list': explicit lists "
                        "capped at the nearest 256 (reference train.py:48)")
    p.add_argument("--from_torch", default=None,
                   help="warm-start from a reference .pth.tar checkpoint")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="EdgeConv precision (ModelConfig.compute_dtype): "
                        "bfloat16 runs the conv GEMMs on bf16 operands with "
                        "float32 sums and the window max on bf16 values; "
                        "positions and adjacency stay float32")
    p.add_argument("--mesh", default=None, metavar="DxN",
                   help="train over a mesh of ranks: 'D' data parallel over "
                        "D ranks, 'DxN' data x node (GraphMET "
                        "edge-partitioned in window mode with halo exchange, "
                        "the DRN node-sharded), e.g. --mesh 2 or --mesh "
                        "1x2; batch_size must divide by D, node buckets by N")
    p.add_argument("--ring_knn", action="store_true",
                   help="node-sharded DRN runs (--model drn --mesh DxN): "
                        "build each round's kNN graph with the ring "
                        "top-k instead of the all-gather build; the build "
                        "holds O(B*n_loc*(D+k)) per rank, but the rest of "
                        "the round (lists, conv, matching, pooling) still "
                        "holds the whole node axis on every rank")
    return p


def parse_mesh(spec):
    """'D' or 'DxN' → (n_data, n_node), with a readable error on malformed
    values like '4x' or '2x4x1' (the JAX CLI's ``parse_mesh``)."""
    if not spec:
        return None
    parts = spec.lower().split("x")
    try:
        dims = [int(p) for p in parts]
    except ValueError:
        dims = []
    if not dims or len(dims) > 2 or any(d < 1 for d in dims):
        raise SystemExit(f"--mesh: expected 'D' or 'DxN' with positive "
                         f"integers (e.g. 4 or 2x4), got {spec!r}")
    return (dims[0], dims[1] if len(dims) > 1 else 1)


def check_flags(args):
    """Refuse flags that do not fit together and a mesh the batches do not
    divide over (the JAX CLI's checks, cli/train.py:194-198, 283-298);
    returns the mesh's (n_data, n_node) or None."""
    dims = parse_mesh(args.mesh)
    fam = FAMILIES[args.model]
    if args.ring_knn and not (fam.mesh and fam.mesh.ring_knn and dims
                              and dims[1] > 1):
        raise SystemExit("--ring_knn requires --model drn and a "
                         "node-sharded mesh (--mesh DxN, N > 1)")
    check_from_torch(args)
    if dims and fam.mesh is None:
        raise SystemExit(f"--mesh: --model {args.model} trains on one "
                         "device")
    if dims:
        n_data, n_node = dims
        if n_node > 1 and fam.presorts and args.graph_mode != "window":
            raise SystemExit(f"--mesh {args.mesh}: edge partitioning runs "
                             "window mode (--graph_mode window)")
        if args.batch_size % n_data:
            raise SystemExit(f"--mesh: batch_size {args.batch_size} not "
                             f"divisible by data axis {n_data}")
        bad = [b for b in DataConfig().node_buckets if b % n_node]
        if bad:
            raise SystemExit(f"--mesh: node buckets {bad} not divisible by "
                             f"node axis {n_node}")
    return dims


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dims = check_flags(args)
    if dims is None:
        return run(args, resolve_device(args.device))
    if multihost.from_environment():
        rank, world, _ = multihost.environment_rank()
        if world != dims[0] * dims[1]:
            raise SystemExit(f"--mesh {args.mesh} needs {dims[0] * dims[1]} "
                             f"processes; the launcher started {world}")
        return run_rank(args, dims, rank, None)
    world = dims[0] * dims[1]
    store = tempfile.mkdtemp(prefix="deepmet_mesh_")
    init = "file://" + os.path.join(store, "store")
    try:
        if world == 1:
            return run_rank(args, dims, 0, init)
        torch.multiprocessing.start_processes(
            _spawned_rank, args=(args, dims, init), nprocs=world,
            start_method="spawn")
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException) as e:
        raise SystemExit(f"--mesh {args.mesh}: rank {e.error_index} "
                         f"failed:\n{e}") from e
    finally:
        shutil.rmtree(store, ignore_errors=True)
    return 0


def _spawned_rank(rank: int, args, dims, init: str) -> None:
    """A rank the CLI spawned: at most its share of the CPU's threads."""
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (dims[0] * dims[1])))
    run_rank(args, dims, rank, init)


def run_rank(args, dims, rank: int, init) -> int:
    """One rank of a mesh run: its device (``multihost.rank_devices``), the
    process group on the backend those devices ask for, the mesh, then
    ``run``; the group is torn down at the end."""
    from torch import distributed as dist

    from deepmetv2_tpu_torch.parallel.mesh import Mesh

    device = resolve_device(args.device)
    world = dims[0] * dims[1]
    local = int(os.environ.get("LOCAL_RANK", rank))
    devices = multihost.rank_devices(
        device, int(os.environ.get("LOCAL_WORLD_SIZE", world)))
    multihost.initialize(multihost.backend_for(devices), init, world, rank,
                         devices[local])
    try:
        return run(args, devices[local], Mesh(*dims, device=devices[local]))
    finally:
        dist.destroy_process_group()


def run(args, device, mesh=None) -> int:
    """Build the config, loaders and model from ``args`` and train, on
    ``device``, on a ``mesh`` rank where one is given (only rank 0 prints,
    and it prints each rank's kernel launches at the end)."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    enable_compilation_cache()
    shard_nodes = mesh is not None and mesh.n_node > 1
    cfg = Config(data=DataConfig(batch_size=args.batch_size))
    optim = {k: v for k, v in (("lr", args.lr),
                               ("grad_clip_norm", args.grad_clip),
                               ("plateau_patience", args.plateau_patience))
             if v is not None}
    train = {k: v for k, v in (("epochs", args.epochs),
                               ("bn_refresh_batches", args.bn_refresh))
             if v is not None}
    drn = {k: v for k, v in (("aggr", args.drn_aggr),
                             ("head", args.drn_head)) if v is not None}
    if args.ring_knn:
        drn["ring_knn"] = True
    # recorded for either family, as the JAX CLI does (its DRN never reads it)
    dtype = {"compute_dtype": args.compute_dtype} if args.compute_dtype else {}
    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, **optim),
        train=dataclasses.replace(cfg.train, **train),
        drn=dataclasses.replace(cfg.drn, **drn),
        model=dataclasses.replace(cfg.model, **dtype))
    fam = FAMILIES[args.model]
    # A family that presorts (GraphMET), in window mode: the loaders
    # presort each batch once on the host (memoized) and the config is
    # marked presorted, so the steps never sort on the device.
    # neighbor_list mode needs no order, and the DRN and ParticleNet build
    # their own graphs: no presort.
    # Edge-partitioned runs sort in eta order by default, which keeps the
    # exchanged halo smallest (the JAX CLI's choice, cli/train.py:207-215).
    sort_mode = args.sort_mode or ("eta" if shard_nodes else "cell")
    if args.sort_mode == "cell" and shard_nodes and fam.presorts:
        say("note: cell-order edge partitioning exchanges the (wider) cell "
            "span as its halo; 'eta' minimizes the exchanged rows")
    presort = args.graph_mode == "window" and fam.presorts
    kw = dict(batch_size=cfg.data.batch_size,
              validation_split=cfg.data.validation_split,
              buckets=cfg.data.node_buckets, mode=args.mode,
              presort_eta=presort, presort_mode=sort_mode,
              presort_r=cfg.graph.delta_r)
    if args.synthetic:
        loaders = fetch_dataloader(events=synthetic_events(args.synthetic,
                                                           seed=42), **kw)
    else:
        loaders = fetch_dataloader(data_dir=args.data, **kw)
    cfg = apply_graph_mode(
        cfg, args, loaders["train"].dataset, presorted=presort,
        loaders=[loaders["train"], loaders["test"]] if presort else None)
    say(len(loaders["train"]), len(loaders["test"]))
    if cfg.graph.mode == "window":
        say(graph_mode_line(cfg, sort_mode if presort else "eta (device sort)",
                            train=loaders["train"], test=loaders["test"]))
    say("device:", device,
        torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    if mesh is not None:
        how = f" ({fam.mesh.node_form(cfg)})" if shard_nodes else ""
        say(f"mesh: {mesh.describe()}{how}")
        if cfg.model.compute_dtype != "float32":
            say(f"note: mesh steps compute float32 whatever compute_dtype "
                f"({cfg.model.compute_dtype}) says, as the JAX package's do")
    say(feed_line(cfg, device, mesh))

    gen = torch.Generator().manual_seed(args.seed)
    cfg, model = fam.init(cfg, loaders["train"], gen, say)
    if args.from_torch:
        from deepmetv2_tpu_torch.compat import import_torch_checkpoint

        params, bn_state, _ = import_torch_checkpoint(args.from_torch)
        model.params_from_jax(params, bn_state)
    model.to(device)
    optimizer = make_optimizer(cfg, model)
    fit(model, optimizer, cfg, loaders["train"], loaders["test"], args.ckpts,
        device, restore_file=args.restore_file, mesh=mesh,
        shard_nodes=shard_nodes)
    if mesh is not None:
        from torch import distributed as dist

        from deepmetv2_tpu_torch.ops.cuda import build

        counts = [None] * mesh.world
        dist.all_gather_object(counts, build.launch_counts())
        say("launches by rank:", json.dumps(counts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
