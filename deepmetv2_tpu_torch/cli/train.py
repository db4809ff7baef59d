"""Training CLI (reference train.py:62-145; the JAX package's
``cli/train.py``):

    python -m deepmetv2_tpu_torch.cli.train --data data_dytt --ckpts ckpts_dytt
    python -m deepmetv2_tpu_torch.cli.train --synthetic 2000 --batch_size 8 \\
        --ckpts ckpts_port [--restore_file last] [--device cpu]

GraphMET in window mode: the loaders presort each batch on the host (cell
order by default), the halo is sized from the order they emit, and AdamW
with the plateau scheduler trains on one device.  ``--restore_file``
resumes from a checkpoint of either package.  The JAX flags of paths not
ported yet are accepted and exit non-zero with "not ported yet".
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from deepmetv2_tpu_torch.cli.common import apply_graph_mode, resolve_device
from deepmetv2_tpu_torch.config import Config, DataConfig
from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.train.loop import fit
from deepmetv2_tpu_torch.train.step import make_optimizer


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
    # the JAX package's flags of paths that are not ported yet
    p.add_argument("--model", choices=["graphmet", "drn"], default="graphmet")
    p.add_argument("--graph_mode", choices=["window", "neighbor_list"],
                   default="window")
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default=None)
    p.add_argument("--from_torch", default=None)
    p.add_argument("--mesh", default=None, metavar="DxN")
    p.add_argument("--ring_knn", action="store_true")
    p.add_argument("--drn_aggr", choices=["add", "max", "mean"], default=None)
    p.add_argument("--drn_head", choices=["polar", "cartesian"], default=None)
    return p


def unported(args) -> list:
    """The flags given that select a path the port does not have yet."""
    out = []
    if args.model != "graphmet":
        out.append(f"--model {args.model}")
    if args.graph_mode != "window":
        out.append(f"--graph_mode {args.graph_mode}")
    if args.compute_dtype not in (None, "float32"):
        out.append(f"--compute_dtype {args.compute_dtype}")
    for flag in ("from_torch", "mesh", "ring_knn", "drn_aggr", "drn_head"):
        if getattr(args, flag):
            out.append(f"--{flag}")
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bad = unported(args)
    if bad:
        raise SystemExit(f"{', '.join(bad)}: not ported yet (the JAX package "
                         "deepmetv2_tpu.cli.train has it)")
    device = resolve_device(args.device)

    cfg = Config(data=DataConfig(batch_size=args.batch_size))
    optim = {k: v for k, v in (("lr", args.lr),
                               ("grad_clip_norm", args.grad_clip),
                               ("plateau_patience", args.plateau_patience))
             if v is not None}
    train = {k: v for k, v in (("epochs", args.epochs),
                               ("bn_refresh_batches", args.bn_refresh))
             if v is not None}
    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, **optim),
        train=dataclasses.replace(cfg.train, **train))

    # the loaders presort each batch once on the host (memoized) and the
    # config is marked presorted, so the steps never sort on the device
    sort_mode = args.sort_mode or "cell"
    kw = dict(batch_size=cfg.data.batch_size,
              validation_split=cfg.data.validation_split,
              buckets=cfg.data.node_buckets, mode=args.mode,
              presort_eta=True, presort_mode=sort_mode,
              presort_r=cfg.graph.delta_r)
    if args.synthetic:
        loaders = fetch_dataloader(events=synthetic_events(args.synthetic,
                                                           seed=42), **kw)
    else:
        loaders = fetch_dataloader(data_dir=args.data, **kw)
    cfg = apply_graph_mode(cfg, args, loaders["train"].dataset,
                           presorted=True,
                           loaders=[loaders["train"], loaders["test"]])
    print(len(loaders["train"]), len(loaders["test"]))
    print(f"graph mode: window (halo {cfg.graph.window_halo}, "
          f"order {sort_mode})")
    print("device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")

    model = GraphMET(cfg.model,
                     generator=torch.Generator().manual_seed(args.seed))
    model.to(device)
    optimizer = make_optimizer(cfg, model)
    fit(model, optimizer, cfg, loaders["train"], loaders["test"], args.ckpts,
        device, restore_file=args.restore_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
