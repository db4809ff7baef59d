"""Training CLI (reference train.py:62-145; the JAX package's
``cli/train.py``):

    python -m deepmetv2_tpu_torch.cli.train --data data_dytt --ckpts ckpts_dytt
    python -m deepmetv2_tpu_torch.cli.train --synthetic 2000 --batch_size 8 \\
        --ckpts ckpts_port [--restore_file last] [--device cpu]
    python -m deepmetv2_tpu_torch.cli.train --model drn --drn_head cartesian \\
        --synthetic 2000 --batch_size 16 --grad_clip 10 --plateau_patience 10 \\
        --bn_refresh 30 --ckpts ckpts_drn [--restore_file last] [--device cpu]

GraphMET in window mode: the loaders presort each batch on the host (cell
order by default), the halo is sized from the order they emit.  GraphMET
with ``--graph_mode neighbor_list``: no presort; each step builds the
radius graph's lists (capped at 256, self-loops).  The DRN (``--model
drn``): no presort (it builds its own graphs), ``datanorm`` set to 1/std
of each feature over the training candidates and the output scale to the
training set's mean |genMET|, as the JAX CLI does.  AdamW with the plateau
scheduler trains either on one device, through the config's feed (chains
of ``chain_steps`` = 8 steps as CUDA graph replays, the epoch resident on
the device; the line "feed: ..." names it), as the JAX CLI has no flag
for it; ``--restore_file`` resumes from a checkpoint of either package,
``--from_torch`` warm-starts GraphMET from a reference ``.pth.tar``.  The
JAX flags of paths not ported yet are accepted and exit non-zero with "not
ported yet".
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from deepmetv2_tpu_torch.cli.common import (apply_graph_mode,
                                            check_from_torch, resolve_device)
from deepmetv2_tpu_torch.config import Config, DataConfig
from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
from deepmetv2_tpu_torch.models.drn import DRN
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.train.loop import feed_line, fit
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
    p.add_argument("--model", choices=["graphmet", "drn"], default="graphmet",
                   help="model family: the weight regressor GraphMET or the "
                        "DynamicReductionNetwork")
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
    # the JAX package's flags of paths that are not ported yet
    p.add_argument("--compute_dtype", choices=["float32", "bfloat16"],
                   default=None)
    p.add_argument("--mesh", default=None, metavar="DxN")
    p.add_argument("--ring_knn", action="store_true")
    return p


def unported(args) -> list:
    """The flags given that select a path the port does not have yet."""
    out = []
    if args.compute_dtype not in (None, "float32"):
        out.append(f"--compute_dtype {args.compute_dtype}")
    for flag in ("mesh", "ring_knn"):
        if getattr(args, flag):
            out.append(f"--{flag}")
    return out


def drn_data_init(dataset, indices):
    """``(norm, met_bias)`` from the training split, as the JAX CLI derives
    them (cli/train.py:246-277): ``norm`` 1/std of each input feature over
    every training candidate (one streaming float64 pass; 1 where the std
    is below 1e-6), ``met_bias`` the mean |genMET| of the training events
    (0 for an empty split)."""
    qts = [float(np.hypot(dataset[int(i)][1][0], dataset[int(i)][1][1]))
           for i in indices]
    met_bias = float(np.mean(qts)) if qts else 0.0
    n_feat = dataset[int(indices[0])][0].shape[1]
    cnt, s1, s2 = 0, np.zeros(n_feat), np.zeros(n_feat)
    for i in indices:
        x = dataset[int(i)][0]
        cnt += x.shape[0]
        s1 += x.sum(axis=0)
        s2 += (x.astype(np.float64) ** 2).sum(axis=0)
    var = np.maximum(s2 / cnt - (s1 / cnt) ** 2, 0.0)
    std = np.sqrt(var)
    return tuple(1.0 / np.where(std > 1e-6, std, 1.0)), met_bias


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    bad = unported(args)
    if bad:
        raise SystemExit(f"{', '.join(bad)}: not ported yet (the JAX package "
                         "deepmetv2_tpu.cli.train has it)")
    check_from_torch(args)
    device = resolve_device(args.device)

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
    cfg = dataclasses.replace(
        cfg, optim=dataclasses.replace(cfg.optim, **optim),
        train=dataclasses.replace(cfg.train, **train),
        drn=dataclasses.replace(cfg.drn, **drn))
    is_drn = args.model == "drn"
    if is_drn and cfg.drn.head == "polar":
        # the JAX CLI's warning (cli/train.py:181-189): on its 150-epoch
        # synthetic run the softplus MET went to 0 and the sigmoid phi to pi
        # within one epoch, and training froze
        print("warning: the polar DRN head saturates easily and can freeze "
              "training (softplus MET -> 0, sigmoid phi -> pi); "
              "--drn_head cartesian is the robust choice")

    # GraphMET in window mode: the loaders presort each batch once on the
    # host (memoized) and the config is marked presorted, so the steps never
    # sort on the device.  neighbor_list mode needs no order, and the DRN
    # builds its own graphs: no presort.
    sort_mode = args.sort_mode or "cell"
    presort = args.graph_mode == "window" and not is_drn
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
    print(len(loaders["train"]), len(loaders["test"]))
    if cfg.graph.mode == "window":
        print(f"graph mode: window (halo {cfg.graph.window_halo}, order "
              f"{sort_mode if presort else 'eta (device sort)'})")
    print("device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    print(feed_line(cfg, device))

    gen = torch.Generator().manual_seed(args.seed)
    if is_drn:
        norm, met_bias = drn_data_init(loaders["train"].dataset,
                                       loaders["train"].indices)
        if met_bias > 0:
            cfg = dataclasses.replace(
                cfg, drn=dataclasses.replace(cfg.drn, output_scale=met_bias))
        print(f"drn: output scale = mean |genMET| = {met_bias:.1f}; "
              f"datanorm from training-set feature stds")
        model = DRN(cfg.drn, generator=gen, norm=norm, met_bias=met_bias)
    else:
        model = GraphMET(cfg.model, generator=gen)
        if args.from_torch:
            from deepmetv2_tpu_torch.compat import import_torch_checkpoint

            params, bn_state, _ = import_torch_checkpoint(args.from_torch)
            model.params_from_jax(params, bn_state)
    model.to(device)
    optimizer = make_optimizer(cfg, model)
    fit(model, optimizer, cfg, loaders["train"], loaders["test"], args.ckpts,
        device, restore_file=args.restore_file)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
