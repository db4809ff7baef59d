"""Learned-weight diagnostics CLI (the JAX package's
``cli/plot_weight.py``; reference plt_weight.py):

    python -m deepmetv2_tpu_torch.cli.plot_weight --ckpts ckpts \\
        --restore_file best --data data   (or --synthetic N) [--device cpu]

Runs GraphMET's evaluation step on the device (default cuda) over half of
the events (validation split 0.5, as the JAX CLI takes it), in the run
config's graph mode (the config's own, as the JAX CLI does), accumulates
the per-class weight histograms and qT spectra, and writes ``weight.plt``
(an lz4 pickle in the reference's layout, which the JAX package's
``artifacts.load`` reads) and five PNGs into ``--ckpts``.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch

from deepmetv2_tpu_torch.cli.common import (load_model_for_eval,
                                            load_run_config, resolve_device)
from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
from deepmetv2_tpu_torch.plotting import (compute_weight_summary,
                                          plot_weight_summary)
from deepmetv2_tpu_torch.train.family import DEFAULT, FAMILIES
from deepmetv2_tpu_torch.utils import artifacts


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--restore_file", default=None,
                   help="checkpoint stem in --ckpts ('best' or 'last'); "
                        "without it or --from_torch, an untrained model "
                        "(seed 0), as the JAX CLI does")
    p.add_argument("--data", default="data")
    p.add_argument("--ckpts", default="ckpts")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    p.add_argument("--batch_size", type=int, default=60)  # plt_weight.py:213
    p.add_argument("--from_torch", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
    p.set_defaults(model=DEFAULT)     # GraphMET: per-candidate weights
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = load_run_config(args.ckpts)
    kw = dict(batch_size=args.batch_size, validation_split=0.5,
              buckets=cfg.data.node_buckets)
    if args.synthetic:
        loaders = fetch_dataloader(
            events=synthetic_events(args.synthetic, seed=42), **kw)
    else:
        loaders = fetch_dataloader(data_dir=args.data, **kw)
    if args.restore_file or args.from_torch:
        model, eval_step = load_model_for_eval(args, cfg, args.ckpts, device)
    else:
        fam = FAMILIES[args.model]
        model = fam.build(cfg, device=device,
                          generator=torch.Generator().manual_seed(0)).eval()
        eval_step = fam.eval_step(cfg)
    summary = compute_weight_summary(eval_step, model, loaders["test"],
                                     device)
    # next to the checkpoints (the reference wrote weight.plt into the
    # working directory, plt_weight.py:205)
    os.makedirs(args.ckpts, exist_ok=True)
    dest = osp.join(args.ckpts, "weight.plt")
    artifacts.save(summary, dest)
    print("wrote", dest)
    for w in plot_weight_summary(summary, osp.join(args.ckpts, "weight_")):
        print("wrote", w)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
