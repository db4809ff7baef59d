"""Standalone evaluation CLI (reference evaluate.py:167-219):

    python -m deepmetv2_tpu_torch.cli.evaluate --data data_dytt \
        --ckpts ckpts_dytt --restore_file best [--model drn] [--device cpu]
        [--graph_mode neighbor_list] [--from_torch best.pth.tar]

Loads a checkpoint (a native ``.ckpt``, or a reference ``.pth.tar`` with
``--from_torch``, which may name a fresh ``--ckpts`` directory for the
artifacts), runs the validation split, writes
``<restore_file>.resolutions`` into ``--ckpts`` and prints the validation
loss.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from deepmetv2_tpu_torch.cli.common import (add_common_flags,
                                            apply_graph_mode,
                                            load_model_for_eval,
                                            load_run_config, resolve_device)
from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
from deepmetv2_tpu_torch.train.loop import evaluate
from deepmetv2_tpu_torch.utils import artifacts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_flags(p)
    return p


def run(argv=None):
    """Parse ``argv``, evaluate, write the artifact; returns the metrics."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_run_config(args.ckpts)

    if args.synthetic:
        events = synthetic_events(args.synthetic, seed=42)
        loaders = fetch_dataloader(events=events, batch_size=args.batch_size,
                                   validation_split=0.2,
                                   buckets=cfg.data.node_buckets)
    else:
        loaders = fetch_dataloader(data_dir=args.data,
                                   batch_size=args.batch_size,
                                   validation_split=0.2,
                                   buckets=cfg.data.node_buckets)
    # the halo is sized on the WHOLE dataset, as the JAX CLI does
    cfg = apply_graph_mode(cfg, args, loaders["test"].dataset)

    os.makedirs(args.ckpts, exist_ok=True)   # a --from_torch run's may be new
    model, eval_step = load_model_for_eval(args, cfg, args.ckpts, device)
    test_metrics, resolutions = evaluate(model, eval_step, loaders["test"],
                                         cfg, device)
    artifacts.save(resolutions,
                   osp.join(args.ckpts, f"{args.restore_file}.resolutions"))
    print("validation loss:", test_metrics["loss"])
    return test_metrics


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
