"""Batch inference CLI — the serving surface:

    python -m deepmetv2_tpu_torch.cli.predict --ckpts ckpts \
        --restore_file best --data data_znunu --out predictions.npz \
        [--graph_mode neighbor_list] [--from_torch best.pth.tar]

Runs the model over ALL events (no split) and writes one npz with
``event_index, met_x, met_y, met, met_phi, n_valid`` per event, row i being
event i of the input:

  * graphmet: the −Σ wᵢpᵢ estimate (reference model/net.py:55-56) and the
    per-candidate ``weights`` (padded ``[n_events, n_max]``);
  * drn (``--model drn``): the head's cartesian MET estimate, no weights.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deepmetv2_tpu_torch.cli.common import (add_common_flags,
                                            apply_graph_mode,
                                            load_model_for_eval,
                                            load_run_config, resolve_device)
from deepmetv2_tpu_torch.data import fetch_dataloader, synthetic_events
from deepmetv2_tpu_torch.data.loader import device_feed


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_flags(p)
    p.add_argument("--out", default="predictions.npz")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_run_config(args.ckpts)
    if args.synthetic:
        loaders = fetch_dataloader(events=synthetic_events(args.synthetic,
                                                           seed=42),
                                   batch_size=args.batch_size,
                                   validation_split=0.0,
                                   buckets=cfg.data.node_buckets)
    else:
        loaders = fetch_dataloader(data_dir=args.data,
                                   batch_size=args.batch_size,
                                   validation_split=0.0,
                                   buckets=cfg.data.node_buckets)
    loader = loaders["train"]  # split 0.0 → all events, in seeded
    #                            permutation order (un-permuted below)
    cfg = apply_graph_mode(cfg, args, loader.dataset)
    model, eval_step = load_model_for_eval(args, cfg, args.ckpts, device)

    mets, weights, nvalids = [], [], []
    for batch in device_feed(loader, device):
        v_met, _, w = eval_step(model, batch)
        mets.append(v_met)
        if w is not None:
            weights.append(w.cpu().numpy())       # ragged buckets
        nvalids.append(batch.num_valid)

    met = torch.cat(mets).cpu().numpy()
    nv = torch.cat(nvalids).cpu().numpy()
    # batch padding (empty events) sits at the END of each batch_size-row
    # block, so its first len(batch_idx) rows are the real events
    real = np.zeros(len(nv), dtype=bool)
    row = 0
    for batch_idx in loader._batches:
        real[row: row + len(batch_idx)] = True
        row += loader.batch_size
    idx = np.concatenate(list(loader._batches))
    order = np.argsort(idx)   # row i of every output is input event i
    met = met[real][order]
    arrays = {
        "event_index": idx[order],
        "met_x": met[:, 0],
        "met_y": met[:, 1],
        "met": np.hypot(met[:, 0], met[:, 1]),
        "met_phi": np.arctan2(met[:, 1], met[:, 0]),
        "n_valid": nv[real][order],
    }
    if weights:
        n_max = max(w.shape[1] for w in weights)
        wpad = np.zeros((len(nv), n_max), np.float32)
        row = 0
        for w in weights:
            wpad[row:row + w.shape[0], : w.shape[1]] = w
            row += w.shape[0]
        arrays["weights"] = wpad[real][order]
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {int(real.sum())} events"
          + (", per-candidate weights included" if weights else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
