"""Shared CLI plumbing for the train / evaluate / predict entry points
(the JAX package's ``cli/common.py``, plus ``apply_graph_mode`` from its
``cli/train.py``, which all three use)."""

from __future__ import annotations

import dataclasses
import os.path as osp
import sys

import torch

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.train.family import DEFAULT, FAMILIES


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on.  CUDA unless the caller asks for
    the CPU; a missing GPU is an error, never a silent CPU run.  TF32 is
    switched off for matmuls and convolutions: the JAX reference computes
    in full f32, and TF32 keeps about three decimal digits."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA GPU is available "
                         "(torch.cuda.is_available() is False); pass "
                         "--device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def load_run_config(ckpt_dir: str) -> Config:
    """Defaults with the model sections of the run's ``config.json`` (each
    family's) grafted in; graph and data sections are re-derived by each
    CLI from its own input."""
    path = osp.join(ckpt_dir, "config.json")
    if not osp.exists(path):
        print(f"note: no {path}; interpreting the checkpoint with DEFAULT "
              "model hyperparameters", file=sys.stderr)
        return Config()
    with open(path) as f:
        run = Config.from_json(f.read())
    return dataclasses.replace(Config(), **{
        f.section: getattr(run, f.section) for f in FAMILIES.values()})


def apply_graph_mode(cfg: Config, args, all_events, presorted: bool = False,
                     loaders=None) -> Config:
    """Resolve ``--graph_mode`` into the config.  neighbor_list mode leaves
    it as it is (the config's own graph section, whose mode is
    neighbor_list by default).  Window mode sizes the halo (the max
    neighbour span, rounded up to a multiple of 64, at least 64): with
    ``loaders``, on the row order they emit (needed for cell-sorted
    loaders); otherwise from ``all_events`` in eta order.  ``presorted``
    only when the loaders presort (``presort_eta=True``): the steps then
    trust the batch order and do not sort."""
    from deepmetv2_tpu_torch.data.sorting import required_halo_events

    if args.graph_mode != "window":
        return cfg
    spans = [ld.required_halo(cfg.graph.delta_r)
             for ld in (loaders or []) if len(ld)]
    halo = (max(spans) if spans
            else required_halo_events(all_events, cfg.graph.delta_r))
    halo = max(64, -(-halo // 64) * 64)
    return dataclasses.replace(
        cfg, graph=dataclasses.replace(cfg.graph, mode="window",
                                       window_halo=halo, presorted=presorted))


def graph_mode_line(cfg: Config, order: str, **loaders) -> str:
    """The "graph mode:" line of a window-mode run: the halo, the batches
    of each loader (by name) per node bucket, and the row order."""
    per = ", ".join(
        f"{name} " + (" ".join(f"{b}:{n}" for b, n in
                               ld.batches_per_bucket().items()) or "none")
        for name, ld in loaders.items())
    return (f"graph mode: window (halo {cfg.graph.window_halo}, batches per "
            f"bucket {per}, order {order})")


def check_from_torch(args) -> None:
    """``--from_torch`` reads GraphMETNetwork state_dicts only."""
    if args.from_torch and not FAMILIES[args.model].from_torch:
        raise SystemExit(
            "--from_torch checkpoints are GraphMETNetwork state_dicts "
            "(reference model/net.py:41-43); use --model graphmet")


def load_model_for_eval(args, cfg: Config, ckpt_dir: str, device):
    """(model, eval_step) of the family ``--model`` from a reference
    ``.pth.tar`` (``--from_torch``, GraphMET only) or a native ``.ckpt`` of
    either package."""
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint

    check_from_torch(args)
    if args.from_torch:
        from deepmetv2_tpu_torch.compat import import_torch_checkpoint

        params, bn_state, _ = import_torch_checkpoint(args.from_torch)
        payload = {"params": params, "bn_state": bn_state}
    else:
        payload = load_checkpoint(osp.join(ckpt_dir,
                                           args.restore_file + ".ckpt"))
    fam = FAMILIES[args.model]
    model, step = fam.build(cfg, device=device), fam.eval_step(cfg)
    model.params_from_jax(payload["params"], payload["bn_state"]).eval()
    return model, step


def add_common_flags(p) -> None:
    """The flags evaluate and predict share with the JAX package's CLIs,
    plus ``--device``."""
    p.add_argument("--restore_file", default="best")
    p.add_argument("--data", default="data")
    p.add_argument("--ckpts", default="ckpts")
    p.add_argument("--synthetic", type=int, default=0, metavar="N")
    p.add_argument("--batch_size", type=int, default=40)  # evaluate.py:176
    p.add_argument("--graph_mode", choices=["window", "neighbor_list"],
                   default="window")
    p.add_argument("--from_torch", default=None)
    p.add_argument("--model", choices=list(FAMILIES), default=DEFAULT)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch versions of the kernels)")
