"""Checkpoints (the JAX package's ``train/checkpoint.py``; reference
utils.py:59-101).  A ``.ckpt`` is an lz4-frame pickle of ``{epoch, params,
bn_state, opt_state, step, sched_state, format_version}`` with numpy
leaves.  The port writes ``params``, ``bn_state`` and the AdamW moments in
the JAX package's pytree layout and ``opt_state`` in its own form
(models/graph_met.py:optimizer_state_to_jax); it reads checkpoints of
either package, JAX ones without JAX or optax (utils/artifacts)."""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, Optional

import torch

from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
from deepmetv2_tpu_torch.utils import artifacts


def save_checkpoint(model, optimizer: torch.optim.Optimizer,
                    scheduler: ReduceLROnPlateau, epoch: int, is_best: bool,
                    checkpoint_dir: str) -> str:
    """Write ``last.ckpt`` (or ``best.ckpt``) — reference utils.py:59-79."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = osp.join(checkpoint_dir, "best.ckpt" if is_best else "last.ckpt")
    params, bn_state = model.params_to_jax()
    opt_state = model.optimizer_state_to_jax(optimizer)
    artifacts.save({
        "epoch": int(epoch),
        "params": params,
        "bn_state": bn_state,
        "opt_state": opt_state,
        "step": opt_state["count"],
        "sched_state": scheduler.state_dict(),
        "format_version": 1,
    }, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint payload at ``path``."""
    if not osp.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return artifacts.load(path)


def restore_checkpoint(path: str, model,
                       optimizer: Optional[torch.optim.Optimizer] = None,
                       scheduler: Optional[ReduceLROnPlateau] = None
                       ) -> Dict[str, Any]:
    """Restore model, optimizer and scheduler from a ``.ckpt`` of either
    package (reference utils.py:82-101); returns the payload."""
    payload = load_checkpoint(path)
    model.params_from_jax(payload["params"], payload["bn_state"])
    if optimizer is not None:
        model.optimizer_state_from_jax(payload["opt_state"], optimizer)
    if scheduler is not None and payload.get("sched_state"):
        scheduler.load_state_dict(payload["sched_state"])
    return payload
