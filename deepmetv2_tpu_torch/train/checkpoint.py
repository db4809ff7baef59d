"""Checkpoint reading (the JAX package's ``train/checkpoint.py``; reference
utils.py:82-101).  A ``.ckpt`` is an lz4-frame pickle of ``{epoch, params,
bn_state, opt_state, step, sched_state, format_version}`` with numpy
leaves; JAX checkpoints read here without JAX or optax (utils/artifacts).
Writing checkpoints comes with the training slice."""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict

from deepmetv2_tpu_torch.utils import artifacts


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint payload at ``path``."""
    if not osp.exists(path):
        raise FileNotFoundError(f"checkpoint not found: {path}")
    return artifacts.load(path)
