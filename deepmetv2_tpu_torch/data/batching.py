"""Bucketed padded event batches (the JAX package's ``data/batching.py``).

Collation stays host numpy: every batch is a dense ``[B, Nmax, F]`` block
with a node ``mask``, ``Nmax`` drawn from a few capacity buckets.
``to_device`` is the feed: it moves one host batch onto a device as torch
tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.utils.profiling import annotate

# Feature order after ingest (reference model/data_loader.py:70-77):
#   continuous[0:8] = px, py, pt, eta, d0, dz, mass, puppiWeight
#   categorical[0:3] = pdgId, charge, fromPV
CONTINUOUS_DIM = 8
CATEGORICAL_DIM = 3
NUM_FEATURES = CONTINUOUS_DIM + CATEGORICAL_DIM  # 11
TARGET_DIM = 11


class EventBatch(NamedTuple):
    """A dense batch of padded events (numpy on the host, torch on a device).

    x_cont ``[B, N, 8]`` f32; x_cat ``[B, N, 3]`` int32 (pdgId, charge,
    fromPV); mask ``[B, N]`` bool; y ``[B, T]`` f32; num_valid ``[B]`` int32.
    """

    x_cont: object
    x_cat: object
    mask: object
    y: object
    num_valid: object

    @property
    def batch_size(self) -> int:
        return self.x_cont.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.x_cont.shape[1]


class Neighborhood(NamedTuple):
    """Fixed-degree neighbour lists of a padded batch: ``idx [B, N, K]``
    int32 and ``mask [B, N, K]`` bool, invalid slots at index 0."""

    idx: torch.Tensor
    mask: torch.Tensor


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest capacity bucket >= n (the largest if none holds it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def collate(
    events: Sequence[Tuple[np.ndarray, np.ndarray]],
    buckets: Sequence[int] = (128, 256, 512, 1024, 2048, 4096, 8192),
    pad_to: int | None = None,
    pad_events_to: int | None = None,
) -> EventBatch:
    """Pad ``(x [n_i, 11], y [T])`` events into one host EventBatch.
    ``pad_events_to`` appends empty events (``num_valid == 0``), which the
    loss and the metrics skip."""
    with annotate("data.collate"):
        assert len(events) > 0
        n_max = max(x.shape[0] for x, _ in events)
        cap = pad_to if pad_to is not None else bucket_for(n_max, buckets)
        B = max(len(events), pad_events_to or 0)
        t_dim = max(int(np.asarray(y).reshape(-1).shape[0]) for _, y in events)

        x_cont = np.zeros((B, cap, CONTINUOUS_DIM), dtype=np.float32)
        x_cat = np.zeros((B, cap, CATEGORICAL_DIM), dtype=np.int32)
        mask = np.zeros((B, cap), dtype=bool)
        ys = np.zeros((B, t_dim), dtype=np.float32)
        nv = np.zeros((B,), dtype=np.int32)

        for b, (x, y) in enumerate(events):
            n = min(x.shape[0], cap)
            x_cont[b, :n] = x[:n, :CONTINUOUS_DIM]
            x_cat[b, :n] = x[:n, CONTINUOUS_DIM:NUM_FEATURES].astype(np.int32)
            mask[b, :n] = True
            yv = np.asarray(y, dtype=np.float32).reshape(-1)
            ys[b, : yv.shape[0]] = yv
            nv[b] = n
        return EventBatch(x_cont=x_cont, x_cat=x_cat, mask=mask, y=ys,
                          num_valid=nv)


def pad_batch_events(batch: EventBatch, to: int) -> EventBatch:
    """Append empty events (``num_valid == 0``) up to ``to`` rows."""
    B = batch.batch_size
    if to <= B:
        return batch
    pad = to - B

    def padarr(a):
        a = np.asarray(a)
        return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))

    return EventBatch(*(padarr(f) for f in batch))


def to_device(batch: EventBatch, device) -> EventBatch:
    """Host batch → torch tensors on ``device`` (same dtypes)."""
    with annotate("data.to_device"):
        return EventBatch(*(torch.as_tensor(np.asarray(f)).to(device)
                            for f in batch))
