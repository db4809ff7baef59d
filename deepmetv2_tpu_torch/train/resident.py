"""Device-resident epoch feed (the JAX package's ``train/resident.py``): the
training epoch is staged on the device once and replayed from there.

The reference copies every batch to the accelerator again in every epoch
(reference train.py:39-41).  The loaders here are unshuffled and memoized
(data/loader.PaddedLoader), so every epoch feeds the same batches: the
epoch is a constant, and a constant belongs in device memory.
:class:`ResidentFeed` stacks consecutive same-shape batches into chains
(train/chain.chain_batches), copies each stack to the device once, at the
first iteration, and yields the same device tensors in every epoch.  An
epoch larger than ``max_bytes`` streams through
``data/loader.prefetch_to_device`` instead, after one warning.

The JAX package trusts its caller not to wrap a shuffling loader (its
docstring says so); the port refuses any loader that does not promise to
replay the same batches (``replays_same_batches``).
"""

from __future__ import annotations

import warnings
from typing import Iterator, List, Optional, Tuple

import numpy as np

from deepmetv2_tpu_torch.data.batching import EventBatch, to_device
from deepmetv2_tpu_torch.data.loader import prefetch_to_device
from deepmetv2_tpu_torch.train.chain import chain_batches
from deepmetv2_tpu_torch.utils.profiling import annotate


def _nbytes(batch: EventBatch) -> int:
    return sum(f.nbytes for f in batch)


def stack_meta(stack: EventBatch, chained: bool) -> Tuple[int, int]:
    """``(steps, real nodes)`` of a host stack (a single batch unless
    ``chained``)."""
    k = np.shape(stack.x_cont)[0] if chained else 1
    return k, int(np.sum(stack.num_valid))


def recording(stacks, meta: List[Tuple[int, int]], chained: bool
              ) -> Iterator[EventBatch]:
    """``stacks`` unchanged, each one's ``stack_meta`` appended to ``meta``
    as it passes."""
    for s in stacks:
        meta.append(stack_meta(s, chained))
        yield s


class ResidentFeed:
    """Replay an epoch of (optionally chained) batches from device memory.

    Parameters:
      loader: host ``EventBatch``es that are the same in every epoch
        (``loader.replays_same_batches``, as data/loader.PaddedLoader
        promises); any other loader is refused.
      chain: stack up to this many consecutive same-shape batches per
        chain (1: single batches, no stacking).
      place: the device the stacks are staged on (default CUDA).
      shard: a host batch (or stack) → what this rank stages of it, on a
        mesh (its own rows, parallel/mesh.py:shard_batch, or the batch
        padded for evaluation); None stages the whole batch.
      max_bytes: device memory budget of the staged epoch; a larger epoch
        streams from the host instead, with a warning.

    ``meta`` (one list for the feed's life) holds one host-side ``(steps,
    real nodes)`` per stack (of the whole batch, before ``shard``), filled
    when the epoch is staged (or, when streaming, as it streams): progress
    accounting never reads staged tensors back.
    """

    def __init__(self, loader, chain: int = 1, place=None,
                 max_bytes: int = 4 << 30, shard=None):
        if not getattr(loader, "replays_same_batches", False):
            raise ValueError(
                f"ResidentFeed: {type(loader).__name__} does not promise to "
                "replay the same batches every epoch "
                "(replays_same_batches); a staged epoch would freeze one "
                "epoch's order")
        self._loader = loader
        self._chain = max(1, int(chain))
        self._place = place if place is not None else "cuda"
        self._max_bytes = max_bytes
        self._shard = shard or (lambda b: b)
        self._stacks: Optional[List[EventBatch]] = None
        self._streaming = False
        self.meta: List[Tuple[int, int]] = []

    def _host_stacks(self) -> Iterator[EventBatch]:
        return chain_batches(iter(self._loader), self._chain)

    def _stage(self) -> None:
        stacks, meta, total = [], [], 0
        for s in self._host_stacks():
            meta.append(stack_meta(s, self._chain > 1))
            s = self._shard(s)
            total += _nbytes(s)
            if total > self._max_bytes:
                warnings.warn(
                    f"ResidentFeed: epoch exceeds max_bytes "
                    f"({total} > {self._max_bytes}); streaming from the host")
                self._streaming = True
                return
            stacks.append(to_device(s, self._place))
        self._stacks = stacks
        self.meta[:] = meta

    def __iter__(self) -> Iterator[EventBatch]:
        if self._stacks is None and not self._streaming:
            with annotate("feed.stage"):
                self._stage()
        if self._streaming:
            self.meta.clear()
            yield from prefetch_to_device(
                map(self._shard, recording(self._host_stacks(), self.meta,
                                           self._chain > 1)),
                place=self._place)
            return
        yield from self._stacks

    def __len__(self) -> int:
        if self._stacks is not None:
            return len(self._stacks)
        return sum(1 for _ in self._host_stacks())

    @property
    def n_steps(self) -> int:
        """Steps in one epoch: the loader's batches."""
        return len(self._loader)

    def nbytes(self) -> int:
        """Bytes staged in device memory (0 until staged, and when
        streaming)."""
        return sum(_nbytes(s) for s in (self._stacks or []))
