"""Dataset and loaders (the JAX package's ``data/loader.py``; reference
model/data_loader.py:21-111).

* the seed-42 split is drawn with ``torch.randperm`` on a generator of its
  own, the same indices as the reference's ``random_split`` under
  ``torch.manual_seed``;
* ``sequential`` batches keep the reference's order and composition,
  ``bucketed`` groups events by size bucket;
* window mode may presort each batch on the host (``presort_eta``), in eta
  order or in cell order (``presort_mode``, data/sorting.py);
* collated host batches are memoized after the first full pass;
* ``prefetch_to_device`` is the double-buffered host→device feed of a
  streamed epoch, ``device_feed`` the plain one of evaluate and predict.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.data import ingest, sorting
from deepmetv2_tpu_torch.data.batching import (EventBatch, bucket_for,
                                               collate, to_device)

Event = Tuple[np.ndarray, np.ndarray]


def _torch_random_split_indices(n: int, n_val: int, seed: int
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """Train / validation indices of the reference's seeded random_split
    (model/data_loader.py:103-104)."""
    gen = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=gen).numpy()
    return perm[: n - n_val], perm[n - n_val:]


class METDataset:
    """In-memory event store (reference METDataset, model/data_loader.py)."""

    def __init__(self, data_dir: Optional[str] = None,
                 events: Optional[Sequence[Event]] = None):
        if events is not None:
            self._events: List[Event] = list(events)
        else:
            assert data_dir is not None
            files = ingest.discover_npz(data_dir)
            if not files:
                raise FileNotFoundError(f"no npz slices under {data_dir}")
            self._events = []
            for f in files:
                self._events.extend(ingest.load_npz_events(f))

    def __len__(self) -> int:
        return len(self._events)

    def __getitem__(self, i: int) -> Event:
        return self._events[i]


class PaddedLoader:
    """Iterates host EventBatches over a subset of a dataset.  Unshuffled
    and memoized, it yields the same batches in every epoch
    (``replays_same_batches``), which lets train/resident.py stage an
    epoch on the device once."""

    replays_same_batches = True

    def __init__(
        self,
        dataset: METDataset,
        indices: Sequence[int],
        batch_size: int,
        buckets: Sequence[int],
        mode: str = "sequential",
        pad_batches: bool = True,
        cache: bool = True,
        presort_eta: bool = False,
        presort_mode: str = "eta",
        presort_r: float = 0.4,
    ):
        self.dataset = dataset
        self.indices = np.asarray(indices, dtype=np.int64)
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        assert mode in ("sequential", "bucketed")
        self.mode = mode
        self.pad_batches = pad_batches
        # window mode: sort each batch on the host at collation time (the
        # config's graph.presorted then tells the steps not to sort);
        # 'eta' = plain eta sort, 'cell' = eta-quantile block x phi order
        if presort_mode not in ("eta", "cell"):
            raise ValueError(f"presort_mode {presort_mode!r}: 'eta' or 'cell'")
        self.presort_eta = presort_eta
        self.presort_mode = presort_mode
        self.presort_r = presort_r
        self._batches = self._plan()
        self._cache: Optional[List[EventBatch]] = [] if cache else None

    def _plan(self) -> List[np.ndarray]:
        bs = self.batch_size
        if self.mode == "sequential":
            return [self.indices[i:i + bs]
                    for i in range(0, len(self.indices), bs)]
        # bucketed: per-bucket batch lists, interleaved round-robin so the
        # BatchNorm statistics do not drift toward the last bucket
        by_bucket: Dict[int, List[int]] = {}
        for idx in self.indices:
            n = self.dataset[int(idx)][0].shape[0]
            by_bucket.setdefault(bucket_for(n, self.buckets), []).append(int(idx))
        per_bucket = [[np.asarray(idxs[i:i + bs], dtype=np.int64)
                       for i in range(0, len(idxs), bs)]
                      for _, idxs in sorted(by_bucket.items())]
        plans = []
        for i in range(max(len(p) for p in per_bucket) if per_bucket else 0):
            for p in per_bucket:
                if i < len(p):
                    plans.append(p[i])
        return plans

    def __len__(self) -> int:
        return len(self._batches)

    def batches_per_bucket(self) -> Dict[int, int]:
        """How many of this loader's batches fall into each node bucket
        (the bucket of the batch's largest event, as ``collate`` pads)."""
        sizes = [max(self.dataset[int(i)][0].shape[0] for i in idx)
                 for idx in self._batches]
        return dict(sorted(collections.Counter(
            bucket_for(n, self.buckets) for n in sizes).items()))

    def required_halo(self, r: float) -> int:
        """Smallest window halo valid for every batch this loader yields,
        in the row order it emits.  Builds the batch cache on first use."""
        if self._cache is not None and not self._cache and len(self):
            print(f"sizing window halo: collating {len(self)} batches "
                  f"({len(self.indices)} events) on the host (cached)")
        worst = 0
        for b in self:
            if self.presort_eta and self.presort_mode == "cell":
                worst = max(worst, sorting.required_span_blocks(b, r))
            else:   # eta order, presorted or sorted by the step
                worst = max(worst, sorting.required_halo_arrays(
                    b.x_cont[..., 3], b.mask, r))
        return int(worst)

    def __iter__(self) -> Iterator[EventBatch]:
        if self._cache:
            yield from self._cache
            return
        pad_to = self.batch_size if self.pad_batches else None
        built: List[EventBatch] = []
        for batch_idx in self._batches:
            events = [self.dataset[int(i)] for i in batch_idx]
            b = collate(events, buckets=self.buckets, pad_events_to=pad_to)
            if self.presort_eta:
                b = (sorting.cell_sort_batch(b, r=self.presort_r)
                     if self.presort_mode == "cell"
                     else sorting.presort_batch(b))
            built.append(b)
            yield b
        if self._cache is not None:      # publish only complete epochs
            self._cache = built


def device_feed(loader, device) -> Iterator[EventBatch]:
    """Host batches → device batches, one at a time."""
    for b in loader:
        yield to_device(b, device)


def prefetch_to_device(it, size: int = 2, place=None
                       ) -> Iterator[EventBatch]:
    """Double-buffered host→device feed (the JAX package's
    ``prefetch_to_device``): each host batch (or chain of batches) is
    copied into pinned host tensors and from there onto the device
    (``place``, default CUDA) with ``non_blocking`` copies on a side
    stream, ``size`` batches ahead of the consumer, whose stream waits for
    a batch's copies before it gets the batch.  On the CPU the batches are
    only converted."""
    device = torch.device(place if place is not None else "cuda")
    if device.type != "cuda":
        yield from device_feed(it, device)
        return
    stream = torch.cuda.Stream(device)
    pending = collections.deque()
    for b in it:
        host = [torch.from_numpy(np.ascontiguousarray(f)).pin_memory()
                for f in b]
        with torch.cuda.stream(stream):
            dev = EventBatch(*(h.to(device, non_blocking=True)
                               for h in host))
            done = torch.cuda.Event()
            done.record(stream)
        pending.append((dev, done))
        if len(pending) >= size:
            yield _ready(*pending.popleft())
    while pending:
        yield _ready(*pending.popleft())


def _ready(batch: EventBatch, done) -> EventBatch:
    """``batch`` for the current stream, once its copies are done there;
    its tensors are marked as used on that stream, so that the allocator
    does not hand their memory to the copy stream too early."""
    consumer = torch.cuda.current_stream(batch.x_cont.device)
    consumer.wait_event(done)
    for t in batch:
        t.record_stream(consumer)
    return batch


def fetch_dataloader(
    data_dir: Optional[str] = None,
    batch_size: int = 6,
    validation_split: float = 0.2,
    events: Optional[Sequence[Event]] = None,
    seed: int = 42,
    buckets: Sequence[int] = (128, 256, 512, 1024, 2048, 4096, 8192),
    mode: str = "sequential",
    presort_eta: bool = False,
    presort_mode: str = "eta",
    presort_r: float = 0.4,
) -> Dict[str, PaddedLoader]:
    """Reference ``fetch_dataloader`` (model/data_loader.py:92-111): seeded
    80/20 split, unshuffled batches."""
    dataset = METDataset(data_dir=data_dir, events=events)
    n = len(dataset)
    n_val = int(np.floor(validation_split * n))
    train_idx, val_idx = _torch_random_split_indices(n, n_val, seed)
    kw = dict(presort_eta=presort_eta, presort_mode=presort_mode,
              presort_r=presort_r)
    return {
        "train": PaddedLoader(dataset, train_idx, batch_size, buckets, mode,
                              **kw),
        "test": PaddedLoader(dataset, val_idx, batch_size, buckets, mode,
                             **kw),
    }
