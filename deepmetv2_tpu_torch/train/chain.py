"""Chained train steps (the JAX package's ``train/chain.py``): K
consecutive same-shape batches stacked along a leading chain axis, and
their K optimizer steps run as one device program.

The JAX package runs a chain as one ``lax.scan`` over the stacked batches,
jitted once per (shape, K).  Here a chain on the card is one replay of a
``torch.cuda.CUDAGraph`` that holds the K steps, captured once per
(shape, K):

* the first chain of a (shape, K) runs its steps eagerly, as real steps,
  on the runner's side stream: that warms up AdamW's state, cuBLAS's
  workspace and autograd, and nothing is thrown away;
* the next chain of that (shape, K) is captured on the same stream, into
  one memory pool shared by all the runner's graphs, with the model's and
  the optimizer's own tensors; a capture records and does not run, so
  that chain is then replayed;
* every later chain is copied into the graph's static input (one
  device-to-device copy per field) and replayed; its losses are cloned out
  of the graph's static output before the next replay.

A capture or a replay that fails raises: nothing falls back to eager steps
or to the CPU.  On the CPU a chain runs its K steps in a loop, the same
steps as per-step dispatch.  The kernel wrappers count their launches
when Python calls them, which under capture is once per capture: the
runner takes back what a capture counted and adds it at every replay
(``build.add_launches``), so the counts stay launches on the card.

Pieces, as in the JAX package: ``stack_batches`` / ``chain_batches`` group
consecutive same-shape host batches (a shape change or the end of the
epoch flushes a shorter chain); ``make_chained_train_step`` is the chained
counterpart of ``train/step.make_train_step``.

On a mesh (parallel/) a chain is a loop of eager mesh steps, on either
device: the JAX package scans the same steps (its ``train/chain.py``), so
the losses are per-step equal.  Capturing a mesh chain as one CUDA graph
waits for a later slice (ROADMAP).
"""

from __future__ import annotations

import functools
from typing import (Callable, Dict, Iterator, List, NamedTuple, Sequence,
                    Tuple)

import numpy as np
import torch

from deepmetv2_tpu_torch.config import Config
from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.train.family import DEFAULT, family, mesh_forms
from deepmetv2_tpu_torch.train.step import make_train_step
from deepmetv2_tpu_torch.utils.profiling import annotate


def stack_batches(batches: Sequence[EventBatch]) -> EventBatch:
    """Stack same-shape host EventBatches along a new leading chain axis."""
    return EventBatch(*(np.stack([np.asarray(f) for f in fields])
                        for fields in zip(*batches)))


def chain_length(stacked: EventBatch) -> int:
    return stacked[0].shape[0]


def chain_batches(it, k: int) -> Iterator[EventBatch]:
    """Group consecutive same-shape batches from ``it`` into stacked
    chains of length <= ``k``.  Order is preserved exactly (chains are
    consecutive runs), so the optimizer-step sequence is unchanged; a
    shape change (bucket boundary) or the end of the epoch flushes a
    shorter chain.  ``k <= 1`` passes the batches through unchanged."""
    if k <= 1:
        yield from it
        return
    pend: List[EventBatch] = []
    key = None
    for b in it:
        kb = tuple(np.shape(f) for f in b)
        if pend and kb != key:
            yield stack_batches(pend)
            pend = []
        pend.append(b)
        key = kb
        if len(pend) == k:
            yield stack_batches(pend)
            pend = []
    if pend:
        yield stack_batches(pend)


def _run_chain(step: Callable, model, optimizer, stacked: EventBatch
               ) -> torch.Tensor:
    """The chain's K steps in order; their losses ``[K]``."""
    return torch.stack([
        step(model, optimizer, EventBatch(*(f[j] for f in stacked)))
        for j in range(chain_length(stacked))])


class _Graph(NamedTuple):
    """One captured chain: the graph, its static input and output, and
    the kernel launches one replay makes."""

    graph: torch.cuda.CUDAGraph
    static: EventBatch
    losses: torch.Tensor
    launches: Dict[str, int]


class ChainedStep:
    """``run(model, optimizer, stacked) -> losses [K]`` (a device tensor)
    around a per-step ``step(model, optimizer, batch) -> loss``: a loop
    on the CPU, warm-up, capture and replays on the card (module
    docstring).  ``n_graphs`` and ``replays`` count what it did."""

    def __init__(self, step: Callable):
        self.step = step
        self.graphs: Dict[Tuple, _Graph] = {}
        self.warmed: set = set()
        self.replays = 0
        self._stream = None
        self._pool = None

    @property
    def n_graphs(self) -> int:
        return len(self.graphs)

    def __call__(self, model, optimizer, stacked: EventBatch) -> torch.Tensor:
        if stacked.x_cont.device.type != "cuda":
            return _run_chain(self.step, model, optimizer, stacked)
        key = tuple((tuple(f.shape), f.dtype) for f in stacked)
        g = self.graphs.get(key)
        if g is None:
            if key not in self.warmed:
                self.warmed.add(key)
                return self._warm_up(model, optimizer, stacked)
            g = self.graphs[key] = self._capture(model, optimizer, stacked)
        return self._replay(g, stacked)

    def _side_stream(self, device) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._stream

    def _warm_up(self, model, optimizer, stacked: EventBatch) -> torch.Tensor:
        """The chain's steps, eagerly, on the side stream that captures."""
        main = torch.cuda.current_stream(stacked.x_cont.device)
        side = self._side_stream(stacked.x_cont.device)
        side.wait_stream(main)
        with annotate("chain.warm_up"), torch.cuda.stream(side):
            losses = _run_chain(self.step, model, optimizer, stacked)
        main.wait_stream(side)
        return losses

    def _capture(self, model, optimizer, stacked: EventBatch) -> _Graph:
        """Capture the chain's steps on ``stacked``'s shapes; runs nothing."""
        side = self._side_stream(stacked.x_cont.device)
        static = EventBatch(*(torch.empty_like(f) for f in stacked))
        graph = torch.cuda.CUDAGraph()
        before = build.launch_counts()
        with annotate("chain.capture"), torch.cuda.graph(
                graph, pool=self._pool, stream=side):
            losses = _run_chain(self.step, model, optimizer, static)
        captured = {k: n - before.get(k, 0)
                    for k, n in build.launch_counts().items()
                    if n != before.get(k, 0)}
        build.add_launches({k: -n for k, n in captured.items()})
        return _Graph(graph, static, losses, captured)

    def _replay(self, g: _Graph, stacked: EventBatch) -> torch.Tensor:
        with annotate("chain.replay"):
            for dst, src in zip(g.static, stacked):
                dst.copy_(src)
            g.graph.replay()
            build.add_launches(g.launches)
            self.replays += 1
            return g.losses.clone()


def mesh_train_step(cfg: Config, model: str, mesh,
                    shard_nodes: bool = False) -> Callable:
    """The per-step mesh train step of the family ``model``: with
    ``shard_nodes`` its step over each event's nodes split over the node
    axis (GraphMET edge-partitioned, the DRN node-sharded), else its
    data-parallel step."""
    if shard_nodes:
        return mesh_forms(model).node_step(cfg, mesh)
    from deepmetv2_tpu_torch.parallel.dp import make_dp_train_step

    return make_dp_train_step(cfg, mesh, model)


def make_chained_train_step(cfg: Config, model: str = DEFAULT,
                            mesh=None, shard_nodes: bool = False):
    """Chained counterpart of ``train/step.make_train_step`` for the family
    ``model`` (a key of ``train/family.FAMILIES``): a ``ChainedStep`` over
    its train step, or on a ``mesh`` the loop of its mesh step
    (``mesh_train_step``) over the chain's K batches, eagerly, in order."""
    objective = family(model).objective(cfg)
    if mesh is not None:
        return functools.partial(
            _run_chain, mesh_train_step(cfg, model, mesh, shard_nodes))
    return ChainedStep(make_train_step(cfg, objective))
