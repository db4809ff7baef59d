"""DynamicReductionNetwork — the graph-coarsening model family (the JAX
package's ``models/drn.py``; reference model/dynamic_reduction_network.py:
27-103).

Per reduction round (``pool_rounds``, 2 in ``ckpts_syn_drn``):
  1. the symmetrized feature-space kNN graph of the current features
     (ops/dyn_graph.py: the fused build where it applies, else the
     composed one);
  2. EdgeConv with the edge MLP Linear(2H→3H/2)+ELU+Linear(3H/2→H)+ELU and
     BatchNorm over the valid edge messages, aggregated by ``aggr``: the
     fused conv (ops/cuda/edge_mlp.py) for the shapes it takes, else the
     gather-reduce form in plain PyTorch (``_xla_edgeconv``, the JAX
     package's XLA form);
  3. normalized-cut handshake matching and cluster-max pooling, then (with
     ``compact_pool``, between rounds) the representatives gathered into
     the front 3N/4 slots.
Then the per-event max pool and the output MLP, under a polar or a
cartesian head.

With an injected graph build ``knn_fn`` (the JAX package's hook,
models/drn.py:279-378) a round is instead ``to_undirected(knn_fn(h,
mask), cap)``, the conv, the list matching on the detached features and
the pooling, with no compaction, all on the whole node axis; the
node-sharded DRN (parallel/dyn.py) injects its distributed builds there,
and ``nodes`` says how the node axis is laid out (``WholeAxis``: all of it
here).

In training mode (``model.train()``) each round's BatchNorm normalizes
with the batch statistics of the valid edge messages and updates its
running buffers as the JAX package does; the fused conv's gradient runs
through the edge-MLP backward kernel (ops/cuda/edge_mlp.py:EdgeMLP), the
gather-reduce form's through autograd (a mirror gather with
``mirror_gather``).  The constructor
is the JAX package's ``drn_init``: the data-derived ``datanorm`` (a
trainable parameter, as there) and, for the polar head, the softplus⁻¹
``met_bias`` of the MET logit.

Parameters keep the JAX package's names and ``[in, out]`` layout, so
``params_from_jax`` reads a JAX checkpoint unchanged and ``params_to_jax``
writes one (models/layout.py).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, Optional, Sequence, Tuple

import torch
from torch import nn

from deepmetv2_tpu_torch.config import DRNConfig
from deepmetv2_tpu_torch.data.batching import EventBatch, Neighborhood
from deepmetv2_tpu_torch.models.layout import JaxLayout
from deepmetv2_tpu_torch.nn.core import (MLP, MaskedBatchNorm, elu,
                                         masked_moments)
from deepmetv2_tpu_torch.ops import edge_mlp
from deepmetv2_tpu_torch.ops.coarsen import global_max_pool, max_pool
from deepmetv2_tpu_torch.ops.cuda.edge_mlp import edge_mlp_conv
from deepmetv2_tpu_torch.ops.dyn_graph import (build_dyn_graph, cut_matching,
                                               list_matching)
from deepmetv2_tpu_torch.ops.graph import to_undirected
from deepmetv2_tpu_torch.ops.segment import (batched_take, gather_neighbors,
                                             gather_neighbors_mirror)
from deepmetv2_tpu_torch.parallel import context as pctx
from deepmetv2_tpu_torch.utils.profiling import annotate

# The DRN's default input scales (reference model/net.py:20-31), in the
# data pipeline's feature order [px, py, pt, eta, d0, dz, mass,
# puppiWeight, pdgId, charge, fromPV], as the JAX package orders them.
DEFAULT_NORM = (
    1.0 / 2950.0, 1.0 / 2950.0, 1.0 / 2950.0, 1.0 / 5.265625,
    1.0 / 143.875, 1.0 / 589.0, 1.0 / 1.2050781,
    1.0, 1.0 / 211.0, 1.0, 1.0 / 7.0,
)


class DRNConv(nn.Module):
    """One round's edge MLP and its edge BatchNorm."""

    def __init__(self, H: int, generator=None, device=None):
        super().__init__()
        self.mlp = MLP((2 * H, 3 * H // 2, H), generator, device)
        self.bn = MaskedBatchNorm(H, device)


class DRN(JaxLayout):
    """The JAX package's ``drn_init`` tree as modules (torch's default
    initialization from ``generator``); ``forward`` is ``drn_apply``.
    ``norm`` is the input scale per feature (default ``DEFAULT_NORM``);
    ``met_bias`` > 0 sets the polar head's MET logit bias to
    softplus⁻¹(met_bias / output_scale), so that the head starts on the
    scale of the training set's mean |genMET| (JAX ``drn_init``)."""

    def __init__(self, cfg: DRNConfig = DRNConfig(),
                 generator: Optional[torch.Generator] = None, device=None,
                 norm: Optional[Sequence[float]] = None,
                 met_bias: float = 0.0):
        super().__init__()
        self.cfg = cfg
        H, g, d = cfg.hidden_dim, generator, device
        if norm is None:
            norm = DEFAULT_NORM[:cfg.input_dim]
        self.datanorm = nn.Parameter(torch.tensor(
            tuple(norm), dtype=torch.float32, device=d))
        self.inputnet = MLP((cfg.input_dim, H // 2, H, H), g, d)
        self.output = MLP((H, H, H // 2, cfg.output_dim), g, d)
        if met_bias > 0 and cfg.head == "polar":
            # softplus⁻¹(m) = m + log1p(−exp(−m)), in f32 as the JAX package
            # takes it; the cartesian head regresses a zero-mean vector
            m = met_bias / cfg.output_scale
            inv = m + float(torch.log1p(-torch.exp(-torch.tensor(m))))
            with torch.no_grad():
                self.output.layers[-1].b[0] = inv
        self.convs = nn.ModuleList(DRNConv(H, g, d)
                                   for _ in range(cfg.pool_rounds))

    def jax_layout(self) -> Iterator[Tuple[Tuple[Any, ...], torch.Tensor]]:
        """(JAX pytree path, tensor) for every parameter and BatchNorm
        buffer, paths rooted at 'params' or 'bn_state'."""
        yield ("params", "datanorm"), self.datanorm
        for name in ("inputnet", "output"):
            for i, lin in enumerate(getattr(self, name).layers):
                yield ("params", name, f"lin{i}", "w"), lin.w
                yield ("params", name, f"lin{i}", "b"), lin.b
        for r, conv in enumerate(self.convs):
            for i, lin in enumerate(conv.mlp.layers):
                yield ("params", "convs", r, "mlp", f"lin{i}", "w"), lin.w
                yield ("params", "convs", r, "mlp", f"lin{i}", "b"), lin.b
            yield ("params", "convs", r, "bn", "gamma"), conv.bn.gamma
            yield ("params", "convs", r, "bn", "beta"), conv.bn.beta
            yield ("bn_state", "convs", r, 0), conv.bn.running_mean
            yield ("bn_state", "convs", r, 1), conv.bn.running_var
            yield ("bn_state", "convs", r, 2), conv.bn.num_batches_tracked

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                diag: Optional[dict] = None) -> torch.Tensor:
        return drn_apply(self, x, mask, diag)


def _edge_batchnorm(bn: MaskedBatchNorm, msgs: torch.Tensor,
                    edge_mask: torch.Tensor, train: bool,
                    eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over the valid edge messages ``msgs [B, N, K, H]`` (the
    reference's BatchNorm1d on the ``[E, H]`` message matrix): in
    training, the biased statistics of the valid messages, folded into the
    running buffers (n the number of valid edges), as the JAX package's
    ``_edge_batchnorm`` does; in a mesh step, the global batch's valid
    messages (nn/core.py:masked_moments)."""
    if train:
        mean, var, n = masked_moments(msgs, edge_mask[..., None], (0, 1, 2))
        bn.update_running(mean, var, n)
    else:
        mean, var = bn.running_mean, bn.running_var
    return (msgs - mean) * torch.rsqrt(var + eps) * bn.gamma + bn.beta


def _xla_edgeconv(conv: DRNConv, x: torch.Tensor, nbr: Neighborhood,
                  aggr: str, train: bool, gather) -> torch.Tensor:
    """The round's EdgeConv as a gather and masked reduce (JAX
    models/drn.py:205-229): the first layer factored into ``a_i + c_j``
    with ``c`` gathered by ``gather(c, nbr)``, ELU after every layer, the
    edge BatchNorm, then the masked max, sum ('add') or mean over the
    slots (0 for a node without one)."""
    layers = conv.mlp.layers
    H = x.shape[-1]
    w0 = layers[0].w
    a = torch.matmul(x, w0[:H] - w0[H:]) + layers[0].b
    c = torch.matmul(x, w0[H:])
    h = elu(a[:, :, None, :] + gather(c, nbr))            # [B, N, K, F]
    for lin in layers[1:]:
        h = elu(lin(h))
    h = _edge_batchnorm(conv.bn, h, nbr.mask, train)
    m = nbr.mask[..., None]
    if aggr == "max":
        out = torch.amax(torch.where(m, h, torch.full_like(h, -torch.inf)),
                         dim=2)
        return torch.where(m.any(dim=2), out, torch.zeros_like(out))
    s = torch.where(m, h, torch.zeros_like(h)).sum(dim=2)
    if aggr == "add":
        return s
    if aggr == "mean":
        return s / torch.clamp(m.sum(dim=2), min=1)
    raise ValueError(f"unknown aggr {aggr!r}")


def _drn_edgeconv(conv: DRNConv, x: torch.Tensor, nbr: Neighborhood,
                  aggr: str, train: bool, gather=gather_neighbors,
                  force: Optional[str] = None) -> torch.Tensor:
    """The round's EdgeConv: the fused conv for the two-layer MLP at the
    shapes it takes (``edge_mlp.supported``), else, or with ``force``
    'xla', ``_xla_edgeconv`` through ``gather``.  ``train`` normalizes
    with the batch statistics of the valid edge messages and updates the
    running buffers as the JAX package does (models/drn.py:193-204), n
    being the number of valid edges."""
    if force not in (None, "fused", "xla"):
        raise ValueError(f"conv force={force!r}: None, 'fused' or 'xla'")
    layers = conv.mlp.layers
    H, K = x.shape[-1], nbr.idx.shape[-1]
    F1, H2 = layers[0].w.shape[-1], layers[-1].w.shape[-1]
    if (force == "xla" or len(layers) != 2
            or not edge_mlp.supported(K, H, F1, H2)):
        return _xla_edgeconv(conv, x, nbr, aggr, train, gather)
    bn = conv.bn
    out, mean, var = edge_mlp_conv(x, nbr, conv.mlp.params(), bn.gamma,
                                   bn.beta, bn.running_mean, bn.running_var,
                                   train, aggr)
    if train:
        total = pctx.batch_sum() or (lambda t: t)
        bn.update_running(mean, var, torch.clamp(total(nbr.mask.sum()),
                                                 min=1).to(var.dtype))
    return out


def _compact_size(n: int) -> int:
    """Post-pool capacity: 3N/4 rounded up to a multiple of 128, at least
    128."""
    return max(128, -(-(3 * n) // (4 * 128)) * 128)


def _compact_nodes(h: torch.Tensor, mask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pooled representatives gathered into the front
    ``_compact_size(N)`` slots in ascending index order (a stable sort, as
    ``jnp.argsort``); overflow drops the highest-index ones."""
    B, N = mask.shape
    ncomp = _compact_size(N)
    if ncomp >= N:
        return h, mask
    iota = torch.arange(N, device=mask.device)
    key = torch.where(mask, iota[None, :], torch.full_like(iota, N)[None, :])
    order = torch.argsort(key, dim=1, stable=True)[:, :ncomp]
    return batched_take(h, order), torch.gather(mask, 1, order)


def compact_dropped(mask: torch.Tensor) -> torch.Tensor:
    """Representatives ``_compact_nodes`` would drop from this pooled mask:
    the worst event's survivors minus the capacity, at least 0."""
    N = mask.shape[1]
    ncomp = _compact_size(N)
    if ncomp >= N:
        return torch.zeros((), dtype=torch.int64, device=mask.device)
    return torch.clamp(mask.sum(dim=1).max() - ncomp, min=0)


class WholeAxis:
    """The node layout of a forward that holds every node of its events:
    ``gather`` (this layout's rows → the whole axis 1) and ``local`` (the
    whole axis → this layout's rows) are identities, and ``whole_axis()``
    (the context of the ops on the whole axis) changes nothing.  The
    node-sharded DRN's layout is parallel/dyn.py:NodeShards."""

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def local(self, t: torch.Tensor) -> torch.Tensor:
        return t

    def whole_axis(self):
        return contextlib.nullcontext()


def _gather_lists(nodes, nbr: Neighborhood) -> Neighborhood:
    """``nbr``'s lists over the whole node axis, one gather (invalid slots
    travel as −1)."""
    packed = nodes.gather(torch.where(nbr.mask, nbr.idx,
                                      torch.full_like(nbr.idx, -1)))
    return Neighborhood(idx=torch.clamp(packed, min=0), mask=packed >= 0)


def _listed_round(conv: DRNConv, h: torch.Tensor, mask: torch.Tensor,
                  cfg: DRNConfig, train: bool, knn_fn, nodes,
                  conv_force: Optional[str], diag: Optional[dict]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One round on an injected graph build (JAX models/drn.py:330-345):
    the undirected lists of ``knn_fn``'s graph, the conv
    (``_drn_edgeconv``: the fused conv where it takes the shapes), the
    list matching on the detached post-conv features (normalized-cut
    weights, handshake), the pooling.  All of them see the whole node axis
    (``nodes.gather``), as the JAX package's sharded trace replicates the
    conv's pallas_call; the conv's BatchNorm statistics are taken in
    ``nodes.whole_axis()``, and each layout keeps its own rows
    (``nodes.local``)."""
    with annotate("graph.knn"):
        nbr = to_undirected(_gather_lists(nodes, knn_fn(h, mask)),
                            cap=cfg.und_cap)
    h, mask = nodes.gather(h), nodes.gather(mask)
    with annotate("model.conv"), nodes.whole_axis():
        h = _drn_edgeconv(conv, h, nbr, cfg.aggr, train, force=conv_force)
    with annotate("graph.match"):
        # the graph is discrete: no gradient through the matching's weights
        cluster, partner = list_matching(h.detach(), nbr, mask)
    if diag is not None:
        diag.setdefault("rounds", []).append((mask, nbr, cluster, partner))
    with annotate("graph.pool"):
        h, mask = max_pool(h, cluster, partner, mask)
    return nodes.local(h), nodes.local(mask)


def drn_apply(model: DRN, x: torch.Tensor, mask: torch.Tensor,
              diag: Optional[dict] = None, graph_force: Optional[str] = None,
              conv_force: Optional[str] = None, knn_fn=None,
              nodes=None) -> torch.Tensor:
    """Forward → per-event outputs ``[B, output_dim]`` (reference
    model/dynamic_reduction_network.py:82-103).  ``diag``, if given,
    collects ``compact_dropped`` per compaction and, under ``rounds``, each
    round's graph decisions ``(mask, nbr, cluster, partner)``.  The model's
    mode picks the BatchNorm statistics (``model.train()``: the batch's,
    and the running buffers update).  ``graph_force`` ('fused' or
    'composed') pins the graph build, ``conv_force`` ('fused' or 'xla')
    the conv, as the JAX package's arguments do; None picks by shape.

    ``knn_fn(h, mask) -> Neighborhood`` replaces the graph build (rounds
    by ``_listed_round``; ``graph_force`` then does not apply), and
    ``nodes`` (default ``WholeAxis()``) lays out the node axis: ``x`` and
    ``mask`` are its rows, and the rounds and the per-event max pool take
    the whole axis.  ``diag``'s rounds then hold the whole axis's
    decisions."""
    cfg = model.cfg
    with annotate("model.embed"):
        h = model.inputnet(model.datanorm * x, final_act=True)
    if knn_fn is not None:
        nodes = nodes or WholeAxis()
        for conv in model.convs:
            h, mask = _listed_round(conv, h, mask, cfg, model.training,
                                    knn_fn, nodes, conv_force, diag)
        with annotate("model.head"):
            return model.output(global_max_pool(nodes.gather(h),
                                                nodes.gather(mask)))
    for r, conv in enumerate(model.convs):
        with annotate("graph.knn"):
            g = build_dyn_graph(h, mask, k=cfg.k, cap=cfg.und_cap,
                                want_mirror=cfg.mirror_gather,
                                force=graph_force)
        gather = gather_neighbors
        if g.mirror is not None:
            # a symmetric list: the gather's backward is a gather too
            gather = (lambda v, n, mirror=g.mirror:
                      gather_neighbors_mirror(v, n, mirror))
        with annotate("model.conv"):
            h = _drn_edgeconv(conv, h, g.nbr, cfg.aggr, model.training,
                              gather, conv_force)
        with annotate("graph.match"):
            cluster, partner = cut_matching(g, h, mask)
        if diag is not None:
            diag.setdefault("rounds", []).append((mask, g.nbr, cluster,
                                                  partner))
        with annotate("graph.pool"):
            h, mask = max_pool(h, cluster, partner, mask)
            if cfg.compact_pool and r < cfg.pool_rounds - 1:
                if diag is not None:
                    diag.setdefault("compact_dropped", []).append(
                        compact_dropped(mask))
                h, mask = _compact_nodes(h, mask)
    with annotate("model.head"):
        return model.output(global_max_pool(h, mask))


def drn_net_apply(model: DRN, batch: EventBatch,
                  diag: Optional[dict] = None,
                  graph_force: Optional[str] = None,
                  conv_force: Optional[str] = None, knn_fn=None,
                  nodes=None) -> torch.Tensor:
    """The head on ``drn_apply``: 'cartesian' gives (METx, METy) scaled by
    ``output_scale``; 'polar' gives (MET, φ) with MET = scale·softplus and
    φ = π·(2·sigmoid − 1).  ``knn_fn`` and ``nodes`` go to ``drn_apply``."""
    cfg = model.cfg
    x = torch.cat([batch.x_cont, batch.x_cat.to(batch.x_cont.dtype)], dim=-1)
    out = drn_apply(model, x, batch.mask, diag, graph_force, conv_force,
                    knn_fn, nodes)
    if cfg.head == "cartesian":
        return cfg.output_scale * out[:, 0:2]
    met = cfg.output_scale * torch.logaddexp(out[:, 0:1],
                                             torch.zeros_like(out[:, 0:1]))
    phi = math.pi * (2.0 * torch.sigmoid(out[:, 1:2]) - 1.0)
    return torch.cat([met, phi], dim=1)
