"""ParticleNet (Qu & Gouskos, "Jet Tagging via Particle Clouds",
arXiv:1902.08570) at the widths of weaver-core's
``networks/example_ParticleNet.py``, regressing an event's MET from its PF
candidates.

Per EdgeConv block b (``conv_params``: three blocks of three 1x1
convolutions, 64, 128 and 256 wide):

  1. the directed kNN graph of the block's points, each real candidate's
     k nearest other real candidates (ops/cuda/knn_und.py with
     ``directed=True``): (eta, phi) for the first block, the previous
     block's output for the others;
  2. the edge block (ops/cuda/pn_edge.py): three 1x1 convolutions without
     bias over ``[x_i, x_j − x_i]``, each followed by BatchNorm over the
     real edges and ReLU, then the mean over the k neighbours;
  3. the shortcut BatchNorm(x·W_sc) added, ReLU, padded rows zeroed.

Then the fusion (the blocks' outputs concatenated, 448 → 384, BatchNorm,
ReLU), the mean over the real candidates, FC 384 → 256 with ReLU and
dropout, and the last linear layer 256 → 2: the MET's (x, y) times
``output_scale``, trained with the DRN's cartesian loss
(train/loss.py:drn_loss_fn).  The inputs are the DRN's eleven candidate
features through an input BatchNorm (weaver's ``use_fts_bn``).  Every
BatchNorm takes its statistics over the real candidates or the real edges
only (nn/core.py:MaskedBatchNorm), where weaver's counts padded positions
too.

``log_forwards(n)`` keeps, on the device, the neighbour lists and the
dropout masks of the first ``n`` training forwards after the weights were
last loaded (``load_state_dict``), also inside captured CUDA graphs; a
check that follows a run's steps reads them with ``logged``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from deepmetv2_tpu_torch.config import ParticleNetConfig
from deepmetv2_tpu_torch.data.batching import EventBatch, Neighborhood
from deepmetv2_tpu_torch.models.layout import JaxLayout
from deepmetv2_tpu_torch.nn.core import Linear, MaskedBatchNorm
from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_extract, knn_kth
from deepmetv2_tpu_torch.ops.cuda.pn_edge import edge_block
from deepmetv2_tpu_torch.ops.knn_und import neighborhood
from deepmetv2_tpu_torch.utils.profiling import annotate


class Conv1x1(nn.Module):
    """A 1x1 convolution without bias: the weight ``w [in, out]``."""

    def __init__(self, in_dim: int, out_dim: int, generator=None,
                 device=None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        w = torch.empty((in_dim, out_dim), device=device)
        self.w = nn.Parameter(w.uniform_(-bound, bound, generator=generator))


class EdgeConvBlock(nn.Module):
    """One EdgeConv block: ``convs`` (2·cin → C → C → C) with ``bns``, and
    the shortcut ``sc`` with ``sc_bn``."""

    def __init__(self, cin: int, widths: Tuple[int, ...], generator=None,
                 device=None):
        super().__init__()
        if len(widths) != 3 or len(set(widths)) != 1:
            raise ValueError(f"EdgeConvBlock: widths {widths}; the edge "
                             "block takes three layers of one width")
        C = widths[0]
        self.convs = nn.ModuleList([Conv1x1(2 * cin, C, generator, device),
                                    Conv1x1(C, C, generator, device),
                                    Conv1x1(C, C, generator, device)])
        self.bns = nn.ModuleList(MaskedBatchNorm(C, device)
                                 for _ in range(3))
        self.sc = Conv1x1(cin, C, generator, device)
        self.sc_bn = MaskedBatchNorm(C, device)


def apply_dropout(h: torch.Tensor, keep: torch.Tensor, p: float
                  ) -> torch.Tensor:
    """Inverted dropout with the keep mask ``keep`` (1 kept, 0 dropped)."""
    return h * keep / (1.0 - p)


class LoggedDropout(nn.Module):
    """Dropout whose mask is drawn from torch's generator (safe under CUDA
    graph capture) and kept as ``keep`` after each training forward."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.keep: Optional[torch.Tensor] = None

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return h
        self.keep = torch.empty_like(h).bernoulli_(1.0 - self.p)
        return apply_dropout(h, self.keep, self.p)


class ParticleNet(JaxLayout):
    """The model's modules (torch's default initialization from
    ``generator``); ``forward`` is ``particlenet_apply``."""

    def __init__(self, cfg: ParticleNetConfig = ParticleNetConfig(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.cfg = cfg
        g, d = generator, device
        self.bn_fts = MaskedBatchNorm(cfg.input_dim, d)
        blocks, cin = [], cfg.input_dim
        for widths in cfg.conv_params:
            blocks.append(EdgeConvBlock(cin, tuple(widths), g, d))
            cin = widths[-1]
        self.blocks = nn.ModuleList(blocks)
        total = sum(w[-1] for w in cfg.conv_params)
        self.fusion = Conv1x1(total, cfg.fusion, g, d)
        self.fusion_bn = MaskedBatchNorm(cfg.fusion, d)
        self.fc = Linear(cfg.fusion, cfg.fc, g, d)
        self.dropout = LoggedDropout(cfg.dropout)
        self.out = Linear(cfg.fc, 2, g, d)
        self._log_n = 0
        self._log: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}
        self.register_buffer("_log_count", torch.zeros(
            (), dtype=torch.int64, device=d), persistent=False)

    def jax_layout(self) -> Iterator[Tuple[Tuple[Any, ...], torch.Tensor]]:
        """Every parameter under 'params' and every BatchNorm's running
        buffers under 'bn_state', by the modules' names."""
        for name, p in self.named_parameters():
            yield ("params",) + tuple(name.split(".")), p
        for name, m in self.named_modules():
            if isinstance(m, MaskedBatchNorm):
                path = ("bn_state",) + tuple(name.split("."))
                yield path + (0,), m.running_mean
                yield path + (1,), m.running_var
                yield path + (2,), m.num_batches_tracked

    def load_state_dict(self, state_dict, strict: bool = True, assign=False):
        out = super().load_state_dict(state_dict, strict, assign)
        self._log_count.zero_()
        return out

    def log_forwards(self, n: int) -> None:
        """Keep the lists and dropout masks of the first ``n`` training
        forwards after the weights were last loaded (each later forward's
        go to a spare slot); the count starts now."""
        self._log_n, self._log = int(n), {}
        self._log_count.zero_()

    def logged(self, step: int, B: int, N: int
               ) -> Tuple[List[Neighborhood], Optional[torch.Tensor]]:
        """The lists of each block and the dropout mask (None without
        dropout) of logged forward ``step`` (< n), whose batch was ``B``
        events wide at ``N`` nodes."""
        log = self._log[(B, N)]
        lists = [Neighborhood(log["idx"][step, b], log["mask"][step, b])
                 for b in range(len(self.blocks))]
        return lists, log.get("keep", [None] * (step + 1))[step]

    def _record(self, lists: List[Neighborhood],
                keep: Optional[torch.Tensor]) -> None:
        if not (self._log_n and self.training):
            return
        B, N, k = lists[0].idx.shape
        log = self._log.get((B, N))
        if log is None:   # first at an eager forward: never under capture
            n1, nb, dev = self._log_n + 1, len(lists), lists[0].idx.device
            log = self._log[(B, N)] = {
                "idx": torch.zeros((n1, nb, B, N, k), dtype=torch.int32,
                                   device=dev),
                "mask": torch.zeros((n1, nb, B, N, k), dtype=torch.bool,
                                    device=dev)}
            if keep is not None:
                log["keep"] = torch.zeros((n1,) + tuple(keep.shape),
                                          device=dev)
        slot = torch.clamp(self._log_count, max=self._log_n).reshape(1)
        log["idx"].index_copy_(0, slot, torch.stack(
            [nb.idx for nb in lists])[None])
        log["mask"].index_copy_(0, slot, torch.stack(
            [nb.mask for nb in lists])[None])
        if keep is not None:
            log["keep"].index_copy_(0, slot, keep[None])
        self._log_count.add_(1)

    def forward(self, feats: torch.Tensor, points: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        return particlenet_apply(self, feats, points, mask)


def knn_lists(h: torch.Tensor, mask: torch.Tensor, k: int) -> Neighborhood:
    """The directed kNN lists of ``h [B, N, H]``: each real node's k
    nearest other real nodes in ascending (d², index) order (fewer where
    the event has no more), padded rows and dry slots masked."""
    t, sq = knn_kth(h, mask, k)
    idx, d2v, _ = knn_extract(h, mask, t, sq, k, directed=True)
    return neighborhood(idx, d2v, mask)[0]


def real_rows(mask: torch.Tensor) -> torch.Tensor:
    """``[B]`` int32: per event, the rows up to its last real node."""
    pos = torch.arange(1, mask.shape[1] + 1, device=mask.device)
    return torch.where(mask, pos, torch.zeros_like(pos)).amax(1).to(
        torch.int32)


def block_apply(blk: EdgeConvBlock, x: torch.Tensor, nbr: Neighborhood,
                mask: torch.Tensor, cnt: torch.Tensor, train: bool
                ) -> torch.Tensor:
    """One EdgeConv block on the lists ``nbr``: the edge block, the
    shortcut, ReLU, padded rows zeroed; in training the edge BatchNorms'
    running buffers take the batch's statistics (n the real edges)."""
    n_edges = nbr.mask.sum().to(torch.float64).reshape(1)
    gamma = torch.stack([bn.gamma for bn in blk.bns])
    beta = torch.stack([bn.beta for bn in blk.bns])
    running = [(bn.running_mean, bn.running_var) for bn in blk.bns]
    y, stats = edge_block(x, nbr, cnt, n_edges, blk.convs[0].w,
                          blk.convs[1].w, blk.convs[2].w, gamma, beta, train,
                          running)
    if train:
        for bn, (mean, var) in zip(blk.bns, stats):
            bn.update_running(mean, var, n_edges.to(x.dtype))
    sc = blk.sc_bn(torch.matmul(x, blk.sc.w), mask)
    return torch.relu(y + sc) * mask[..., None].to(x.dtype)


def particlenet_apply(model: ParticleNet, feats: torch.Tensor,
                      points: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
    """``[B, 2]``: the MET's (x, y) of each event from its candidates'
    features ``feats [B, N, F]``, points ``[B, N, 2]`` (eta, phi) and
    ``mask [B, N]``."""
    cfg, train = model.cfg, model.training
    m = mask[..., None].to(feats.dtype)
    cnt = real_rows(mask)
    with annotate("model.embed"):
        x = model.bn_fts(feats, mask) * m
    outs, lists = [], []
    pts = points
    for blk in model.blocks:
        with annotate("graph.knn"):
            nbr = knn_lists(pts.contiguous(), mask, cfg.k)
        lists.append(nbr)
        with annotate("model.conv"):
            x = block_apply(blk, x, nbr, mask, cnt, train)
        outs.append(x)
        pts = x
    with annotate("model.head"):
        f = torch.matmul(torch.cat(outs, dim=-1), model.fusion.w)
        f = torch.relu(model.fusion_bn(f, mask)) * m
        pooled = f.sum(1) / m.sum(1).clamp(min=1.0)
        h = model.dropout(torch.relu(model.fc(pooled)))
        model._record(lists, model.dropout.keep if train else None)
        return model.out(h) * cfg.output_scale


def pn_inputs(batch: EventBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(feats [B, N, 11], points [B, N, 2])``: the DRN's candidate
    inputs (continuous, then categorical as floats) and (eta, phi =
    atan2(py, px))."""
    feats = torch.cat([batch.x_cont, batch.x_cat.to(batch.x_cont.dtype)],
                      dim=-1)
    phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
    return feats, torch.stack([batch.x_cont[..., 3], phi], dim=-1)


def particlenet_net_apply(model: ParticleNet, batch: EventBatch
                          ) -> torch.Tensor:
    """``particlenet_apply`` on a batch (``pn_inputs``)."""
    feats, points = pn_inputs(batch)
    return particlenet_apply(model, feats, points, batch.mask)
