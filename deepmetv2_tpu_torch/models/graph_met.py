"""GraphMETNetwork — the per-candidate weight regressor (the JAX package's
``models/graph_met.py``; reference model/graph_met_network.py:11-69 and the
``Net`` sigmoid wrapper, model/net.py:38-47):

* embeddings of charge [3, H/4], |pdgId| [7, H/4], fromPV [8, H/4], looked
  up together (ops/cuda/cat_embed.py: one op, whose backward is a kernel
  on the card);
* continuous encoder Linear(8→H/2)+ELU, categorical encoder
  Linear(3H/4→H/2)+ELU, joint encoder Linear(H→H)+ELU, masked BatchNorm;
* ``conv_depth`` residual blocks ``emb += BN(EdgeConv_linear(emb))``,
  with ``compute_dtype='bfloat16'`` the EdgeConv's GEMMs on bf16 operands
  and its window max on bf16 values (ops/window.py:edgeconv_terms); the
  parameters and everything else stay float32, as in the JAX package;
* head Linear(H→H/2)+ELU+Linear(H/2→1), sigmoid → w ∈ (0, 1).

Parameters keep the JAX package's names and ``[in, out]`` layout, so
``params_from_jax`` carries a JAX checkpoint across unchanged and
``params_to_jax`` writes the same trees back; ``optimizer_state_from_jax``
and ``optimizer_state_to_jax`` do the same for the AdamW moments (all from
models/layout.py, driven by ``jax_layout``).
"""

from __future__ import annotations

from typing import Any, Iterator, Optional, Tuple

import torch
from torch import nn

from deepmetv2_tpu_torch.config import ModelConfig
from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.models.layout import JaxLayout
from deepmetv2_tpu_torch.nn.core import (MLP, Embedding, Linear,
                                         MaskedBatchNorm, elu)
from deepmetv2_tpu_torch.ops.cuda.cat_embed import cat_embed
from deepmetv2_tpu_torch.ops.edgeconv import edgeconv
from deepmetv2_tpu_torch.utils.profiling import annotate


class EdgeConvBlock(nn.Module):
    def __init__(self, H: int, generator=None, device=None):
        super().__init__()
        self.edge = Linear(2 * H, H, generator, device)
        self.bn = MaskedBatchNorm(H, device)


class GraphMET(JaxLayout):
    """The JAX package's ``graph_met_init`` is the constructor (torch's
    default initialization from ``generator``) and its ``graph_met_apply``
    is ``forward``: raw (pre-sigmoid) scores ``[B, N]``, garbage at padded
    nodes; ``net_apply`` turns them into weights.  Training mode uses batch
    statistics in BatchNorm and updates its buffers."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if cfg.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={cfg.compute_dtype!r}: float32 "
                             "or bfloat16")
        self.cfg = cfg
        H = cfg.hidden_dim
        g, d = generator, device
        self.embed_charge = Embedding(3, H // 4, g, d)
        self.embed_pdgid = Embedding(7, H // 4, g, d)
        self.embed_pv = Embedding(8, H // 4, g, d)
        self.embed_continuous = Linear(cfg.continuous_dim, H // 2, g, d)
        self.embed_categorical = Linear(3 * H // 4, H // 2, g, d)
        self.encode_all = Linear(H, H, g, d)
        self.bn_all = MaskedBatchNorm(H, d)
        self.convs = nn.ModuleList(EdgeConvBlock(H, g, d)
                                   for _ in range(cfg.conv_depth))
        self.output = MLP((H, H // 2, cfg.output_dim), g, d)

    def forward(self, batch: EventBatch, graph) -> torch.Tensor:
        with annotate("model.embed"):
            emb_cont = elu(self.embed_continuous(batch.x_cont))
            emb_cat = elu(self.embed_categorical(cat_embed(
                batch.x_cat.contiguous(), self.embed_charge.w,
                self.embed_pdgid.w, self.embed_pv.w, self.cfg.pdgs)))
            enc = elu(self.encode_all(torch.cat([emb_cat, emb_cont],
                                                dim=-1)))
            emb = self.bn_all(enc, batch.mask)
        dtype = (torch.bfloat16 if self.cfg.compute_dtype == "bfloat16"
                 else None)
        for conv in self.convs:
            with annotate("model.conv"):
                h = edgeconv(emb, graph, conv.edge.w, conv.edge.b, "max",
                             dtype)
                emb = emb + conv.bn(h, batch.mask)  # residual
        with annotate("model.head"):
            return self.output(emb).squeeze(-1)

    def jax_layout(self) -> Iterator[Tuple[Tuple[Any, ...], torch.Tensor]]:
        """(JAX pytree path, tensor) for every parameter and BatchNorm
        buffer: paths into the JAX ``params`` start with 'params', paths
        into its ``bn_state`` with 'bn_state'."""
        for name in ("embed_charge", "embed_pdgid", "embed_pv"):
            yield ("params", name, "w"), getattr(self, name).w
        for name in ("embed_continuous", "embed_categorical", "encode_all"):
            lin = getattr(self, name)
            yield ("params", name, "w"), lin.w
            yield ("params", name, "b"), lin.b
        for i, lin in enumerate(self.output.layers):
            yield ("params", "output", f"lin{i}", "w"), lin.w
            yield ("params", "output", f"lin{i}", "b"), lin.b
        bns = [(("bn_all",), self.bn_all)] + [
            (("convs", d), conv.bn) for d, conv in enumerate(self.convs)]
        for d, conv in enumerate(self.convs):
            yield ("params", "convs", d, "edge", "w"), conv.edge.w
            yield ("params", "convs", d, "edge", "b"), conv.edge.b
        for path, bn in bns:
            p = ("params",) + path + ("bn",) * (path[0] == "convs")
            yield p + ("gamma",), bn.gamma
            yield p + ("beta",), bn.beta
            yield ("bn_state",) + path + (0,), bn.running_mean
            yield ("bn_state",) + path + (1,), bn.running_var
            yield ("bn_state",) + path + (2,), bn.num_batches_tracked


def net_apply(model: GraphMET, batch: EventBatch, graph) -> torch.Tensor:
    """``Net``: sigmoid weights in (0, 1), zero at padded slots
    (reference model/net.py:45-47)."""
    w = torch.sigmoid(model(batch, graph))
    return torch.where(batch.mask, w, torch.zeros_like(w))
