"""GraphMET's three categorical embeddings in plain PyTorch: the CPU path
and the oracle of the CUDA op (ops/cuda/cat_embed.py, csrc/cat_embed.cu).

``x_cat [..., 3]`` int32 holds (pdgId, charge, fromPV) per candidate; each
picks a row of its table by the index rule of ``cat_embed_indices``, and the
three rows are concatenated ``[charge | pdgId | fromPV]``.  The forward is
the model's composition as it stands (three ``embedding_apply`` lookups and
a ``cat``), so its output and its autograd gradients on the CPU are those
of that composition bit for bit.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from deepmetv2_tpu_torch.nn.core import embedding_apply


def pdg_remap(pdg: torch.Tensor, pdgs: Sequence[int]) -> torch.Tensor:
    """|pdgId| → its index in ``pdgs`` (the model's ``cfg.pdgs``); unknown
    ids (padding zeros included) → 0.  Compared with each id as a Python
    number: a table tensor would be a host-to-device copy in every step,
    which a captured CUDA graph cannot hold."""
    a = pdg.abs()
    matches = torch.stack([a == p for p in pdgs], dim=-1)
    return torch.argmax(matches.to(torch.int8), dim=-1)


def cat_embed_indices(x_cat: torch.Tensor, pdgs: Sequence[int]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(charge, pdgId, fromPV) table rows of each candidate:
    ``clamp(charge + 1, 0, 2)``, ``pdg_remap(pdgId, pdgs)``,
    ``clamp(fromPV, 0, 7)``."""
    return (torch.clamp(x_cat[..., 1] + 1, 0, 2),
            pdg_remap(x_cat[..., 0], pdgs),
            torch.clamp(x_cat[..., 2], 0, 7))


def cat_embed_torch(x_cat: torch.Tensor, w_charge: torch.Tensor,
                    w_pdg: torch.Tensor, w_pv: torch.Tensor,
                    pdgs: Sequence[int]) -> torch.Tensor:
    """``[..., 3D]``: the three tables' rows of each candidate,
    ``[charge | pdgId | fromPV]``; differentiable in the tables."""
    charge, pdg, pv = cat_embed_indices(x_cat, pdgs)
    return torch.cat([embedding_apply({"w": w_charge}, charge),
                      embedding_apply({"w": w_pdg}, pdg),
                      embedding_apply({"w": w_pv}, pv)], dim=-1)


def cat_embed_bwd_torch(x_cat: torch.Tensor, g: torch.Tensor, pdg_rows: int,
                        pdgs: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients ``[3, D]``, ``[pdg_rows, D]``, ``[8, D]`` of the three
    tables from ``g [..., 3D]``, the gradient of ``cat_embed_torch``'s
    output, in g's type: each table row sums the rows of g's slice whose
    candidates pick it, padded candidates included."""
    D = g.shape[-1] // 3
    out = []
    for t, (idx, rows) in enumerate(zip(cat_embed_indices(x_cat, pdgs),
                                        (3, pdg_rows, 8))):
        gt = g[..., t * D:(t + 1) * D].reshape(-1, D)
        out.append(torch.zeros((rows, D), dtype=g.dtype, device=g.device)
                   .index_add_(0, idx.reshape(-1).long(), gt))
    return tuple(out)
