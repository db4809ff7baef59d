"""The DRN's graph decisions as the port makes them, recorded for the
check: each round's node mask, neighbour lists and matching, which the
reference follows and judges (reference/drn.py)."""

from __future__ import annotations

from typing import List

import torch

from portbench.reference import drn as ref_drn


class Recorder:
    """Records the graph decisions of the DRN's next ``forwards`` forwards
    by wrapping ``models.drn``'s graph build and matching; the wrappers
    return what they wrap, and unwrap themselves after the last round of
    the last of those forwards (or at ``restore``).  They refuse to run
    inside a graph capture: what they clone would become part of the
    graph.  ``calls`` holds one ``(mask, idx, valid, cluster, partner,
    feats)`` per round, each batched; ``feats``, the features the round's
    pooling compares, only in the first ``feats`` forwards (else None)."""

    def __init__(self, rounds: int, forwards: int = 1, feats: int = 0):
        from deepmetv2_tpu_torch.models import drn as port_drn

        self.mod, self.rounds = port_drn, rounds
        self.left = rounds * forwards
        self.keep_feats = rounds * feats
        self.build, self.cut = port_drn.build_dyn_graph, port_drn.cut_matching
        self.calls: List[tuple] = []
        port_drn.build_dyn_graph = self._build
        port_drn.cut_matching = self._cut

    def _build(self, *a, **k):
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("a recorded forward ran inside a graph capture")
        g = self.build(*a, **k)
        self.nbr = (g.nbr.idx.clone(), g.nbr.mask.clone())
        return g

    def _cut(self, g, h, mask, *a, **k):
        cluster, partner = self.cut(g, h, mask, *a, **k)
        feats = (h.detach().clone() if len(self.calls) < self.keep_feats
                 else None)
        self.calls.append((mask.clone(), *self.nbr, cluster.clone(),
                           partner.clone(), feats))
        self.left -= 1
        if self.left == 0:
            self.restore()
        return cluster, partner

    def restore(self) -> None:
        self.mod.build_dyn_graph, self.mod.cut_matching = self.build, self.cut

    def decisions(self, forward: int, event: int, device
                  ) -> List[ref_drn.Decisions]:
        """Event ``event``'s decisions in forward ``forward``, by round."""
        R = self.rounds
        return [ref_drn.Decisions(
            m[event].to(device),
            ref_drn.Lists(idx[event].to(device), valid[event].to(device)),
            c[event].to(device), p[event].to(device),
            None if f is None else f[event].to(device))
            for m, idx, valid, c, p, f in self.calls[forward * R:
                                                     (forward + 1) * R]]

    def width(self, forward: int) -> int:
        """The padded node width of forward ``forward``'s batch."""
        return int(self.calls[forward * self.rounds][0].shape[1])
