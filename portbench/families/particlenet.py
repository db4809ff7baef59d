"""ParticleNet (``models.particlenet.ParticleNet``): its leaves, its
training step as the training entry drives it, the check against the plain
reference (``reference/particlenet.py``) on the run's own neighbour lists
and dropout masks, the bounds and operations of its kernels (``counts/``),
and the faults that only its paths have.

The run's lists and masks of the checked steps come from the model's own
log (``ParticleNet.log_forwards``: written on the device inside the
replayed graphs); the first eager step's mask, which the first gradient
is judged with, from a hook on its dropout.  The control is the reference
with every product's operands rounded to TF32, in the program's place.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench import cell, faults, weights
from portbench.counts import knn, peaks
from portbench.counts import particlenet as pn_counts
from portbench.reference import particlenet as ref
from portbench.reference.common import Precision, Steps


def weight_spec(pn: dict) -> weights.Spec:
    """ParticleNet's leaves for the config's ``particlenet`` section (the
    port's state_dict names; 1x1 convolutions have no bias)."""
    leaves: weights.Spec = []

    def conv(name, a, b):
        leaves.append((f"{name}.w", (a, b), "uniform", 1.0 / a ** 0.5))

    cin = int(pn["input_dim"])
    weights.bn(leaves, "bn_fts", cin)
    for b, widths in enumerate(pn["conv_params"]):
        a = 2 * cin
        for layer, C in enumerate(widths):
            conv(f"blocks.{b}.convs.{layer}", a, int(C))
            weights.bn(leaves, f"blocks.{b}.bns.{layer}", int(C))
            a = int(C)
        conv(f"blocks.{b}.sc", cin, int(widths[-1]))
        weights.bn(leaves, f"blocks.{b}.sc_bn", int(widths[-1]))
        cin = int(widths[-1])
    fused, fusion = pn_counts.fusion_widths(pn["conv_params"])
    conv("fusion", fused, fusion)
    weights.bn(leaves, "fusion_bn", fusion)
    weights.linear(leaves, "fc", fusion, int(pn["fc"]))
    weights.linear(leaves, "out", int(pn["fc"]), 2)
    return leaves


class Train:
    """Batches as collated (each event's real candidates first), the
    directed kNN and the edge-block kernels; the reference follows the
    lists and dropout masks of the port's checked steps."""

    name = "particlenet"

    def __init__(self, r: cell.Run, events):
        from deepmetv2_tpu_torch.data.loader import METDataset, PaddedLoader
        from deepmetv2_tpu_torch.models.particlenet import ParticleNet

        self.r, cfgj, t = r, r.spec.config, r.spec.traffic
        self.loader = PaddedLoader(
            METDataset(events=events), np.arange(len(events)),
            int(t["batch"]), tuple(cfgj["data"]["node_buckets"]),
            "sequential")
        self.cfg = cell.port_config(cfgj, data={"batch_size": int(t["batch"])})
        self.leaves = weights.make(weight_spec(cfgj["particlenet"]), r.seed,
                                   r.device)
        self.model = ParticleNet(self.cfg.particlenet, device=r.device)
        self.model.load_state_dict(self.leaves)
        self.leaves = weights.clone(self.leaves)

    def watch(self, n: int) -> None:
        """Log the lists and masks of the first ``n`` training forwards
        after the weights are next set (the checked chains'), and keep the
        mask of the very next forward (the first eager step's)."""
        model = self.log = self.model
        model.log_forwards(n)
        self.first_keep = None

        def hook(module, args, out):
            if (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError("the first checked step ran inside a "
                                   "graph capture")
            self.first_keep = (None if module.keep is None
                               else module.keep.detach().clone())
            handle.remove()

        handle = model.dropout.register_forward_hook(hook)

    def _batches(self, batches, first: bool):
        out, dev = [], self.r.device
        for s, evs in enumerate(batches):
            xs = [torch.as_tensor(x, device=dev) for x, _ in evs]
            N = next(b for b in self.cfg.data.node_buckets
                     if b >= max(x.shape[0] for x in xs))
            lists, keep = self.log.logged(s, self.cfg.data.batch_size, N)
            if first:
                keep = self.first_keep
            per_event = [[ref.Lists(nb.idx[e, :x.shape[0]],
                                    nb.mask[e, :x.shape[0]])
                          for nb in lists] for e, x in enumerate(xs)]
            gen = torch.as_tensor(np.stack([y[:2] for _, y in evs]),
                                  device=dev)
            out.append(ref.Batch(xs, gen, per_event,
                                 None if keep is None else keep[:len(xs)]))
        return out

    def _steps(self, batches, prec: Precision) -> Steps:
        """The checked chain's steps on its logged lists and masks, and the
        first eager step (the same batch and lists, its own mask) for the
        first gradient and the parameters after it."""
        cfgj = self.r.spec.config
        tol = float(self.r.spec.limits["knn_tol"])
        chain = ref.train_steps(self.leaves, self._batches(batches, False),
                                cfgj["particlenet"], cfgj["optim"], prec, tol)
        first = ref.train_steps(self.leaves,
                                self._batches(batches[:1], True),
                                cfgj["particlenet"], cfgj["optim"], prec, tol)
        return Steps(chain.losses, first.first,
                     [first.after[0]] + chain.after, chain.moment,
                     chain.faults, chain.match)

    def reference(self, batches):
        """The reference's steps (and, for the control, the same with TF32
        operands in the program's place)."""
        got = self._steps(batches, Precision())
        control = (self._steps(batches, Precision(tf32=True))
                   if self.r.control else None)
        self.log = None
        return got, control

    def counts(self, host_batches) -> tuple:
        pn = self.r.spec.config["particlenet"]
        k = int(pn["k"])
        bound = ops = 0.0
        for b in host_batches:
            mask = np.asarray(b.mask)
            Bb, N = mask.shape
            ns = [int(n) for n in mask.sum(1) if n > 0]
            nodes, E = sum(ns), pn_counts.edges(ns, k)
            ops += pn_counts.train_ops(ns, pn)
            cin = int(pn["input_dim"])
            for i, widths in enumerate(pn["conv_params"]):
                C, H = int(widths[-1]), 2 if i == 0 else cin
                kops = knn.ops(ns, H)
                bound += (peaks.bound_s(knn.nbytes(ns, Bb, N, H), kops)
                          + peaks.bound_s(knn.nbytes(ns, Bb, N, H, k), kops))
                bound += (peaks.bound_s(pn_counts.fwd_bytes(nodes, Bb, N, k,
                                                            cin, C),
                                        pn_counts.fwd_ops(nodes, E, cin, C))
                          + peaks.bound_s(pn_counts.bwd_bytes(nodes, Bb, N, k,
                                                              cin, C),
                                          pn_counts.bwd_ops(nodes, E, cin,
                                                            C)))
                cin = C
        return bound, ops


@contextlib.contextmanager
def _half_batch():
    """The training loss over the first half of each batch's events."""
    from deepmetv2_tpu_torch.train import step as port_step

    loss = port_step.drn_loss_fn
    with faults.patched(port_step, "drn_loss_fn",
                        lambda p, b, head="polar": loss(
                            p, faults.first_half(b), head)):
        yield


@contextlib.contextmanager
def _altered():
    """The first event's MET of every batch made 1 % larger where the
    model produces it."""
    from deepmetv2_tpu_torch.models import particlenet as port_pn

    apply = port_pn.particlenet_apply
    with faults.patched(port_pn, "particlenet_apply",
                        lambda *a, **k: faults.bump(apply(*a, **k))):
        yield


@contextlib.contextmanager
def _no_dropout():
    """Training without the dropout it was configured with: the masks are
    drawn (and logged) but not applied."""
    from deepmetv2_tpu_torch.models import particlenet as port_pn

    with faults.patched(port_pn, "apply_dropout", lambda h, keep, p: h):
        yield


FAULTS = {"half_batch": _half_batch, "altered": _altered,
          "no_dropout": _no_dropout}
