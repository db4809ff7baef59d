"""Faults planted underneath the timed path, to show that the check sees
them: each is a context manager that patches the port (or torch's AdamW)
for its duration.  The benchmark's runs never plant one; its tests and
``calibrate.py --fault`` do.

* ``unchanged``: every optimizer step returns the state as it was;
* ``not_captured``: the optimizer step is left out of every chain but the
  first of each shape, which on the card runs eagerly: its capture, and
  so every replay, leaves the state as it was (on the CPU, where chains
  are loops, the same chains leave it so);
* ``half_batch``: the loss (both families' training loss, their
  evaluation MET) leaves out the second half of each batch's events and
  takes its mean over the rest;
* ``altered``: the first event of every evaluated batch gets its MET
  made 1 % larger where the step produces it;
* ``no_matching``: the DRN's matching pairs no node (each is its own
  partner and cluster).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _first_half(batch):
    B = batch.num_valid.shape[0]
    keep = torch.arange(B, device=batch.num_valid.device) < (B + 1) // 2
    return batch._replace(num_valid=torch.where(
        keep, batch.num_valid, torch.zeros_like(batch.num_valid)))


@contextlib.contextmanager
def plant(fault: str):
    import torch.optim.adam as adam_mod

    from deepmetv2_tpu_torch.train import loss as port_loss
    from deepmetv2_tpu_torch.train import step as port_step

    if fault == "unchanged":
        with patched(adam_mod, "adam", lambda *a, **k: None):
            yield
    elif fault == "not_captured":
        from deepmetv2_tpu_torch.train import chain as port_chain

        call, seen = port_chain.ChainedStep.__call__, set()

        def first_only(self, model, optimizer, stacked):
            key = tuple((tuple(f.shape), f.dtype) for f in stacked)
            if key not in seen:
                seen.add(key)
                return call(self, model, optimizer, stacked)
            with patched(adam_mod, "adam", lambda *a, **k: None):
                return call(self, model, optimizer, stacked)

        with patched(port_chain.ChainedStep, "__call__", first_only):
            yield
    elif fault == "no_matching":
        from deepmetv2_tpu_torch.models import drn as port_drn

        def unmatched(g, h, mask, *a, **k):
            B, N = mask.shape
            iota = torch.arange(N, device=mask.device).expand(B, N)
            return iota.clone(), iota.clone()

        with patched(port_drn, "cut_matching", unmatched):
            yield
    elif fault == "half_batch":
        loss_fn, neg_met = port_step.loss_fn, port_step._neg_weighted_met
        drn_met = port_loss.drn_met_vector

        def half_met(w, batch):
            v = neg_met(w, batch)
            return torch.where((_first_half(batch).num_valid > 0)[:, None],
                               v, torch.zeros_like(v))

        def half_drn(pred, head="polar"):
            v = drn_met(pred, head)
            keep = torch.arange(v.shape[0], device=v.device) < (
                v.shape[0] + 1) // 2
            return torch.where(keep[:, None], v, torch.zeros_like(v))

        drn_loss = port_step.drn_loss_fn
        with patched(port_step, "loss_fn",
                     lambda w, b: loss_fn(w, _first_half(b))), \
                patched(port_step, "drn_loss_fn",
                        lambda p, b, head="polar": drn_loss(
                            p, _first_half(b), head)), \
                patched(port_step, "_neg_weighted_met", half_met), \
                patched(port_loss, "drn_met_vector", half_drn), \
                patched(port_step, "drn_met_vector", half_drn):
            yield
    elif fault == "altered":
        neg_met, drn_met = port_step._neg_weighted_met, port_loss.drn_met_vector

        def bump(v):
            scale = torch.ones_like(v)
            scale[0] = 1.01
            return v * scale

        with patched(port_step, "_neg_weighted_met",
                     lambda w, b: bump(neg_met(w, b))), \
                patched(port_loss, "drn_met_vector",
                        lambda p, head="polar": bump(drn_met(p, head))), \
                patched(port_step, "drn_met_vector",
                        lambda p, head="polar": bump(drn_met(p, head))):
            yield
    else:
        raise ValueError(f"unknown fault {fault!r}")
