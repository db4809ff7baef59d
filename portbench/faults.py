"""Faults planted underneath the timed path, to show that the check sees
them: each is a context manager that patches the port (or torch's AdamW)
for its duration.  The benchmark's runs never plant one; its tests and
``calibrate.py --fault`` do.

* ``unchanged``: every optimizer step returns the state as it was;
* ``not_captured``: the optimizer step is left out of every chain but the
  first of each shape, which on the card runs eagerly: its capture, and
  so every replay, leaves the state as it was (on the CPU, where chains
  are loops, the same chains leave it so);
* the faults a family's paths alone can have, each declared by its
  family file (``families/<family>.py``, ``FAULTS``): ``half_batch`` (the
  loss, and the evaluation MET, leave out the second half of each batch's
  events and take the mean over the rest), ``altered`` (the first event of
  every evaluated batch gets its MET made 1 % larger where the step
  produces it), ``no_matching`` (the DRN's matching pairs no node).  A
  fault is planted in every family that declares it.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import spec


@contextlib.contextmanager
def patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def first_half(batch):
    """The batch with the events of its second half marked empty."""
    B = batch.num_valid.shape[0]
    keep = torch.arange(B, device=batch.num_valid.device) < (B + 1) // 2
    return batch._replace(num_valid=torch.where(
        keep, batch.num_valid, torch.zeros_like(batch.num_valid)))


def bump(v: torch.Tensor) -> torch.Tensor:
    """``v`` with its first row made 1 % larger."""
    scale = torch.ones_like(v)
    scale[0] = 1.01
    return v * scale


@contextlib.contextmanager
def plant(fault: str):
    import torch.optim.adam as adam_mod

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
    else:
        planted = [mod.FAULTS[fault] for mod in spec.families()
                   if fault in getattr(mod, "FAULTS", {})]
        if not planted:
            raise ValueError(f"unknown fault {fault!r}")
        with contextlib.ExitStack() as stack:
            for make in planted:
                stack.enter_context(make())
            yield
