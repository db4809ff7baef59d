"""The training entry: the configured recipe over a resident epoch, epoch
after epoch through ``train.loop.train_one_epoch``, as ``fit`` drives it
(no validation, no checkpoint).

Set-up builds one training object (model, AdamW, the chained step, the
resident feed) and drives it from the seed: the first epoch runs each
(shape, chain length) eagerly once and captures its CUDA graph at its next
chain, the second captures the rest.  Then the model's parameters and
buffers are set back to the seed's and AdamW's state to its start, in
place (the graphs hold those tensors), and a third epoch runs by replays
alone.  Its first chains, up to ``check_steps`` steps or a few more, are
the ones the check judges: their steps' losses, and the parameters and
AdamW's first moment after them, as the window's own call leaves them.
The check also reads the first eager step of the first epoch (the same
batch, from the same state): the first gradient as AdamW holds it after
one step (its first moment over 1 - beta1) and the parameters after it,
read by an optimizer hook that removes itself after that step and refuses
to run inside a graph capture.  The reference follows the first chain's
steps from the seed's weights.

A ``--trace 1`` run traces ``trace_epochs`` epochs instead of the window.

The model comes from the configuration's family
(``families/<family>.py``), whose class ``Train(run, events)`` has
``model``, ``loader``, ``cfg`` (the port's ``Config``), ``leaves`` (the
seed's parameters and buffers), ``name`` (the port's model for
``make_chained_train_step``), ``watch(n)`` (record what the reference
needs of the first ``n`` forwards), ``reference(batches)`` (the
reference's ``Steps`` over the checked batches, and the control's in the
program's place or None) and ``counts(host_batches)`` (one epoch's kernel
bound in seconds and the model's operations).
"""

from __future__ import annotations

import statistics
import time
from typing import Dict

import numpy as np
import torch

from portbench import cell, spec, tracing
from portbench.gen import events as gen
from portbench.reference.common import Steps

ROLE = "Train"      # the class of the family this entry drives



class FirstStep:
    """Optimizer post-step hook: AdamW's first moments and the parameters
    after the next step, by parameter name; it removes itself after that
    step and refuses to run inside a graph capture."""

    def __init__(self, model: torch.nn.Module, opt: torch.optim.Optimizer):
        self.names = {p: k for k, p in model.named_parameters()}
        self.moment: Dict[str, torch.Tensor] = {}
        self.params: Dict[str, torch.Tensor] = {}
        self.handle = opt.register_step_post_hook(self)

    def __call__(self, opt, args, kwargs) -> None:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError("a checked step ran inside a graph capture")
        self.moment = state_of(opt, self.names, "exp_avg")
        self.params = {k: p.detach().clone() for p, k in self.names.items()}
        self.handle.remove()


def state_of(opt: torch.optim.Optimizer, names: dict, key: str
             ) -> Dict[str, torch.Tensor]:
    """A copy of AdamW's state ``key`` of each parameter, by name."""
    return {names[p]: opt.state[p][key].clone()
            for g in opt.param_groups for p in g["params"]}


def restart(model: torch.nn.Module, opt: torch.optim.Optimizer,
            leaves: Dict[str, torch.Tensor]) -> None:
    """The seed's parameters and buffers, and AdamW's state at its start
    (its moments and step counts zero, as its first step makes them), all
    written in place: the captured graphs hold these tensors."""
    with torch.no_grad():
        model.load_state_dict(leaves)
        for st in opt.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    v.zero_()


def run(r: cell.Run) -> cell.Outcome:
    from deepmetv2_tpu_torch.train.chain import (chain_batches, chain_length,
                                                 make_chained_train_step)
    from deepmetv2_tpu_torch.train.loop import train_one_epoch
    from deepmetv2_tpu_torch.train.resident import ResidentFeed
    from deepmetv2_tpu_torch.train.step import make_optimizer

    t, dev = r.spec.traffic, r.device
    reading = cell.Reading(entry="train")
    B = int(t["batch"])
    events = gen.make_events(t, r.seed)
    fam = spec.family(r.spec.config["family"], ROLE)(r, events)
    model, loader, cfg = fam.model, fam.loader, fam.cfg
    opt = make_optimizer(cfg, model)
    chain = max(1, cfg.train.chain_steps)
    step = make_chained_train_step(cfg, fam.name)
    feed = ResidentFeed(loader, chain=chain, place=dev)
    chains = list(chain_batches(iter(loader), chain))
    K = 0                                   # the steps of the checked chains
    for c in chains:
        if K >= int(t["check_steps"]):
            break
        K += chain_length(c) if chain > 1 else 1
    names = {p: k for k, p in model.named_parameters()}
    eager = FirstStep(model, opt)
    fam.watch(K)
    checked: dict = {}

    def stepped(m, o, batch):
        replays = getattr(step, "replays", 0)
        with tracing.span("step"):
            loss = step(m, o, batch)
        if checked.get("pending"):             # a checked chain
            checked["losses"].append(loss.detach().reshape(-1).clone())
            checked["replayed"] &= getattr(step, "replays", 0) > replays
            if sum(x.numel() for x in checked["losses"]) >= K:
                checked.update(
                    pending=False,
                    params={k: p.detach().clone() for p, k in names.items()},
                    moment=state_of(o, names, "exp_avg"))
        return loss

    def epoch(i: int) -> float:
        with tracing.span("driver.epoch"):
            return train_one_epoch(model, opt, stepped, feed, i, dev,
                                   verbose=False, chain=chain)

    for i in (1, 2):                        # eager, then every capture
        epoch(i)
    if dev.type == "cuda":
        keys = {tuple(np.shape(f) for f in s) for s in chains}
        if step.n_graphs != len(keys):
            raise RuntimeError(f"set-up captured {step.n_graphs} graphs for "
                               f"{len(keys)} chain shapes")
    restart(model, opt, fam.leaves)
    checked.update(pending=True, losses=[], replayed=True)
    epoch(3)                                # replays only; the first checked
    if dev.type == "cuda" and not checked["replayed"]:
        raise RuntimeError("a checked chain did not replay its graph")
    cell.sync(dev)
    reading.setup_s = time.perf_counter() - r.t0
    per_epoch = sum(int(np.sum(np.asarray(b.num_valid) > 0)) for b in loader)

    n_epochs, bad, ep = 0, 0, 4
    before = cell.launch_counts()
    tl_out: dict = {}
    if r.trace:
        with tracing.traced(tl_out):
            t0 = time.perf_counter()
            with tracing.span("window"):
                for _ in range(int(t["trace_epochs"])):
                    bad += not np.isfinite(epoch(ep))
                    ep += 1
                    n_epochs += 1
                cell.sync(dev)
            reading.trace_window_s = time.perf_counter() - t0
    else:
        t0 = time.perf_counter()
        while True:
            bad += not np.isfinite(epoch(ep))
            ep += 1
            n_epochs += 1
            if time.perf_counter() - t0 >= r.seconds:
                break
        cell.sync(dev)
        reading.window_s = time.perf_counter() - t0
    launches = cell.delta(cell.launch_counts(), before)
    reading.events = n_epochs * per_epoch
    peak = cell.peak_bytes(dev)

    def f64(d):
        return {k: v.double().cpu() for k, v in d.items()}

    port = Steps(torch.cat(checked["losses"]).double().cpu().tolist(),
                 {k: v / (1 - cfg.optim.betas[0])
                  for k, v in f64(eager.moment).items()},
                 [f64(eager.params), f64(checked["params"])],
                 f64(checked["moment"]), [], [])
    host_batches = list(loader)
    del model, opt, step, feed, eager, checked, names
    fam.model = None
    cell.free(dev)

    out = cell.Outcome(reading, {}, reading.events, bad * per_epoch, peak)
    if r.trace:
        trace_readings(out, tl_out.get("timeline"), launches, n_epochs,
                       fam.counts(host_batches))
    with cell.deterministic():
        ref_steps, control = fam.reference(
            [events[s * B:(s + 1) * B] for s in range(K)])
    if control is not None:                # the control in the port's place
        port = Steps(control.losses, f64(control.first),
                     [f64(control.after[0]), f64(control.after[-1])],
                     f64(control.moment), [], [])
    values = compare(port, ref_steps, fam.leaves, out.notes)
    # the first step's decisions were made with the parameters the
    # reference starts from; the later steps' with the port's own, which
    # the reference's need not match (an opposite-sign first update)
    values["graph_faults"] = float(ref_steps.faults[0])
    values["match_gap"] = ref_steps.match[0]
    out.notes.append(f"graph faults by step: {ref_steps.faults}; matching "
                     f"gaps: " + ", ".join(f"{g:.3g}"
                                           for g in ref_steps.match))
    out.notes.append("numbers: " + ", ".join(f"{k} {v:.3g}"
                                              for k, v in values.items()))
    out.checks = cell.judge(values, r.spec.limits)
    return out


def leaf_gaps(port: Dict[str, float], ref: Dict[str, float]
              ) -> Dict[str, float]:
    """Per leaf, the gap between the port's and the reference's norm over
    the larger of the reference leaf's norm and the median leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(port[k] - ref[k]) / max(ref[k], med) for k in ref}


def compare(port: Steps, ref: Steps, leaves, notes: list
            ) -> Dict[str, float]:
    """The check's numbers (a cell's limits file names those it compares).
    ``port``: the checked chains' losses, the first eager step's gradient,
    the parameters after that step and after the chains, and AdamW's first
    moment after them; ``ref``: the reference's steps over the chains'
    batches.

    * ``loss_rel``: the relative gap of the first checked loss;
    * ``grad_gap``: the worst leaf's gap between the norms of the port's
      and the reference's first gradient (``leaf_gaps``);
    * ``change_gap``, ``change_med``: the worst and the median leaf's gap
      of the parameters' change made by the first step;
    * ``chain_change``, ``chain_moment``: the median leaf's gap of the
      change made by the checked chains' steps, and of AdamW's first
      moment after them.

    The later steps are less steady from seed to seed: Adam's first step
    moves each element by lr times the sign of its gradient, so an element
    whose gradient is at rounding level moves the other way on one side,
    and the later steps start from different parameters.  So the chain's
    numbers are the median leaf's, and its later losses go to ``notes``
    with the worst leaves and the elements whose first update has opposite
    signs.  Leaves whose reference gradient is under a thousandth of the
    median leaf's move by rounding alone and are left out."""
    steps = [cell.rel_gap(float(a), b)
             for a, b in zip(port.losses, ref.losses)]
    notes.append("loss gaps by step: " + ", ".join(f"{g:.3g}" for g in steps))
    g_ref = {k: float(v.double().norm()) for k, v in ref.first.items()}
    med = statistics.median(g_ref.values())
    kept = [k for k, v in g_ref.items() if v >= 1e-3 * med]

    def norms(d):
        return {k: float(d[k].double().cpu().norm()) for k in kept}

    start = {k: leaves[k].double().cpu() for k in kept}

    def change(snap):
        return {k: float((snap[k].double().cpu() - start[k]).norm())
                for k in kept}

    grad = leaf_gaps(norms(port.first), norms(ref.first))
    first = leaf_gaps(change(port.after[0]), change(ref.after[0]))
    whole = leaf_gaps(change(port.after[-1]), change(ref.after[-1]))
    moment = leaf_gaps(norms(port.moment), norms(ref.moment))
    flips = sum(int(((torch.sign(port.first[k].double().cpu()) != torch.sign(
        ref.first[k].double().cpu())) & (ref.first[k] != 0).cpu()).sum())
        for k in kept)
    for name, gaps in (("grad", grad), ("first change", first),
                       (f"change over {len(ref.losses)} steps", whole),
                       ("moment after them", moment)):
        worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
        notes.append(f"{name}: median leaf {statistics.median(gaps.values()):.3g}"
                     f", worst " + ", ".join(f"{k} {gaps[k]:.3g}"
                                             for k in worst))
    notes.append(f"first updates of opposite sign: {flips} elements; left "
                 f"out (reference gradient under 1e-3 of the median leaf's "
                 f"{med:.3g}): {sorted(set(g_ref) - set(kept))}")
    return {"loss_rel": steps[0], "grad_gap": max(grad.values()),
            "change_gap": max(first.values()),
            "change_med": statistics.median(first.values()),
            "chain_change": statistics.median(whole.values()),
            "chain_moment": statistics.median(moment.values())}


def trace_readings(out: cell.Outcome, tl, launches, n_epochs: int,
                   counts: tuple) -> None:
    """The traced epochs' per-layer numbers: busy time, the port's kernels
    against their bounds (``counts``: one epoch's bound and operations),
    the step's operations."""
    rd = out.reading
    pats = cell.kernel_patterns()
    rd.covers, seen = tracing.coverage(tl, launches, pats["per_wrapper"])
    out.notes.append(f"trace coverage (counter, trace): {seen}")
    if tl is None:
        return
    rd.busy_s = tl.busy_s()
    rd.port_kernel_s = tl.matching(pats["port"])[0]
    rd.bound_s, rd.ops = counts[0] * n_epochs, counts[1] * n_epochs
    out.breakdown = {"device_ops": [list(x) for x in tl.top_ops()],
                     "idle_gaps": [list(x) for x in tl.idle_by_host()]}
