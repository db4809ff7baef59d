#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (deepmetv2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one line:
  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel source in csrc/, one nvcc each, in parallel;
  3. kernel: window_max forward against its plain PyTorch version, bitwise,
     on (a) the evaluation shape, (b) clustered eta with value ties and
     pairs on the radius boundary, (c) padded nodes and empty events; with
     the kernel's time, the plain version's and the card's lower bound, at
     the evaluation shape and at the training shape (cell order, halo 192);
  4. kernel_bwd: window_max backward against its plain version, bitwise, on
     the same cases (every tied source takes the full gradient), the
     gradients of x, w and b through the EdgeConv wrapper against the plain
     path, and the backward's time at the training shape;
  5. evaluate: the port's evaluate CLI on 2000 synthetic events with the
     committed JAX weights (ckpts_syn/best.ckpt), held to the JAX package's
     validation loss, with the kernels' launches counted;
  6. predict: the port's predict CLI over the same 2000 events;
  7. train_resume: 10 train steps from ckpts_syn/best.ckpt (weights,
     BatchNorm state, AdamW moments, scheduler), each loss held to the JAX
     package's;
  8. train: the port's train CLI, 2 epochs on synthetic 2000 and a resume
     to 3, with the exact launch counts, the artifacts, and its best.ckpt
     re-evaluated by the evaluate CLI;
  9. profile: one evaluation step's and one train step's device time by
     kernel (torch.profiler);
then a JSON line of every ported kernel and, last, the device JSON line.
Any failed check exits non-zero before the last line.  Writes only under
build/ in the checkout.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_LOSS = 1.0319761037826538   # JAX package, cli.evaluate --synthetic 2000
LOSS_RTOL = 1e-4
# JAX package, make_train_step from ckpts_syn/best.ckpt on the first 10
# cell-sorted train batches of synthetic 2000 (seed 42, batch 8, halo 192),
# on the CPU: tests/test_torch_train.py:jax_resume_losses(10)
GOLDEN_TRAIN_LOSSES = (
    1.3795247077941895, 0.6131638288497925, 1.4182462692260742,
    0.6025028228759766, 0.8353334665298462, 0.8708364963531494,
    0.63520348072052, 0.5926302075386047, 1.1002800464630127,
    0.6679131984710693)
REEVAL_RTOL = 1e-6   # train CLI's metrics_val_best.json against cli.evaluate
GRAD_RTOL, GRAD_ATOL = 1e-5, 2e-6   # atol times the largest |gradient|
R = 0.4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM, FP32 outside the tensor cores
TRAIN_B, TRAIN_N, TRAIN_HALO = 8, 2048, 192


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, **kv) -> None:
    print(f"{phase}: " + json.dumps(kv), flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def bitwise_equal(a, b) -> bool:
    import torch

    # +0.0 turns -0.0 into +0.0, so only the sign of a zero is forgiven
    return torch.equal((a + 0.0).view(torch.int32), (b + 0.0).view(torch.int32))


def n_differ(a, b) -> int:
    import torch

    return int(((a + 0.0).view(torch.int32) != (b + 0.0).view(torch.int32)).sum())


def window_work(pos, mask, halo: int, r2: float):
    """(window pairs, adjacent pairs) with a real query row (``mask``): the
    predicates and the selections the data needs; padded rows' outputs are
    discarded by the caller.  The backward's count is the same with source
    and query swapped (the window and the predicate are symmetric)."""
    import torch
    from deepmetv2_tpu_torch.ops.window import adjacent

    B, N, _ = pos.shape
    i = torch.arange(N, device=pos.device)
    span = torch.clamp(i + halo, max=N - 1) - torch.clamp(i - halo, min=0) + 1
    pairs = int((span[None, :] * mask).sum())
    eta, phi = pos[..., 0], pos[..., 1]
    adj = 0
    for d in range(min(halo, N - 1) + 1):
        a = adjacent(eta[:, d:], phi[:, d:], eta[:, :N - d], phi[:, :N - d], r2)
        adj += int((a & mask[:, d:]).sum())            # query i + d
        if d:
            adj += int((a & mask[:, :N - d]).sum())    # query i
    return pairs, adj


def bound(nbytes: int, ops: int):
    """(bound ms, what bounds it, bytes ms, ops ms) on an H100 SXM."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            t_bytes, t_ops)


def padded_pos(etaphi, mask):
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import PAD_POS

    return torch.where(mask[..., None], etaphi, torch.full_like(etaphi, PAD_POS))


def isolated_pos(etaphi, mask):
    """Padded rows each at its own far coordinate: they then have no
    neighbours, which isolates what they cost a kernel."""
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import PAD_POS

    B, N, _ = etaphi.shape
    far = PAD_POS + 1000.0 * torch.arange(N, device=etaphi.device,
                                          dtype=torch.float32)
    return torch.where(mask[..., None], etaphi,
                       far[None, :, None].expand(B, N, 2))


def batch_etaphi(batch):
    import torch

    phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
    return torch.stack([batch.x_cont[..., 3], phi], dim=-1)


def train_shape_batch(device):
    """A cell-sorted batch at the training shape: 8 synthetic events padded
    to N=2048, in the train CLI's order."""
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
    from deepmetv2_tpu_torch.data.sorting import cell_sort_batch

    host = cell_sort_batch(collate(synthetic_events(TRAIN_B, seed=7),
                                   pad_to=TRAIN_N), r=R)
    return to_device(host, device)


def kernel_phase(device):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
    from deepmetv2_tpu_torch.data.sorting import sort_by_eta
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        window_edgeconv_linear_cuda, window_max)
    from deepmetv2_tpu_torch.ops.window import (WindowGraph,
                                                window_edgeconv_linear,
                                                window_max_torch)

    rng = np.random.default_rng(0)
    r2 = R ** 2
    B, N, H, halo = 40, 2048, 32, 128

    def check(name, c, pos, halo):
        ones = torch.ones(c.shape[:2], dtype=torch.bool, device=c.device)
        m = window_max(c, pos, r2, halo)
        t = window_max_torch(c, pos, ones, r2, halo)
        torch.cuda.synchronize()
        if not bitwise_equal(m, t):
            fail(f"window_max case {name}: {n_differ(m, t)} entries differ "
                 "from the plain version")
        fin = torch.isfinite(t)
        return float((m[fin] - t[fin]).abs().max()) if fin.any() else 0.0

    # (a) evaluation shape: an eta-sorted synthetic batch
    batch = to_device(collate(synthetic_events(B, seed=7), pad_to=N), device)
    batch, _ = sort_by_eta(batch)
    etaphi = batch_etaphi(batch)
    pos_a = padded_pos(etaphi, batch.mask)
    c_a = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                          device=device)
    errs = [check("a", c_a, pos_a, halo)]

    # (b) clustered eta on a 0.1 lattice (pairs exactly on the radius
    # boundary), values rounded to 0.1 (exact ties), wide halo
    Bb = 8
    eta = np.sort(rng.choice([-4.0, 0.0, 4.0], size=(Bb, N))
                  + np.round(rng.normal(0, 0.3, (Bb, N)), 1), axis=1)
    phi_b = np.round(rng.uniform(-np.pi, np.pi, (Bb, N)), 1)
    pos_b = torch.as_tensor(np.stack([eta, phi_b], -1).astype(np.float32),
                            device=device)
    c_b = torch.as_tensor(np.round(rng.normal(size=(Bb, N, H)), 1)
                          .astype(np.float32), device=device)
    errs.append(check("b", c_b, pos_b, 192))

    # (c) padded nodes and empty events, through the whole EdgeConv wrapper
    nv = rng.integers(0, N, size=B)
    nv[::7] = 0                                      # empty padded events
    mask_c = batch.mask & torch.as_tensor(
        np.arange(N)[None, :] < nv[:, None], device=device)
    pos_c = padded_pos(etaphi, mask_c)
    errs.append(check("c", c_a, pos_c, halo))
    x = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                        device=device)
    w = torch.as_tensor(rng.normal(size=(2 * H, H)).astype(np.float32) * 0.1,
                        device=device)
    bias = torch.as_tensor(rng.normal(size=(H,)).astype(np.float32),
                           device=device)
    g = WindowGraph(etaphi, mask_c, r=R, halo=halo)
    with torch.no_grad():
        out_k = window_edgeconv_linear_cuda(x, g, w, bias)
        out_t = window_edgeconv_linear(x, g, w, bias)
    if not bitwise_equal(out_k, out_t):
        fail("window_edgeconv_linear_cuda differs from the plain version")
    if bool((out_k[~mask_c] != 0).any()):
        fail("window_edgeconv_linear_cuda is not 0 at padded nodes")

    ones = torch.ones(B, N, dtype=torch.bool, device=device)
    ms = cuda_ms(lambda: window_max(c_a, pos_a, r2, halo), 50)
    plain_ms = cuda_ms(lambda: window_max_torch(c_a, pos_a, ones, r2, halo), 5)
    pos_iso = isolated_pos(etaphi, batch.mask)
    isolated_ms = cuda_ms(lambda: window_max(c_a, pos_iso, r2, halo), 50)
    pairs, adj = window_work(pos_a, batch.mask, halo, r2)
    nbytes = 4 * (c_a.numel() + pos_a.numel() + c_a.numel())
    ops = 6 * pairs + H * adj     # predicate: 2 sub, 2 mul, add, compare
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)

    # the training shape: cell order, halo 192, 8 events
    tb = train_shape_batch(device)
    tpos = padded_pos(batch_etaphi(tb), tb.mask)
    tc = torch.as_tensor(rng.normal(size=(TRAIN_B, TRAIN_N, H))
                         .astype(np.float32), device=device)
    t_ms = cuda_ms(lambda: window_max(tc, tpos, r2, TRAIN_HALO), 50)
    t_iso = isolated_pos(batch_etaphi(tb), tb.mask)
    t_iso_ms = cuda_ms(lambda: window_max(tc, t_iso, r2, TRAIN_HALO), 50)
    t_pairs, t_adj = window_work(tpos, tb.mask, TRAIN_HALO, r2)
    t_bound = bound(4 * (2 * tc.numel() + tpos.numel()),
                    6 * t_pairs + H * t_adj)
    say("kernel", name="window_max_fwd", cases="a,b,c bitwise equal",
        shape=[B, N, H], halo=halo, real_rows=int(batch.mask.sum()),
        ms=ms, plain_ms=plain_ms, padded_rows_isolated_ms=isolated_ms,
        bytes=nbytes, window_pairs=pairs, adjacent_pairs=adj, fp32_ops=ops,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        train_shape=[TRAIN_B, TRAIN_N, H], train_halo=TRAIN_HALO,
        train_real_rows=int(tb.mask.sum()), train_ms=t_ms,
        train_padded_rows_isolated_ms=t_iso_ms, train_window_pairs=t_pairs,
        train_adjacent_pairs=t_adj, train_bound_ms=t_bound[0])
    cases = {"a": (c_a, pos_a, halo), "b": (c_b, pos_b, 192),
             "c": (c_a, pos_c, halo)}
    return cases, (x, g, w, bias), {
        "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by}


def kernel_bwd_phase(device, cases, edge_args):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        window_edgeconv_linear_cuda, window_max, window_max_bwd)
    from deepmetv2_tpu_torch.ops.window import (window_edgeconv_linear,
                                                window_max_bwd_torch)

    rng = np.random.default_rng(1)
    r2 = R ** 2
    errs, ties = [], {}
    for name, (c, pos, halo) in cases.items():
        m = window_max(c, pos, r2, halo)
        g = torch.as_tensor(rng.normal(size=tuple(c.shape)).astype(np.float32),
                            device=device)
        dk = window_max_bwd(c, pos, m, g, r2, halo)
        dt = window_max_bwd_torch(c, pos, m, g, r2, halo)
        torch.cuda.synchronize()
        if not bitwise_equal(dk, dt):
            fail(f"window_max_bwd case {name}: {n_differ(dk, dt)} entries "
                 "differ from the plain version")
        errs.append(float((dk - dt).abs().max()))
        # with g = 1 each source counts the queries whose max it equals: a
        # tie gives every tied source a full count, so the total exceeds
        # the number of finite maxima by the extra tied sources
        ones = window_max_bwd(c, pos, m, torch.ones_like(m), r2, halo)
        ties[name] = int(ones.double().sum().item()
                         - torch.isfinite(m).sum().item())
    if ties["b"] <= 0:
        fail("case b has no tied maxima: the tie rule was not exercised")

    # gradients of x, w and b through the EdgeConv wrapper (kernels) against
    # the plain path's autograd (no ties in these random values)
    x, g, w, bias = edge_args
    G = torch.as_tensor(rng.normal(size=tuple(x.shape)).astype(np.float32),
                        device=device)
    grads = []
    for fn in (window_edgeconv_linear_cuda, window_edgeconv_linear):
        args = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        (fn(args[0], g, args[1], args[2]) * G).sum().backward()
        grads.append([a.grad for a in args])
    grad_err = 0.0
    for name, k, t in zip(("x", "w", "b"), *grads):
        tol = GRAD_RTOL * t.abs() + GRAD_ATOL * float(t.abs().max())
        if not bool(((k - t).abs() <= tol).all()):
            fail(f"gradient of {name} through window_edgeconv_linear_cuda "
                 f"differs from the plain path by {float((k - t).abs().max())}")
        grad_err = max(grad_err, float((k - t).abs().max()))

    # the training shape: cell order, halo 192, B=8, N=2048, H=32
    tb = train_shape_batch(device)
    etaphi = batch_etaphi(tb)
    pos = padded_pos(etaphi, tb.mask)
    H = x.shape[-1]
    c = torch.as_tensor(rng.normal(size=(TRAIN_B, TRAIN_N, H))
                        .astype(np.float32), device=device)
    m = window_max(c, pos, r2, TRAIN_HALO)
    gr = torch.as_tensor(rng.normal(size=tuple(c.shape)).astype(np.float32),
                         device=device) * tb.mask[..., None]   # 0 at padding
    ms = cuda_ms(lambda: window_max_bwd(c, pos, m, gr, r2, TRAIN_HALO), 50)
    plain_ms = cuda_ms(
        lambda: window_max_bwd_torch(c, pos, m, gr, r2, TRAIN_HALO), 3)
    pos_iso = isolated_pos(etaphi, tb.mask)
    m_iso = window_max(c, pos_iso, r2, TRAIN_HALO)
    iso_ms = cuda_ms(
        lambda: window_max_bwd(c, pos_iso, m_iso, gr, r2, TRAIN_HALO), 50)
    pairs, adj = window_work(pos, tb.mask, TRAIN_HALO, r2)
    nbytes = 4 * (4 * c.numel() + pos.numel())       # c, m, g, dc; pos
    ops = 6 * pairs + 2 * H * adj   # predicate; compare and add per feature
    bound_ms, bound_by, t_bytes, t_ops = bound(nbytes, ops)
    say("kernel_bwd", name="window_max_bwd", cases="a,b,c bitwise equal",
        extra_tied_sources=ties, edgeconv_grad_max_abs_err=grad_err,
        shape=[TRAIN_B, TRAIN_N, H], halo=TRAIN_HALO,
        real_rows=int(tb.mask.sum()), ms=ms, plain_ms=plain_ms,
        padded_rows_isolated_ms=iso_ms, bytes=nbytes, window_pairs=pairs,
        adjacent_pairs=adj, fp32_ops=ops, bound_bytes_ms=t_bytes,
        bound_ops_ms=t_ops)
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def step_profile(step, reps: int = 5):
    """(device ms per step, kernels per step, top kernels) of ``step``
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            kernels.append((us / reps / 1e3, e.count // reps, e.key[:48]))
    kernels.sort(reverse=True)
    return (sum(k[0] for k in kernels), sum(k[1] for k in kernels),
            [{"ms": k[0], "calls": k[1], "name": k[2]} for k in kernels[:8]])


def profile_phase(device, ck: str) -> None:
    """Where one evaluation step's (40 events, N=2048, halo 128, eta sort)
    and one train step's (8 events, N=2048, halo 192, cell order) device
    time goes: step time from CUDA events, device time by kernel from
    torch.profiler."""
    import dataclasses
    import itertools

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.step import (make_eval_step,
                                                make_optimizer,
                                                make_train_step)

    cfg = load_run_config(ck)
    events = synthetic_events(2000, seed=42)
    ecfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=128))
    tcfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=TRAIN_HALO, presorted=True))
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(tcfg, model)
    restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt)
    batch = to_device(next(iter(fetch_dataloader(events=events,
                                                 batch_size=40)["test"])),
                      device)
    eval_step = make_eval_step(ecfg)
    step_ms = cuda_ms(lambda: eval_step(model, batch), 20)
    dev_ms, n_k, top = step_profile(lambda: eval_step(model, batch))
    say("profile", step="eval", batch=[batch.batch_size, batch.max_nodes],
        step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k, top=top)

    ld = fetch_dataloader(events=events, batch_size=TRAIN_B,
                          presort_eta=True, presort_mode="cell")["train"]
    batch = to_device(next(itertools.islice(iter(ld), 1)), device)
    train_step = make_train_step(tcfg)
    step_ms = cuda_ms(lambda: train_step(model, opt, batch), 20)
    dev_ms, n_k, top = step_profile(lambda: train_step(model, opt, batch))
    say("profile", step="train", batch=[batch.batch_size, batch.max_nodes],
        step_ms=step_ms, device_ms=dev_ms, device_busy_share=dev_ms / step_ms,
        device_idle_share=1 - dev_ms / step_ms, kernels_per_step=n_k, top=top)


def train_resume_phase(device) -> None:
    """10 train steps from the committed JAX checkpoint, each loss held to
    GOLDEN_TRAIN_LOSSES (a lost AdamW count or moment shows at step 2)."""
    import dataclasses
    import itertools

    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import restore_checkpoint
    from deepmetv2_tpu_torch.train.schedule import ReduceLROnPlateau
    from deepmetv2_tpu_torch.train.step import (make_optimizer,
                                                make_train_step)

    ck = os.path.join(HERE, "ckpts_syn")
    cfg = load_run_config(ck)
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=TRAIN_HALO, presorted=True))
    model = GraphMET(cfg.model, device=device)
    opt = make_optimizer(cfg, model)
    sched = ReduceLROnPlateau(lr=cfg.optim.lr)
    payload = restore_checkpoint(os.path.join(ck, "best.ckpt"), model, opt,
                                 sched)
    ld = fetch_dataloader(events=synthetic_events(2000, seed=42),
                          batch_size=TRAIN_B, presort_eta=True,
                          presort_mode="cell")["train"]
    step = make_train_step(cfg)
    losses = [float(step(model, opt, to_device(b, device)))
              for b in itertools.islice(iter(ld), len(GOLDEN_TRAIN_LOSSES))]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, GOLDEN_TRAIN_LOSSES)]
    say("train_resume", epoch=payload["epoch"], adam_count=payload["step"],
        sched_best=sched.best, losses=losses, golden=GOLDEN_TRAIN_LOSSES,
        max_rel_err=max(rel))
    if not max(rel) <= LOSS_RTOL:
        fail(f"resumed train losses are not within {LOSS_RTOL} of the JAX "
             f"package's: {losses}")


def train_phase(work: str):
    """The train CLI: 2 epochs into build/smoke/train, then a resume to 3
    epochs; exact launch counts; artifacts; the best checkpoint re-evaluated
    by the evaluate CLI.  Returns (forward launches, backward launches)."""
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import train as train_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)

    ck = os.path.join(work, "train")
    base = ["--synthetic", "2000", "--batch_size", str(TRAIN_B), "--ckpts", ck]
    steps, evals, convs = 200, 50, 2          # per epoch: 1600 / 8, 400 / 8
    fwd = bwd = 0
    for argv, epochs in ((["--epochs", "2"], 2),
                         (["--epochs", "3", "--restore_file", "last"], 1)):
        window_max.launches = window_max_bwd.launches = 0
        out = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_cli.main(base + argv)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        text = out.getvalue()
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("graph mode", "Training epoch", "- Eval",
                                   "Restarting"))]
        say("train", argv=argv, seconds=sec, fwd_launches=window_max.launches,
            bwd_launches=window_max_bwd.launches, log=lines)
        if rc != 0:
            fail(f"train CLI {argv} exited {rc}")
        if f"graph mode: window (halo {TRAIN_HALO}, order cell)" not in text:
            fail(f"train CLI did not print halo {TRAIN_HALO}, order cell")
        want_f = epochs * (steps * convs + evals * convs)
        want_b = epochs * steps * convs
        if (window_max.launches, window_max_bwd.launches) != (want_f, want_b):
            fail(f"train CLI {argv}: launches forward {window_max.launches}, "
                 f"backward {window_max_bwd.launches}; want {want_f}, {want_b}")
        fwd += window_max.launches
        bwd += window_max_bwd.launches
    for f in ("loss.log", "metrics_val_best.json", "metrics_val_last.json",
              "best.resolutions", "last.resolutions", "best.ckpt", "last.ckpt",
              "config.json"):
        if not os.path.exists(os.path.join(ck, f)):
            fail(f"train CLI wrote no {f}")
    rows = [ln.split(",") for ln in open(os.path.join(ck, "loss.log"))
            if ln[:1].isdigit()]
    if [r[0] for r in rows] != ["1", "2", "3"] or not all(
            np.isfinite(float(v)) for r in rows for v in r[1:]):
        fail(f"loss.log rows are not epochs 1-3 with finite losses: {rows}")
    with open(os.path.join(ck, "metrics_val_best.json")) as f:
        best = json.load(f)["loss"]
    ev = os.path.join(work, "train_eval")
    os.makedirs(ev)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(ck, f), ev)
    got = evaluate_cli.run(["--synthetic", "2000", "--ckpts", ev,
                            "--batch_size", str(TRAIN_B)])["loss"]
    rel = abs(got - best) / abs(best)
    say("train_reeval", metrics_val_best=best, evaluate_cli=got, rel_err=rel,
        loss_log=[",".join(r).strip() for r in rows])
    if not rel <= REEVAL_RTOL:
        fail(f"evaluate CLI gives {got} on the train CLI's best.ckpt, not "
             f"within {REEVAL_RTOL} of its metrics_val_best.json {best}")
    return fwd, bwd


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    if not os.path.isdir(os.path.join(HERE, "deepmetv2_tpu_torch")):
        fail("deepmetv2_tpu_torch/ is not next to chip_smoke.py: run it from "
             "the root of a checkout")
    sys.path.insert(0, HERE)
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False   # the reference is f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    from deepmetv2_tpu_torch.ops.cuda import build
    t = time.perf_counter()
    reports = build.build()
    sec = time.perf_counter() - t
    regs = {k: [ln.split(":", 1)[1].strip() for ln in v.splitlines()
                if "registers" in ln] for k, v in reports.items()}
    say("build", kernels=list(build.KERNELS), seconds=sec, ptxas=regs)

    # 3-4. kernels against their plain versions
    cases, edge_args, fwd = kernel_phase(device)
    bwd = kernel_bwd_phase(device, cases, edge_args)

    # 5. main path: evaluate
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import predict as predict_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (window_max,
                                                              window_max_bwd)
    from deepmetv2_tpu_torch.utils import artifacts

    work = os.path.join(HERE, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    ck = os.path.join(work, "ckpts")
    os.makedirs(ck)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(HERE, "ckpts_syn", f), ck)
    window_max.launches = window_max_bwd.launches = 0
    t = time.perf_counter()
    metrics = evaluate_cli.run(["--synthetic", "2000", "--ckpts", ck,
                                "--restore_file", "best"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = window_max.launches
    loss = metrics["loss"]
    say("evaluate", loss=loss, golden=GOLDEN_LOSS,
        rel_err=abs(loss - GOLDEN_LOSS) / GOLDEN_LOSS,
        launches=eval_launches, bwd_launches=window_max_bwd.launches,
        seconds=eval_s)
    if not abs(loss - GOLDEN_LOSS) <= LOSS_RTOL * GOLDEN_LOSS:
        fail(f"validation loss {loss} is not within {LOSS_RTOL} of "
             f"{GOLDEN_LOSS}")
    if eval_launches != 2 * 10 or window_max_bwd.launches != 0:
        fail(f"evaluate launched window_max {eval_launches} times, not 20, "
             f"and its backward {window_max_bwd.launches} times, not 0")
    res = artifacts.load(os.path.join(ck, "best.resolutions"))
    if "MET" not in res:
        fail("best.resolutions holds no MET entry")

    # 6. main path: predict
    out = os.path.join(work, "pred.npz")
    window_max.launches = 0
    t = time.perf_counter()
    predict_cli.main(["--synthetic", "2000", "--ckpts", ck, "--out", out])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t
    pred_launches = window_max.launches
    import numpy as np
    z = np.load(out)
    w, nv = z["weights"], z["n_valid"]
    real = np.arange(w.shape[1])[None, :] < nv[:, None]
    say("predict", events=int(len(z["met"])), launches=pred_launches,
        seconds=pred_s, met_mean=float(np.mean(z["met"])))
    if len(z["met"]) != 2000 or not np.array_equal(z["event_index"],
                                                   np.arange(2000)):
        fail("predict did not return 2000 events in input order")
    if not np.all(np.isfinite(z["met"])):
        fail("predict returned non-finite MET")
    if not (np.all((w[real] >= 0) & (w[real] <= 1)) and np.all(w[~real] == 0)):
        fail("predict weights outside [0, 1] or nonzero at padding")
    if pred_launches != 2 * 50:
        fail(f"predict launched window_max {pred_launches} times, not 100")

    # 7. resume from the JAX checkpoint, held to the JAX losses
    train_resume_phase(device)

    # 8. main path: the train CLI
    train_fwd, train_bwd = train_phase(work)

    # 9. where one evaluation step's and one train step's time goes
    profile_phase(device, ck)

    print(json.dumps({"kernels": [dict({
        "name": "window_max_fwd", "route": "cuda",
        "source": "deepmetv2_tpu_torch/csrc/window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:82",
        "launches": eval_launches + pred_launches + train_fwd,
        "library_ms": None}, **fwd), dict({
        "name": "window_max_bwd", "route": "cuda",
        "source": "deepmetv2_tpu_torch/csrc/window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:143",
        "launches": train_bwd, "library_ms": None}, **bwd)]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
