#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (deepmetv2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing one line:
  1. device: the card, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel of the serving path from csrc/, in parallel;
  3. kernel: window_max against its plain PyTorch version, bitwise, on
     (a) the main-path shape, (b) clustered eta with value ties and pairs
     on the radius boundary, (c) padded nodes and empty events; with the
     kernel's time, the plain version's and the card's lower bound;
  4. evaluate: the port's evaluate CLI on 2000 synthetic events with the
     committed JAX weights (ckpts_syn/best.ckpt), held to the JAX package's
     validation loss, with the kernel's launches counted;
  5. predict: the port's predict CLI over the same 2000 events;
  6. profile: one evaluation step's device time by kernel (torch.profiler);
then a JSON line of every ported kernel and, last, the device JSON line.
Any failed check exits non-zero before the last line.  Writes only under
build/ in the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_LOSS = 1.0319761037826538   # JAX package, cli.evaluate --synthetic 2000
LOSS_RTOL = 1e-4
R = 0.4
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM, FP32 outside the tensor cores


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


def window_work(pos, mask, halo: int, r2: float):
    """(window pairs, adjacent pairs) with a real query row (``mask``): the
    predicates and the selections the data needs; padded rows' outputs are
    discarded by the caller."""
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


def kernel_phase(device):
    import numpy as np
    import torch
    from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
    from deepmetv2_tpu_torch.data.sorting import sort_by_eta
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
        PAD_POS, window_edgeconv_linear_cuda, window_max)
    from deepmetv2_tpu_torch.ops.window import (WindowGraph,
                                                window_edgeconv_linear,
                                                window_max_torch)

    rng = np.random.default_rng(0)
    r2 = R ** 2
    B, N, H, halo = 40, 2048, 32, 128

    def padded_pos(etaphi, mask):
        return torch.where(mask[..., None], etaphi,
                           torch.full_like(etaphi, PAD_POS))

    def check(name, c, pos, halo):
        ones = torch.ones(c.shape[:2], dtype=torch.bool, device=c.device)
        m = window_max(c, pos, r2, halo)
        t = window_max_torch(c, pos, ones, r2, halo)
        torch.cuda.synchronize()
        if not bitwise_equal(m, t):
            bad = int(((m + 0.0).view(torch.int32)
                       != (t + 0.0).view(torch.int32)).sum())
            fail(f"window_max case {name}: {bad} entries differ from the "
                 "plain version")
        fin = torch.isfinite(t)
        return float((m[fin] - t[fin]).abs().max()) if fin.any() else 0.0

    # (a) main-path shape: an eta-sorted synthetic batch
    batch = to_device(collate(synthetic_events(B, seed=7), pad_to=N), device)
    batch, _ = sort_by_eta(batch)
    phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
    etaphi = torch.stack([batch.x_cont[..., 3], phi], dim=-1)
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
    errs.append(check("c", c_a, padded_pos(etaphi, mask_c), halo))
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
    # the same batch with each padded row at its own far coordinate: padded
    # rows then have no neighbours, which isolates what they cost the kernel
    far = PAD_POS + 1000.0 * torch.arange(N, device=device, dtype=torch.float32)
    pos_iso = torch.where(batch.mask[..., None], etaphi,
                          far[None, :, None].expand(B, N, 2))
    isolated_ms = cuda_ms(lambda: window_max(c_a, pos_iso, r2, halo), 50)
    pairs, adj = window_work(pos_a, batch.mask, halo, r2)
    nbytes = 4 * (c_a.numel() + pos_a.numel() + c_a.numel())
    ops = 6 * pairs + H * adj     # predicate: 2 sub, 2 mul, add, compare
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    say("kernel", name="window_max_fwd", cases="a,b,c bitwise equal",
        shape=[B, N, H], halo=halo, real_rows=int(batch.mask.sum()),
        ms=ms, plain_ms=plain_ms, padded_rows_isolated_ms=isolated_ms,
        bytes=nbytes, window_pairs=pairs, adjacent_pairs=adj, fp32_ops=ops,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops)
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def profile_phase(device, ck: str) -> None:
    """Where one evaluation step's device time goes: the step on the first
    validation batch (40 events, N=2048) of the synthetic-2000 main path,
    timed with CUDA events and traced with torch.profiler."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile
    from deepmetv2_tpu_torch.cli.common import load_run_config
    from deepmetv2_tpu_torch.data import (fetch_dataloader, synthetic_events,
                                          to_device)
    from deepmetv2_tpu_torch.models.graph_met import GraphMET
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint
    from deepmetv2_tpu_torch.train.step import make_eval_step

    cfg = load_run_config(ck)
    cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
        cfg.graph, mode="window", window_halo=128))
    payload = load_checkpoint(os.path.join(ck, "best.ckpt"))
    model = GraphMET(cfg.model, device=device).params_from_jax(
        payload["params"], payload["bn_state"]).eval()
    loader = fetch_dataloader(events=synthetic_events(2000, seed=42),
                              batch_size=40)["test"]
    batch = to_device(next(iter(loader)), device)
    eval_step = make_eval_step(cfg)
    step_ms = cuda_ms(lambda: eval_step(model, batch), 20)
    reps = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eval_step(model, batch)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            kernels.append((us / reps / 1e3, e.count // reps, e.key[:48]))
    kernels.sort(reverse=True)
    device_ms = sum(k[0] for k in kernels)
    say("profile", batch=[batch.batch_size, batch.max_nodes], step_ms=step_ms,
        device_ms=device_ms, device_busy_share=device_ms / step_ms,
        kernels_per_step=sum(k[1] for k in kernels),
        top=[{"ms": k[0], "calls": k[1], "name": k[2]} for k in kernels[:6]])


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

    # 3. kernel against its plain version
    kern = kernel_phase(device)

    # 4. main path: evaluate
    from deepmetv2_tpu_torch.cli import evaluate as evaluate_cli
    from deepmetv2_tpu_torch.cli import predict as predict_cli
    from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import window_max
    from deepmetv2_tpu_torch.utils import artifacts

    work = os.path.join(HERE, "build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    ck = os.path.join(work, "ckpts")
    os.makedirs(ck)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(os.path.join(HERE, "ckpts_syn", f), ck)
    window_max.launches = 0
    t = time.perf_counter()
    metrics = evaluate_cli.run(["--synthetic", "2000", "--ckpts", ck,
                                "--restore_file", "best"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = window_max.launches
    loss = metrics["loss"]
    say("evaluate", loss=loss, golden=GOLDEN_LOSS,
        rel_err=abs(loss - GOLDEN_LOSS) / GOLDEN_LOSS,
        launches=eval_launches, seconds=eval_s)
    if not abs(loss - GOLDEN_LOSS) <= LOSS_RTOL * GOLDEN_LOSS:
        fail(f"validation loss {loss} is not within {LOSS_RTOL} of "
             f"{GOLDEN_LOSS}")
    if eval_launches != 2 * 10:
        fail(f"evaluate launched window_max {eval_launches} times, not 20")
    res = artifacts.load(os.path.join(ck, "best.resolutions"))
    if "MET" not in res:
        fail("best.resolutions holds no MET entry")

    # 5. main path: predict
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

    # 6. where one evaluation step's time goes
    profile_phase(device, ck)

    print(json.dumps({"kernels": [{
        "name": "window_max_fwd", "route": "cuda",
        "source": "deepmetv2_tpu_torch/csrc/window_max.cu",
        "replaces": "deepmetv2_tpu/ops/pallas/edgeconv_window.py:82",
        "launches": eval_launches + pred_launches,
        "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
        "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"], "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
