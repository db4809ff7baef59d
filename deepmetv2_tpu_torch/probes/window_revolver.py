"""Probe: the window max forward with its window chunks double-buffered
(``window_max_pipelined``) against the forward the main path runs
(``window_max``), the port of the JAX package's
``scripts/window_revolver_probe.py``.

    python -m deepmetv2_tpu_torch.probes.window_revolver

At the probe's two shapes, (B, N, H) = (8, 2048, 32) and (8, 512, 32), it
makes eta-sorted synthetic inputs (events of N−256 to N−1 candidates, the
halo their eta order needs, c = x·W_diff of seeded normal x and W),
asserts that both kernels and the plain version agree bit for bit
(padded rows −inf), and prints one JSON line per shape with both kernels'
times (CUDA events) and the speedup, then the card's name and power
limit.  It needs a CUDA GPU.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
from deepmetv2_tpu_torch.data.sorting import required_halo, sort_by_eta
from deepmetv2_tpu_torch.ops.cuda.edgeconv_window import (
    window_max, window_max_pipelined)
from deepmetv2_tpu_torch.ops.window import (padded_pos, padded_rows,
                                            window_max_torch)
from deepmetv2_tpu_torch.probes import common

SHAPES = ((8, 2048, 32), (8, 512, 32))
R = 0.4


def probe_inputs(B: int, N: int, H: int, seed: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(c [B, N, H], pos [B, N, 2], halo)``: B synthetic events of N−256
    to N−1 candidates padded to N and sorted by eta, padded rows at
    ``PAD_POS``; the halo the order needs (rounded up to a multiple of 64,
    at least 64); ``c = x·W`` for seeded normal x (0 at padding) and W
    (scale 0.1)."""
    events = synthetic_events(B, seed=seed, n_min=max(2, N - 256),
                              n_max=N - 1)
    host = collate(events, pad_to=N)
    halo = max(64, -(-required_halo(host, R) // 64) * 64)
    batch, _ = sort_by_eta(to_device(host, device))
    phi = torch.atan2(batch.x_cont[..., 1], batch.x_cont[..., 0])
    etaphi = torch.stack([batch.x_cont[..., 3], phi], dim=-1)
    pos = padded_pos(etaphi, batch.mask)
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(B, N, H)).astype(np.float32),
                        device=device) * batch.mask[..., None]
    w = torch.as_tensor(rng.normal(size=(2 * H, H)).astype(np.float32) * 0.1,
                        device=device)
    return torch.matmul(x, w[H:]), pos, halo


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    # +0.0 turns -0.0 into +0.0, so only the sign of a zero is forgiven
    return torch.equal((a + 0.0).view(torch.int32), (b + 0.0).view(torch.int32))


def run(device, reps: int = 50) -> Dict[str, Dict]:
    """Per shape: both kernels' ms, the speedup, and the bitwise checks;
    raises if the pipelined kernel differs from either reference."""
    out = {}
    for B, N, H in SHAPES:
        c, pos, halo = probe_inputs(B, N, H, seed=N + H, device=device)
        r2 = R ** 2
        base = window_max(c, pos, r2, halo)
        pipe = window_max_pipelined(c, pos, r2, halo)
        plain = window_max_torch(c, pos, ~padded_rows(pos), r2, halo)
        torch.cuda.synchronize()
        if not (_same(pipe, base) and _same(pipe, plain)):
            raise AssertionError(f"window_max_pipelined differs at {B}x{N}x{H}")
        t_base = common.ms(lambda: window_max(c, pos, r2, halo), reps)
        t_pipe = common.ms(lambda: window_max_pipelined(c, pos, r2, halo),
                           reps)
        out[f"{B}x{N}x{H}"] = {"halo": halo, "base_ms": t_base,
                               "pipelined_ms": t_pipe,
                               "speedup": t_base / t_pipe,
                               "bitwise_equal": True}
    return out


def main() -> int:
    device = common.cuda_device("window_revolver")
    if device is None:
        return 1
    for shape, row in run(device).items():
        print(json.dumps(dict(shape=shape, **row)), flush=True)
    common.print_device()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
