"""GraphMET's categorical embeddings as one op (ops/cuda/cat_embed.py) on
the CPU: its output and the tables' gradients equal the model's former
composition (pdg_remap, the clamps, three lookups, a cat) bit for bit, the
written-out backward sums what autograd sums, the wrapper refuses what the
kernels do not take, and the kernels' names stay out of the benchmark's
pattern for the port's kernels (which has no bound for them)."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepmetv2_tpu_torch.config import ModelConfig
from deepmetv2_tpu_torch.data.batching import EventBatch
from deepmetv2_tpu_torch.models.graph_met import GraphMET
from deepmetv2_tpu_torch.nn.core import embedding_apply
from deepmetv2_tpu_torch.ops.cat_embed import cat_embed_bwd_torch, pdg_remap
from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.cuda.cat_embed import (cat_embed,
                                                    cat_embed_bwd,
                                                    cat_embed_fwd)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "deepmetv2_tpu_torch" / "csrc" / "cat_embed.cu"
I32 = np.iinfo(np.int32)


def composition(x_cat, w_charge, w_pdg, w_pv, pdgs):
    """The model's embedding as it was written before the op."""
    emb_chrg = embedding_apply({"w": w_charge},
                               torch.clamp(x_cat[..., 1] + 1, 0, 2))
    emb_pv = embedding_apply({"w": w_pv}, torch.clamp(x_cat[..., 2], 0, 7))
    emb_pdg = embedding_apply({"w": w_pdg}, pdg_remap(x_cat[..., 0], pdgs))
    return torch.cat([emb_chrg, emb_pdg, emb_pv], dim=-1)


def codes(rng, shape, pdgs):
    """x_cat [*shape, 3] int32 with every case the index rule meets: known
    pdgIds of both signs, unknown and negative ones, charge and fromPV in
    and out of range, int32's extremes, and padded rows of zeros."""
    known = np.asarray(pdgs)
    pdg = np.where(rng.random(shape) < 0.7,
                   rng.choice(known, shape) * rng.choice([-1, 1], shape),
                   rng.integers(-400, 400, shape))
    charge = rng.integers(-4, 4, shape)
    pv = rng.integers(-3, 11, shape)
    x = np.stack([pdg, charge, pv], -1).astype(np.int32)
    flat = x.reshape(-1, 3)
    flat[:6] = [[I32.max, I32.max, I32.max], [I32.min, I32.min, I32.min],
                [-211, -1, 7], [0, 1, 8], [2212, -2, -1], [13, 0, 0]]
    x[..., -5:, :] = 0                                  # padded rows
    return torch.as_tensor(x)


def tables(rng, D, pdg_rows=7):
    return [torch.tensor(rng.normal(size=(rows, D)).astype(np.float32),
                         requires_grad=True) for rows in (3, pdg_rows, 8)]


CASES = {
    "default": ((1, 2, 11, 13, 22, 130, 211), 7, 8),
    "few_ids": ((211, 22, -13, 130), 7, 8),
    "eight_ids": ((1, 2, 11, 13, 22, 130, 211, 2212), 8, 4),
    "narrow": ((1, 2, 11, 13, 22, 130, 211), 7, 1),
    "widest": ((1, 2, 11, 13, 22, 130, 211), 7, 32),
}


@pytest.mark.parametrize("case", CASES)
def test_matches_the_composition_bitwise(case):
    pdgs, pdg_rows, D = CASES[case]
    rng = np.random.default_rng(7)
    x = codes(rng, (3, 64), pdgs)
    w = tables(rng, D, pdg_rows)
    w_ref = [t.detach().clone().requires_grad_(True) for t in w]
    out = cat_embed(x, *w, pdgs)
    ref = composition(x, *w_ref, pdgs)
    assert out.shape == (3, 64, 3 * D)
    assert torch.equal(out, ref)
    g = torch.as_tensor(rng.normal(size=tuple(ref.shape)).astype(np.float32))
    out.backward(g)
    ref.backward(g)
    for t, r in zip(w, w_ref):
        assert torch.equal(t.grad, r.grad)
    assert torch.equal(cat_embed_fwd(x, *w, pdgs), ref.detach())


@pytest.mark.parametrize("case", CASES)
def test_written_out_backward_sums_what_autograd_sums(case):
    """``cat_embed_bwd`` (its plain version here) against autograd of the
    composition: in float64 to 1e-12, in float32 to f32 rounding."""
    pdgs, pdg_rows, D = CASES[case]
    rng = np.random.default_rng(11)
    x = codes(rng, (4, 256), pdgs)
    w = [t.detach().double().requires_grad_(True)
         for t in tables(rng, D, pdg_rows)]
    g = torch.as_tensor(rng.normal(size=(4, 256, 3 * D)))
    composition(x, *w, pdgs).backward(g)
    for got, t in zip(cat_embed_bwd_torch(x, g, pdg_rows, pdgs), w):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=0,
                                   atol=1e-12)
    for got, t in zip(cat_embed_bwd(x, g.float(), pdg_rows, pdgs), w):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-4)


def test_model_routes_through_the_op(monkeypatch):
    """GraphMET's forward calls the op once, with x_cat made contiguous (a
    mesh may hand the model a strided slice), its three tables and
    ``cfg.pdgs``."""
    from deepmetv2_tpu_torch.models import graph_met

    seen = []

    def spy(*args):
        seen.append(args)
        return cat_embed(*args)

    monkeypatch.setattr(graph_met, "cat_embed", spy)
    monkeypatch.setattr(graph_met, "edgeconv",
                        lambda emb, *_: torch.zeros_like(emb))
    cfg = ModelConfig(pdgs=(211, 22, 13))
    model = GraphMET(cfg, torch.Generator().manual_seed(0))
    x = codes(np.random.default_rng(3), (2, 16), cfg.pdgs)
    batch = EventBatch(x_cont=torch.zeros(2, 8, 8), x_cat=x[:, ::2],
                       mask=torch.ones(2, 8, dtype=torch.bool), y=None,
                       num_valid=None)
    assert model(batch, None).shape == (2, 8)
    (xc, wc, wp, wv, pdgs), = seen
    assert xc.is_contiguous() and torch.equal(xc, x[:, ::2])
    assert (wc, wp, wv) == (model.embed_charge.w, model.embed_pdgid.w,
                            model.embed_pv.w)
    assert tuple(pdgs) == cfg.pdgs


def test_cpu_tensors_launch_nothing():
    before = build.launch_counts()
    rng = np.random.default_rng(0)
    pdgs = CASES["default"][0]
    x = codes(rng, (2, 32), pdgs)
    out = cat_embed(x, *tables(rng, 8), pdgs)
    out.sum().backward()
    cat_embed_bwd(x, torch.ones(2, 32, 24), 7, pdgs)
    assert build.launch_counts() == before
    assert {"cat_embed_fwd", "cat_embed_bwd"} <= set(before)
    assert "cat_embed" in build.KERNELS


@pytest.mark.parametrize("what", ["D0", "D33", "int64", "float_codes",
                                  "x_strided", "table_strided", "too_many_ids",
                                  "no_ids", "pdg_rows9", "charge_rows",
                                  "codes_width"])
def test_wrapper_raises_on_what_the_kernels_do_not_take(what):
    rng = np.random.default_rng(1)
    pdgs = CASES["default"][0]
    x = codes(rng, (2, 16), pdgs)
    w = [t.detach() for t in tables(rng, 8)]
    args = {
        "D0": (x, *[t[:, :0] for t in w], pdgs),
        "D33": (x, *[torch.zeros(t.shape[0], 33) for t in w], pdgs),
        "int64": (x.long(), *w, pdgs),
        "float_codes": (x.float(), *w, pdgs),
        "x_strided": (x[:, ::2], *w, pdgs),
        "table_strided": (x, w[0], torch.zeros(7, 16)[:, ::2], w[2], pdgs),
        "too_many_ids": (x, *w, pdgs + (2212,)),
        "no_ids": (x, *w, ()),
        "pdg_rows9": (x, w[0], torch.zeros(9, 8), w[2], pdgs),
        "charge_rows": (x, torch.zeros(4, 8), w[1], w[2], pdgs),
        "codes_width": (x[..., :2].contiguous(), *w, pdgs),
    }[what]
    err = TypeError if what in ("int64", "float_codes") else ValueError
    for fn in (cat_embed, cat_embed_fwd):
        with pytest.raises(err, match="cat_embed"):
            fn(*args)


def test_kernel_names_stay_out_of_the_port_pattern():
    """The benchmark's ``kernel_roofline`` sums the device time of kernels
    that match ``port`` against their counted bounds; it counts none for
    these, so a match would add time with no work against it."""
    pattern = json.loads((ROOT / "portbench" / "counts" / "kernels.json")
                         .read_text())["port"]
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                       r"(\w+)\s*\(", SOURCE.read_text())
    assert sorted(names) == ["cat_embed_bwd_kernel", "cat_embed_fwd_kernel",
                             "cat_embed_sum_kernel"]
    for name in names:
        assert not re.search(pattern, name), name
