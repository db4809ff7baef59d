"""The list matching's wrapper (ops/cuda/cut_match.py) on the CPU: its
route there is the plain composition (normalized_cut_weights, then
handshake_matching) bit for bit at any shape, it raises on what the
kernels do not take (the shape rule binds off the CPU: meta tensors stand
in for the card's here), ``list_matching`` always goes through it, and the
DRN's list branch and node-sharded rounds go through that.  The last test guards
the hook the benchmark's recorder uses: the DRN forward looks
``cut_matching`` up in ``models.drn`` at call time.

The kernels themselves run only on a card: tests/test_torch_cut_match_card.py.
"""

import numpy as np
import pytest
import torch

from deepmetv2_tpu_torch.config import DRNConfig
from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.models import drn as tdrn
from deepmetv2_tpu_torch.ops import dyn_graph as tdg
from deepmetv2_tpu_torch.ops.coarsen import (handshake_matching,
                                             normalized_cut_weights)
from deepmetv2_tpu_torch.ops.cuda import build
from deepmetv2_tpu_torch.ops.cuda import cut_match as cm
from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph
from tests.torch_threads import few_torch_threads  # noqa: F401

# (B, N, H, k, features): prefix masks of 60-100 % of N, or a scattered mask
CASES = {
    "prefix": (3, 256, 16, 8, "normal"),
    "scattered": (2, 128, 13, 4, "scattered"),
    "lattice": (2, 128, 8, 8, "lattice"),     # many equal weights
    "one_event": (1, 384, 64, 16, "normal"),
}


def case(name: str, seed: int = 0):
    """``(hp [B, N, H] post-conv features, nbr, mask)``: the fused build's
    lists (cap 2k) of one set of features, and another set to match on."""
    B, N, H, k, kind = CASES[name]
    rng = np.random.default_rng(seed)
    if kind == "scattered":
        mask = rng.random((B, N)) < 0.7
        mask[0, :5] = False
    else:
        n = rng.integers(int(0.6 * N), N + 1, size=B)
        mask = np.arange(N)[None] < n[:, None]
    if kind == "lattice":
        h = rng.integers(-1, 2, size=(B, N, H)).astype(np.float32)
        hp = rng.integers(-1, 2, size=(B, N, H)).astype(np.float32)
    else:
        h = rng.normal(size=(B, N, H)).astype(np.float32)
        hp = rng.normal(size=(B, N, H)).astype(np.float32)
    mask_t = torch.as_tensor(mask)
    nbr, _, _ = knn_und_graph(torch.as_tensor(h), mask_t, k=k, cap=2 * k)
    return torch.as_tensor(hp), nbr, mask_t


def plain(hp, nbr, mask, rounds=4):
    return handshake_matching(normalized_cut_weights(hp, nbr), nbr, mask,
                              rounds=rounds)


@pytest.mark.parametrize("rounds", [4, 1])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_route_is_the_plain_composition(name, rounds):
    hp, nbr, mask = case(name)
    before = build.launch_counts()
    want = plain(hp, nbr, mask, rounds)
    for got in (cm.cut_match(hp, nbr, mask, rounds=rounds),
                tdg.list_matching(hp, nbr, mask, rounds=rounds)):
        assert all(a.dtype == torch.int64 for a in got)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert build.launch_counts() == before
    assert "cut_match" in before
    assert "cut_match" in build.KERNELS
    # the case matched something, and the padded rows are their own pair
    iota = torch.arange(mask.shape[1]).expand_as(mask)
    assert bool((want[1] != iota).any())
    assert torch.equal(want[1][~mask], iota[~mask])


def test_lattice_case_has_equal_weights():
    hp, nbr, _ = case("lattice")
    w = normalized_cut_weights(hp, nbr)
    fin = torch.isfinite(w)
    top = w.amax(dim=-1, keepdim=True)
    assert int(((w == top) & fin).sum(dim=-1).gt(1).sum()) > 0


def _meta(*args):
    """``args`` (tensors and lists) as meta tensors: a device other than
    the CPU, where the kernels' shape rule binds, with no card."""
    return tuple(Neighborhood(a.idx.to("meta"), a.mask.to("meta"))
                 if isinstance(a, Neighborhood) else a.to("meta")
                 for a in args)


def _bad(what: str):
    """``(args of cut_match, error, message)`` of one input the kernels do
    not take."""
    hp, nbr, mask = case("prefix")
    B, N, cap = nbr.idx.shape
    wide = Neighborhood(torch.zeros((B, N, 129), dtype=torch.int32),
                        torch.zeros((B, N, 129), dtype=torch.bool))
    long = (torch.zeros((1, cm.MAX_N + 1, 8)),
            Neighborhood(torch.zeros((1, cm.MAX_N + 1, 4), dtype=torch.int32),
                         torch.zeros((1, cm.MAX_N + 1, 4), dtype=torch.bool)),
            torch.zeros((1, cm.MAX_N + 1), dtype=torch.bool))
    return {
        "h_float64": ((hp.double(), nbr, mask), TypeError, "float64"),
        "idx_int64": ((hp, Neighborhood(nbr.idx.long(), nbr.mask), mask),
                      TypeError, "int64"),
        "slot_mask_uint8": ((hp, Neighborhood(nbr.idx,
                                              nbr.mask.to(torch.uint8)),
                             mask), TypeError, "uint8"),
        "node_mask_int": ((hp, nbr, mask.int()), TypeError, "int32"),
        "cap_129": (_meta(hp, wide, mask), ValueError, "cap=129"),
        "h_257": (_meta(torch.zeros((B, N, 257)), nbr, mask), ValueError,
                  "H=257"),
        "n_past_max": (_meta(*long), ValueError, f"N={cm.MAX_N + 1}"),
        "lists_2d": ((hp, Neighborhood(nbr.idx[0], nbr.mask[0]), mask),
                     ValueError, "want"),
        "slot_mask_shape": ((hp, Neighborhood(nbr.idx, nbr.mask[..., :-1]),
                             mask), ValueError, "lists' mask"),
        "node_mask_shape": ((hp, nbr, mask[:, :-1]), ValueError,
                            "node mask"),
        "h_rows": ((hp[:, :-1], nbr, mask), ValueError, "h "),
        "h_elsewhere": ((hp.to("meta"), nbr, mask), ValueError, "on meta"),
    }[what]


@pytest.mark.parametrize("what", [
    "h_float64", "idx_int64", "slot_mask_uint8", "node_mask_int", "cap_129",
    "h_257", "n_past_max", "lists_2d", "slot_mask_shape", "node_mask_shape",
    "h_rows", "h_elsewhere"])
def test_wrapper_raises_on_what_the_kernels_do_not_take(what):
    args, err, msg = _bad(what)
    with pytest.raises(err, match=f"cut_match: .*{msg}"):
        cm.cut_match(*args)


def test_shape_rule_covers_every_list_branch_shape():
    for n in range(128, 8192 + 1, 128):
        assert cm.supported(n, 32, 64) and cm.supported(n, 128, 256)
    for n, cap, h in ((8192, 1, 1), (6144, 32, 64), (cm.MAX_N, 128, 256),
                      (1003, 20, 13)):
        assert cm.supported(n, cap, h)
    for n, cap, h in ((0, 32, 64), (cm.MAX_N + 1, 32, 64), (8192, 0, 64),
                      (8192, 129, 64), (8192, 32, 0), (8192, 32, 257)):
        assert not cm.supported(n, cap, h)


def test_list_matching_routes_by_the_shape_rule(monkeypatch):
    """Every shape goes through the wrapper: on the CPU a cap of 129, past
    the kernels' range, gives the plain ops' result; off the CPU it
    raises (the card's own case: tests/test_torch_cut_match_card.py)."""
    calls = []
    real = cm.cut_match

    def recorded(*args, **kw):
        calls.append(args[1].idx.shape)
        return real(*args, **kw)

    monkeypatch.setattr(tdg.list_kernels, "cut_match", recorded)
    hp, nbr, mask = case("scattered")
    got = tdg.list_matching(hp, nbr, mask)
    assert len(calls) == 1
    B, N, cap = nbr.idx.shape
    pad = 129 - cap
    wide = Neighborhood(
        torch.cat([nbr.idx, torch.zeros((B, N, pad), dtype=torch.int32)], -1),
        torch.cat([nbr.mask, torch.zeros((B, N, pad), dtype=torch.bool)], -1))
    got_wide = tdg.list_matching(hp, wide, mask)
    assert len(calls) == 2
    for a, b in zip(got_wide, got):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="cap=129"):
        tdg.list_matching(*_meta(hp, wide, mask))
    assert len(calls) == 3


def test_cut_matching_list_branch_goes_through_the_wrapper(monkeypatch):
    calls = []
    real = cm.cut_match
    monkeypatch.setattr(tdg.list_kernels, "cut_match",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(tdg, "DENSE_MATCH_MAX_N", 0)
    monkeypatch.setattr(tdg, "DENSE_W_MAX_ELEMS", 0)
    hp, nbr, mask = case("prefix")
    g = tdg.build_dyn_graph(hp, mask, k=8)
    assert g.rel is None                  # the list branch's graph
    got = tdg.cut_matching(g, hp, mask)
    want = plain(hp, g.nbr, mask)
    assert calls == [1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _drn_case(seed: int = 5):
    """A small cartesian DRN (H 16, k 4, two rounds) and a batch of two
    events of 200 and 150 candidates at N=256 (x [2, 256, 11], mask)."""
    gen = torch.Generator().manual_seed(seed)
    model = tdrn.DRN(DRNConfig(hidden_dim=16, k=4, head="cartesian"),
                     generator=gen).eval()
    x = torch.randn((2, 256, 11), generator=gen)
    mask = torch.arange(256)[None] < torch.tensor([[200], [150]])
    return model, torch.where(mask[..., None], x, torch.zeros_like(x)), mask


def _unmatched(g, h, mask):
    """A matching that matches nothing."""
    iota = torch.arange(mask.shape[1]).expand_as(mask)
    return iota, iota


def test_patching_models_drn_cut_matching_changes_the_rounds(monkeypatch):
    """The recorder (portbench/record.py) and the benchmark's no-matching
    fault replace ``models.drn.cut_matching``: the forward must look the
    name up there, so a patched one decides every round."""
    model, x, mask = _drn_case()
    with torch.no_grad():
        diag = {}
        out = tdrn.drn_apply(model, x, mask, diag=diag)
        monkeypatch.setattr(tdrn, "cut_matching", _unmatched)
        diag_p = {}
        out_p = tdrn.drn_apply(model, x, mask, diag=diag_p)
    assert len(diag["rounds"]) == len(diag_p["rounds"]) == 2
    iota = torch.arange(mask.shape[1]).expand_as(mask)
    for (_, _, cl, pa), (_, _, cl_p, pa_p) in zip(diag["rounds"],
                                                  diag_p["rounds"]):
        assert torch.equal(cl_p, iota) and torch.equal(pa_p, iota)
    assert bool((diag["rounds"][0][3] != iota).any())
    assert not torch.equal(out, out_p)


def test_node_sharded_rounds_take_list_matching(monkeypatch):
    """The rounds on an injected graph build (``_listed_round``) match
    through ``list_matching`` too: one list matching in the port."""
    model, x, mask = _drn_case()
    calls = []
    real = tdrn.list_matching
    monkeypatch.setattr(tdrn, "list_matching",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))

    def knn_fn(h, m):
        return knn_und_graph(h.detach(), m, k=4, cap=4)[0]

    with torch.no_grad():
        tdrn.drn_apply(model, x, mask, knn_fn=knn_fn)
    assert calls == [1, 1]
