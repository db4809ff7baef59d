"""The list matching's kernels (csrc/cut_match.cu) at the DRN cells'
shapes: B = 40 and 16 events of 500-5000 candidates padded to N = 8192 and
6144, their lists from knn_und_graph (k 16, cap 32) on the DRN's round-1
features, matched on another 64-wide set of features.  The weights
against a float64 evaluation of their formula (rtol 1e-6); the handshake
bit for bit against handshake_matching on the kernel's own weights, also
on planted equal, NaN and infinite weights and with nodes taken out of the
mask; padded rows their own cluster; the same bits over two calls and a
CUDA-graph replay.

These tests need a CUDA card and skip without one:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_cut_match_card.py

(``--noconftest``: the tests' conftest imports JAX, which the card's
machine does not have; this file imports neither JAX nor the JAX
package.)
"""

import pytest
import torch

from deepmetv2_tpu_torch.data.batching import Neighborhood
from deepmetv2_tpu_torch.ops.coarsen import handshake_matching
from deepmetv2_tpu_torch.ops.cuda import cut_match as cm
from deepmetv2_tpu_torch.ops.cuda.knn_und import knn_und_graph

K, CAP = 16, 32
SHAPES = [(8192, 40), (6144, 40), (8192, 16), (6144, 16)]
IDS = [f"N{n}-B{b}" for n, b in SHAPES]
_CELLS = {}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda:0")


def cell(device, N: int, B: int):
    """``(hp [B, N, 64], nbr, mask)`` of the first B of the 40 events of
    probes/knn_breakdown.py:cell_inputs at N: the lists of their round-1
    features, and features to match on (a fixed random map of those)."""
    if N not in _CELLS:
        from deepmetv2_tpu_torch.probes.knn_breakdown import cell_inputs

        h, mask = cell_inputs(device, N)
        nbr, _, _ = knn_und_graph(h, mask, k=K, cap=CAP)
        gen = torch.Generator(device=device).manual_seed(N)
        proj = torch.randn((64, 64), generator=gen, device=device) / 8.0
        hp = torch.where(mask[..., None], torch.tanh(h @ proj), 0.0)
        _CELLS[N] = (hp.contiguous(), nbr, mask)
    hp, nbr, mask = _CELLS[N]
    return (hp[:B].contiguous(),
            Neighborhood(nbr.idx[:B].contiguous(), nbr.mask[:B].contiguous()),
            mask[:B].contiguous())


def weights(hp, nbr, mask):
    """The weights' kernels (``cut_match``'s first half) on checked
    inputs."""
    cm._check(nbr, mask, hp)
    return cm._weights(hp, nbr)


def handshake(w, nbr, mask, rounds=4):
    """The handshake kernel (``cut_match``'s second half) on ``w``."""
    return cm._handshake(w, nbr, mask, rounds)


def f64_weights(hp, nbr, mask):
    """The weights' formula in float64, one event and 32 slots at a
    time."""
    out = torch.empty(nbr.idx.shape, dtype=torch.float64, device=hp.device)
    for b in range(hp.shape[0]):
        h = hp[b].double()
        ivd = 1.0 / nbr.mask[b].sum(dim=-1).double().clamp(min=1.0)
        for c in range(0, nbr.idx.shape[-1], 32):
            idx = nbr.idx[b, :, c:c + 32].long()
            d = (h[:, None, :] - h[idx]).pow(2).sum(dim=-1).sqrt()
            w = d * (ivd[:, None] + ivd[idx])
            out[b, :, c:c + 32] = torch.where(nbr.mask[b, :, c:c + 32], w,
                                              float("-inf"))
    return out


def check_matching(got, want, mask):
    iota = torch.arange(mask.shape[1], device=mask.device).expand_as(mask)
    cluster, partner = got
    assert cluster.dtype == partner.dtype == torch.int64
    assert torch.equal(cluster, want[0]) and torch.equal(partner, want[1])
    assert torch.equal(partner[~mask], iota[~mask])
    assert torch.equal(cluster[~mask], iota[~mask])
    assert torch.equal(torch.gather(partner, 1, partner), iota)
    assert not bool(mask.logical_not().gather(1, partner)[mask].any())
    return int((partner != iota).sum())


@pytest.mark.card
@pytest.mark.parametrize("N,B", SHAPES, ids=IDS)
def test_weights_within_1e6_of_float64(card, N, B):
    hp, nbr, mask = cell(card, N, B)
    w = weights(hp, nbr, mask)
    ref = f64_weights(hp, nbr, mask)
    assert torch.equal(torch.isneginf(w), ~nbr.mask)
    v = nbr.mask
    err = (w[v].double() - ref[v]).abs()
    assert bool((err <= 1e-6 * ref[v].abs()).all()), float(
        (err / ref[v].abs().clamp(min=1e-30)).max())
    assert int(v.sum()) > 10 * int(mask.sum())       # ~20+ slots a row


@pytest.mark.card
@pytest.mark.parametrize("N,B", SHAPES, ids=IDS)
def test_handshake_equals_the_plain_one_on_its_weights(card, N, B):
    hp, nbr, mask = cell(card, N, B)
    before = cm.cut_match.launches
    w = weights(hp, nbr, mask)
    want = handshake_matching(w, nbr, mask)
    paired = check_matching(handshake(w, nbr, mask), want, mask)
    check_matching(cm.cut_match(hp, nbr, mask), want, mask)
    assert cm.cut_match.launches == before + 1
    assert paired > int(mask.sum()) // 4
    for rounds in (1, 2, 0):
        check_matching(cm.cut_match(hp, nbr, mask, rounds=rounds),
                       handshake_matching(w, nbr, mask, rounds=rounds), mask)


@pytest.mark.card
@pytest.mark.parametrize("plant", ["equal", "levels", "nan", "inf"])
def test_planted_weights_follow_the_plain_tie_and_nan_rules(card, plant):
    hp, nbr, mask = cell(card, 8192, 40)
    w = weights(hp, nbr, mask)
    if plant == "equal":                  # every row takes its first slot
        w = torch.where(nbr.mask, 1.0, float("-inf"))
    elif plant == "levels":               # ties among a row's best slots
        w = torch.floor(w * 4.0) / 4.0
    elif plant == "nan":                  # such rows propose to no one
        w = w.clone()
        w[:, ::7, 3] = float("nan")
    else:                                 # +inf beats all, -inf never wins
        w = w.clone()
        w[:, ::5, 5] = float("inf")
        w[:, 1::5, 0] = float("-inf")
    want = handshake_matching(w, nbr, mask)
    check_matching(handshake(w, nbr, mask), want, mask)
    if plant == "equal":      # one round: i's first slot j pairs if j's is i
        first = torch.gather(nbr.idx.long(), 2,
                             nbr.mask.int().argmax(-1, keepdim=True))[..., 0]
        has = nbr.mask.any(-1) & mask
        iota = torch.arange(mask.shape[1], device=card).expand_as(mask)
        prop = torch.where(has, first, iota)
        mutual = (torch.gather(prop, 1, prop) == iota) & (prop != iota)
        got = handshake(w, nbr, mask, rounds=1)[1]
        assert torch.equal(got, torch.where(mutual, prop, iota))
        assert bool(mutual.any())


@pytest.mark.card
@pytest.mark.parametrize("cap,H", [(30, 13), (64, 128), (128, 256), (32, 1)])
def test_other_caps_and_widths(card, cap, H):
    """Caps that are no multiple of 4 (slot-by-slot loads), past 32 (more
    than one chunk of slots) and up to 128; widths up to 256."""
    hp, nbr, mask = cell(card, 6144, 16)
    if cap > CAP:
        h = hp[..., :16].contiguous()
        nbr, _, _ = knn_und_graph(h, mask, k=cap // 2, cap=cap)
    else:
        nbr = Neighborhood(nbr.idx[..., :cap].contiguous(),
                           nbr.mask[..., :cap].contiguous())
    gen = torch.Generator(device=card).manual_seed(cap + H)
    hp = torch.randn((16, 6144, H), generator=gen, device=card)
    w = weights(hp, nbr, mask)
    ref = f64_weights(hp, nbr, mask)
    v = nbr.mask
    assert torch.equal(torch.isneginf(w), ~v)
    assert bool(((w[v].double() - ref[v]).abs()
                 <= 1e-6 * ref[v].abs()).all())
    check_matching(cm.cut_match(hp, nbr, mask),
                   handshake_matching(w, nbr, mask), mask)


@pytest.mark.card
def test_nodes_out_of_the_mask_are_their_own_cluster(card):
    """Real nodes taken out of the mask keep their place in other rows'
    lists: nobody proposes to them, and they pair with no one."""
    hp, nbr, mask = cell(card, 6144, 40)
    gen = torch.Generator(device=card).manual_seed(7)
    mask = mask & (torch.rand(mask.shape, generator=gen, device=card) > 0.3)
    w = weights(hp, nbr, mask)
    paired = check_matching(cm.cut_match(hp, nbr, mask),
                            handshake_matching(w, nbr, mask), mask)
    assert paired > 0


@pytest.mark.card
def test_same_bits_over_two_calls_and_a_graph_replay(card):
    hp, nbr, mask = cell(card, 8192, 40)
    first = cm.cut_match(hp, nbr, mask)
    w1 = weights(hp, nbr, mask)
    again = cm.cut_match(hp, nbr, mask)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        cm.cut_match(hp, nbr, mask)
    torch.cuda.current_stream(card).wait_stream(side)
    before = cm.cut_match.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cg, pg = cm.cut_match(hp, nbr, mask)
        wg = weights(hp, nbr, mask)
    assert cm.cut_match.launches == before + 1
    graph.replay()
    torch.cuda.synchronize()
    for a, b in ((again[0], first[0]), (again[1], first[1]),
                 (cg, first[0]), (pg, first[1])):
        assert torch.equal(a, b)
    assert torch.equal(wg.view(torch.int32), w1.view(torch.int32))
    assert torch.equal(weights(hp, nbr, mask).view(torch.int32),
                       w1.view(torch.int32))


@pytest.mark.card
def test_card_tensors_outside_the_range_raise(card):
    hp, nbr, mask = cell(card, 6144, 16)
    wide = Neighborhood(torch.zeros((16, 6144, 129), dtype=torch.int32,
                                    device=card),
                        torch.zeros((16, 6144, 129), dtype=torch.bool,
                                    device=card))
    with pytest.raises(ValueError, match="cap=129"):
        cm.cut_match(hp, wide, mask)
    with pytest.raises(TypeError, match="cut_match"):
        cm.cut_match(hp.double(), nbr, mask)
