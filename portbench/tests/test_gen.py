import numpy as np

from portbench import spec
from portbench.gen import events as gen


def traffic(name="graphmet-infer-cms", **kw):
    t = spec.load_json(spec.HERE / "traffic" / f"{name}.json")
    t.update(kw)
    return t


def test_same_seed_same_events():
    t = traffic(events=80)
    a, b = gen.make_events(t, 2**31 + 5), gen.make_events(t, 2**31 + 5)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


def test_seeds_share_the_size_plan_batch_by_batch():
    t = traffic(events=120)
    a, b = gen.make_events(t, 1), gen.make_events(t, 2)
    B = t["batch"]
    for i in range(0, 120, B):
        sa = sorted(len(x) for x, _ in a[i:i + B])
        sb = sorted(len(x) for x, _ in b[i:i + B])
        assert sa == sb
    assert not np.array_equal(a[0][0][:50], b[0][0][:50])


def test_distribution_as_stated():
    t = traffic(events=400)
    c = t["candidates"]
    ev = gen.make_events(t, 11)
    n = np.array([len(x) for x, _ in ev])
    assert n.min() >= c["min"] and n.max() <= c["max"]
    x = np.concatenate([x for x, _ in ev])
    eta, pt = x[:, 3], x[:, 2]
    assert np.abs(eta).max() <= c["eta_max"]
    core = np.mean(np.abs(eta) < 1.6)
    # N(0, 1.6) puts 68 % inside +-1.6, the flat part 16 %
    want = c["core_share"] * 0.6827 + (1 - c["core_share"]) * 1.6 / 5
    assert abs(core - want) < 0.01
    assert pt.min() >= c["pt_min"]
    assert abs(np.median(pt) - c["pt_min"] * 2 ** (1 / c["pt_alpha"])) < 0.01
    assert np.allclose(np.hypot(x[:, 0], x[:, 1]), pt, rtol=1e-5)
    pdg = np.abs(x[:, 8])
    for k in c["pdg_classes"]:
        assert abs(np.mean(pdg == k["pdg"]) - k["share"]) < 0.005
    charged = {k["pdg"] for k in c["pdg_classes"] if k["charged"]}
    assert np.all((x[:, 9] != 0) == np.isin(pdg, list(charged)))
    assert set(np.unique(x[:, 10])) == {0.0, 1.0, 2.0, 3.0}
    y = np.stack([y for _, y in ev])
    assert np.hypot(y[:, 0], y[:, 1]).max() <= t["targets"]["met_pt_max"]


def test_train_plan_fills_both_buckets_with_whole_batches():
    t = traffic("graphmet-train-cms")
    sizes = gen.size_plan(t)
    B = t["batch"]
    assert len(sizes) == t["events"] and len(sizes) % B == 0
    widest = [sizes[i:i + B].max() for i in range(0, len(sizes), B)]
    assert {w <= 4096 for w in widest} == {True, False}
