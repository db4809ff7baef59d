"""The port's serving CLIs (evaluate, predict) against the JAX package's on
the committed checkpoint, plus the entry-point and import contracts."""

import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest

from deepmetv2_tpu.utils import artifacts as j_artifacts
from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
N_EVENTS = "100"


def _ckpt_copy(d):
    os.makedirs(d)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(osp.join(REPO, "ckpts_syn", f), d)
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX and port evaluate + predict on the same synthetic events."""
    import contextlib
    import io

    from deepmetv2_tpu.cli import evaluate as j_eval
    from deepmetv2_tpu.cli import predict as j_pred
    from deepmetv2_tpu_torch.cli import evaluate as t_eval
    from deepmetv2_tpu_torch.cli import predict as t_pred

    base = tmp_path_factory.mktemp("serve")
    jck, tck = _ckpt_copy(str(base / "jax")), _ckpt_copy(str(base / "port"))
    ev = ["--synthetic", N_EVENTS, "--restore_file", "best",
          "--batch_size", "8"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_eval.main(ev + ["--ckpts", jck]) == 0
    j_loss = float(out.getvalue().split("validation loss:")[1].split()[0])
    t_loss = t_eval.run(ev + ["--ckpts", tck, "--device", "cpu"])["loss"]

    pr = ["--synthetic", "40", "--batch_size", "8"]
    assert j_pred.main(pr + ["--ckpts", jck,
                             "--out", str(base / "j.npz")]) == 0
    assert t_pred.main(pr + ["--ckpts", tck, "--device", "cpu",
                             "--out", str(base / "t.npz")]) == 0
    return dict(j_loss=j_loss, t_loss=t_loss,
                j_res=j_artifacts.load(osp.join(jck, "best.resolutions")),
                t_res=j_artifacts.load(osp.join(tck, "best.resolutions")),
                j_pred=dict(np.load(str(base / "j.npz"))),
                t_pred=dict(np.load(str(base / "t.npz"))))


def test_evaluate_loss_matches_jax(runs):
    np.testing.assert_allclose(runs["t_loss"], runs["j_loss"], rtol=1e-5)


def test_evaluate_resolutions_match_jax(runs):
    j, t = runs["j_res"], runs["t_res"]   # the port's file read by JAX
    assert set(j) == set(t) and "MET" in t
    for key in j:
        assert set(j[key]) == set(t[key])
        for name, (jw, jedges) in j[key].items():
            tw, tedges = t[key][name]
            np.testing.assert_array_equal(tedges, jedges)
            np.testing.assert_allclose(tw, jw, rtol=1e-4, equal_nan=True)


def _boundary_pairs(x):
    """Whether event ``x`` has a pair whose radius test is decided by the
    last ulp: one that changes with phi from torch.atan2 or jnp.arctan2
    (an ulp apart on some candidates), or with ``de*de + dp*dp`` rounded
    op by op (the port) or contracted into a fused multiply-add (XLA on the
    CPU inside the JAX eval step)."""
    import jax.numpy as jnp
    import torch

    px, py, eta = x[:, 0], x[:, 1], x[:, 3]
    phis = [np.asarray(jnp.arctan2(jnp.asarray(py), jnp.asarray(px))),
            torch.atan2(torch.as_tensor(py), torch.as_tensor(px)).numpy()]
    r2 = np.float32(0.4 ** 2)
    de = eta[:, None] - eta[None, :]
    adj = []
    for p in phis:
        dp = p[:, None] - p[None, :]
        adj.append(de * de + dp * dp < r2)
        for u, v in ((de, dp), (dp, de)):       # fma(u, u, v*v)
            fused = (u.astype(np.float64) ** 2 + (v * v).astype(np.float64))
            adj.append(fused.astype(np.float32) < r2)
    return any(np.any(a != adj[0]) for a in adj[1:])


def test_predict_matches_jax(runs):
    from deepmetv2_tpu_torch.data.synthetic import synthetic_events

    j, t = runs["j_pred"], runs["t_pred"]
    assert set(j) == set(t)
    np.testing.assert_array_equal(t["event_index"], j["event_index"])
    np.testing.assert_array_equal(t["n_valid"], j["n_valid"])
    for k in ("met_x", "met_y", "met"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-4)
    # weights agree to 1e-5 on every event; the only exception allowed is
    # an event with a pair on the radius boundary, which the two packages
    # may decide differently (ROADMAP C)
    events = synthetic_events(len(t["met"]), seed=42)
    off = [e for e in range(len(events))
           if np.abs(t["weights"][e] - j["weights"][e]).max() > 1e-5]
    assert len(off) <= len(events) // 10, off
    for e in off:
        assert _boundary_pairs(events[e][0]), e
    keep = np.setdiff1d(np.arange(len(events)), off)
    np.testing.assert_allclose(t["weights"][keep], j["weights"][keep],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("cli", ["evaluate", "predict"])
def test_cli_without_gpu_exits_nonzero(cli, tmp_path):
    import importlib

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device works")
    mod = importlib.import_module(f"deepmetv2_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit) as exc:
        mod.main(["--synthetic", "4", "--ckpts", str(tmp_path)])
    assert exc.value.code not in (0, None)
    assert "no CUDA GPU" in str(exc.value.code)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import deepmetv2_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'deepmetv2_tpu' or m.startswith('deepmetv2_tpu.')]\n"
        "assert len(names) > 20, names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    # chip_smoke.py imports inside its functions: check every import in it
    import ast

    tree = ast.parse(open(osp.join(REPO, "chip_smoke.py")).read())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names]
    mods += [n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module]
    assert "deepmetv2_tpu_torch.cli" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax",
                                                       "deepmetv2_tpu")]
