"""The port's reference-checkpoint importer (compat/torch_import.py) and
``--from_torch`` against the JAX package's, on the CPU.

The reference ``.pth.tar`` is written here with ``torch.save`` from the
committed ``ckpts_syn/best.ckpt`` weights (``chip_smoke.
write_reference_checkpoint``: ``graphnet.*`` keys, ``epoch``,
``optim_dict``, ``sched_dict``).  Tolerances: the importer is bit for bit
the JAX importer's; ``evaluate --from_torch`` is bitwise the port's
native-checkpoint evaluate (the same weights, the same arithmetic) and
within rtol 1e-5 of the JAX package's (window mode on 40 events; the
tolerance of tests/test_torch_serve.py: the packages' CPU runs sum in
other orders, and here they differ by 3e-6); the numpy oracle of
tests/torch_oracle.py reads the file itself and agrees on one event within
atol 1e-5.
"""

import contextlib
import io
import os
import os.path as osp
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from deepmetv2_tpu.compat import import_torch_checkpoint as j_import
from deepmetv2_tpu.utils import artifacts as j_artifacts
from deepmetv2_tpu_torch.compat import import_torch_checkpoint
from deepmetv2_tpu_torch.config import Config, GraphConfig
from deepmetv2_tpu_torch.data import collate, synthetic_events, to_device
from deepmetv2_tpu_torch.models.graph_met import GraphMET, net_apply
from deepmetv2_tpu_torch.nn.core import BatchNormState
from deepmetv2_tpu_torch.train.step import build_graph
from tests import torch_oracle
from tests.torch_threads import few_torch_threads  # noqa: F401

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CKPT = osp.join(REPO, "ckpts_syn", "best.ckpt")


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    p = j_artifacts.load(CKPT)
    path = str(tmp_path_factory.mktemp("ref") / "best.pth.tar")
    chip_smoke.write_reference_checkpoint(p["params"], p["bn_state"], path,
                                          epoch=7)
    return path


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_importer_matches_jax_bitwise(pth):
    tp, tst, tmeta = import_torch_checkpoint(pth)
    jp, jst, jmeta = j_import(pth)
    assert tmeta == jmeta and tmeta["epoch"] == 7
    for t_tree, j_tree in ((tp, jp), (tst, jst)):
        got, want = list(_leaves(t_tree)), list(_leaves(j_tree))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, a), (_, b) in zip(got, want):
            assert isinstance(a, torch.Tensor), path
            b = np.asarray(b)
            assert a.numpy().dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a.numpy(), b, err_msg=str(path))
    assert isinstance(tst["bn_all"], BatchNormState)
    # the layout round-trips: the imported weights are the checkpoint's
    want = j_artifacts.load(CKPT)
    model = GraphMET().params_from_jax(tp, tst)
    for path, t in model.jax_layout():
        ref = want[path[0]]
        for k in path[1:]:
            ref = ref[k]
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(ref))


def _ckpt_copy(d):
    os.makedirs(d)
    for f in ("config.json", "best.ckpt"):
        shutil.copy(osp.join(REPO, "ckpts_syn", f), d)
    return d


def test_evaluate_from_torch(pth, tmp_path):
    """``--from_torch`` into a fresh --ckpts directory: bitwise the native
    checkpoint's loss, within 1e-5 of the JAX CLI's."""
    from deepmetv2_tpu.cli import evaluate as j_eval
    from deepmetv2_tpu_torch.cli import evaluate as t_eval

    ev = ["--synthetic", "40", "--batch_size", "8"]
    fresh = str(tmp_path / "fresh")
    got = t_eval.run(ev + ["--from_torch", pth, "--ckpts", fresh,
                           "--device", "cpu"])["loss"]
    assert osp.exists(osp.join(fresh, "best.resolutions"))
    native = t_eval.run(ev + ["--ckpts", _ckpt_copy(str(tmp_path / "n")),
                              "--device", "cpu"])["loss"]
    assert got == native
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_eval.main(ev + ["--from_torch", pth, "--ckpts",
                                 str(tmp_path / "j")]) == 0
    want = float(out.getvalue().split("validation loss:")[1].split()[0])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_from_torch_refuses_the_drn(pth, tmp_path):
    from deepmetv2_tpu_torch.cli import evaluate as t_eval
    from deepmetv2_tpu_torch.cli import train as t_train

    for run in (t_eval.run, t_train.main):
        with pytest.raises(SystemExit, match="use --model graphmet"):
            run(["--model", "drn", "--from_torch", pth, "--synthetic", "4",
                 "--ckpts", str(tmp_path / "x"), "--device", "cpu"])


def test_train_warm_starts_from_torch(pth, tmp_path):
    """``cli.train --from_torch`` starts from the reference weights: at lr
    0 (AdamW's decay is lr-scaled) one epoch leaves every parameter as the
    file holds it."""
    from deepmetv2_tpu_torch.cli import train as t_train
    from deepmetv2_tpu_torch.train.checkpoint import load_checkpoint

    ck = str(tmp_path / "ck")
    with contextlib.redirect_stdout(io.StringIO()):
        assert t_train.main(["--synthetic", "20", "--batch_size", "4",
                             "--epochs", "1", "--lr", "0", "--from_torch",
                             pth, "--ckpts", ck, "--device", "cpu"]) == 0
    params, bn_state, _ = import_torch_checkpoint(pth)
    last = load_checkpoint(osp.join(ck, "last.ckpt"))
    got = GraphMET().params_from_jax(last["params"], last["bn_state"])
    want = GraphMET().params_from_jax(params, bn_state)
    for (path, a), (_, b) in zip(got.jax_layout(), want.jax_layout()):
        if path[0] == "params":
            assert torch.equal(a, b), path


def test_numpy_oracle_reads_the_file(pth):
    """The independent numpy forward on the file's state_dict, over the
    radius graph's lists, against the port's neighbor_list forward on the
    imported weights: one event."""
    sd = {k: v.numpy() for k, v in torch.load(pth)["state_dict"].items()}
    params, bn_state, _ = import_torch_checkpoint(pth)
    model = GraphMET().params_from_jax(params, bn_state).eval()
    batch = to_device(collate(synthetic_events(1, seed=4, n_min=80,
                                               n_max=120), buckets=(128,)),
                      "cpu")
    cfg = Config(graph=GraphConfig(mode="neighbor_list"))
    batch, nbr = build_graph(batch, cfg)
    with torch.no_grad():
        w = net_apply(model, batch, nbr)[0]
    n = int(batch.num_valid[0])
    lists = [nbr.idx[0, i][nbr.mask[0, i]].tolist() for i in range(n)]
    want = torch_oracle.graph_met_forward(
        sd, batch.x_cont[0, :n].numpy().astype(np.float64),
        batch.x_cat[0, :n].numpy().astype(np.int64), lists)
    np.testing.assert_allclose(w[:n].numpy(), want, rtol=0, atol=1e-5)
