"""The port's dense layers against the JAX package's ``nn/core.py`` on the
same numpy inputs (padded rows included), atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.nn import core as jc
from deepmetv2_tpu_torch.nn import core as tc

ATOL = 1e-6


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_elu():
    x = np.random.default_rng(0).normal(size=(4, 33)).astype(np.float32) * 3
    x[0, :3] = [0.0, -0.0, 80.0]
    np.testing.assert_allclose(tc.elu(_t(x)).numpy(),
                               np.asarray(jc.elu(jnp.asarray(x))),
                               rtol=0, atol=ATOL)


def test_linear_and_mlp():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 17, 8)).astype(np.float32)
    dims = (8, 16, 4)
    # torch-default scales (|w| ~ 1/sqrt(fan_in)), so outputs are O(1)
    ps = [{"w": (rng.normal(size=(dims[i], dims[i + 1]))
                 / np.sqrt(dims[i])).astype(np.float32),
           "b": rng.normal(size=(dims[i + 1],)).astype(np.float32)}
          for i in range(2)]
    np.testing.assert_allclose(
        tc.linear_apply({k: _t(v) for k, v in ps[0].items()}, _t(x)).numpy(),
        np.asarray(jc.linear_apply(ps[0], jnp.asarray(x))), rtol=0,
        atol=ATOL)
    jparams = {f"lin{i}": p for i, p in enumerate(ps)}
    want = np.asarray(jc.mlp_apply(jparams, jnp.asarray(x)))
    got = tc.mlp_apply([{k: _t(v) for k, v in p.items()} for p in ps],
                       _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    mod = tc.MLP(dims)
    with torch.no_grad():
        for lin, p in zip(mod.layers, ps):
            lin.w.copy_(_t(p["w"]))
            lin.b.copy_(_t(p["b"]))
        np.testing.assert_allclose(mod(_t(x)).numpy(), want, rtol=0,
                                   atol=ATOL)


def test_embedding():
    rng = np.random.default_rng(2)
    w = rng.normal(size=(7, 8)).astype(np.float32)
    idx = rng.integers(0, 7, size=(3, 20)).astype(np.int32)
    np.testing.assert_array_equal(
        tc.embedding_apply({"w": _t(w)}, _t(idx)).numpy(),
        np.asarray(jc.embedding_apply({"w": jnp.asarray(w)},
                                      jnp.asarray(idx))))


@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm(train):
    rng = np.random.default_rng(3)
    B, N, H = 3, 40, 16
    x = rng.normal(1.0, 2.0, size=(B, N, H)).astype(np.float32)
    mask = np.arange(N)[None, :] < np.array([[40], [13], [0]])
    x[~mask] = 123.0                      # garbage the stats must skip
    params = {"gamma": rng.normal(size=H).astype(np.float32),
              "beta": rng.normal(size=H).astype(np.float32)}
    mean = rng.normal(size=H).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=H).astype(np.float32)
    jstate = jc.BatchNormState(jnp.asarray(mean), jnp.asarray(var),
                               jnp.asarray(5, jnp.int32))
    jout, jnew = jc.batchnorm_apply(params, jstate, jnp.asarray(x),
                                    jnp.asarray(mask), train)
    tstate = tc.BatchNormState(_t(mean), _t(var), torch.tensor(5))
    tout, tnew = tc.batchnorm_apply({k: _t(v) for k, v in params.items()},
                                    tstate, _t(x), _t(mask), train)
    np.testing.assert_allclose(tout.numpy()[mask], np.asarray(jout)[mask],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tnew.mean.numpy(), np.asarray(jnew.mean),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(tnew.var.numpy(), np.asarray(jnew.var),
                               rtol=0, atol=ATOL)
    assert int(tnew.count) == int(jnew.count)

    # the module: same output, running buffers updated in training mode
    bn = tc.MaskedBatchNorm(H)
    with torch.no_grad():
        bn.gamma.copy_(_t(params["gamma"]))
        bn.beta.copy_(_t(params["beta"]))
        bn.running_mean.copy_(_t(mean))
        bn.running_var.copy_(_t(var))
        bn.num_batches_tracked.fill_(5)
    bn.train(train)
    out = bn(_t(x), _t(mask))
    np.testing.assert_allclose(out.detach().numpy()[mask],
                               np.asarray(jout)[mask], rtol=0, atol=ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(jnew.var),
                               rtol=0, atol=ATOL)
    assert int(bn.num_batches_tracked) == int(jnew.count)


def test_default_init_distributions():
    g = torch.Generator().manual_seed(0)
    lin = tc.Linear(64, 32, generator=g)
    bound = 1 / 8
    assert float(lin.w.detach().abs().max()) <= bound
    assert float(lin.b.detach().abs().max()) <= bound
    emb = tc.Embedding(1000, 16, generator=g)
    assert abs(float(emb.w.detach().std()) - 1.0) < 0.05
    again = tc.Linear(64, 32, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.w, lin.w)
