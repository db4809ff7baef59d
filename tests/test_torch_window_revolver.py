"""The port of the window-max revolver probe
(``deepmetv2_tpu_torch/probes/window_revolver.py`` and the pipelined
forward's wrapper, ``ops/cuda/edgeconv_window.py:window_max_pipelined``) on
the CPU: the probe's inputs, and the wrapper's plain path against the JAX
package's window-max kernel in interpret mode, which the probe's kernel
must equal bit for bit.  The kernel itself runs only on the card
(``chip_smoke.py``'s probe phase)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepmetv2_tpu.ops.pallas import edgeconv_window as jpal
from deepmetv2_tpu_torch.ops.cuda import edgeconv_window as tcu
from deepmetv2_tpu_torch.probes import window_revolver as wr
from tests.torch_threads import few_torch_threads  # noqa: F401


def test_probe_shapes_are_the_tpu_probes():
    # scripts/window_revolver_probe.py: the headline and the 512x32 shape
    assert wr.SHAPES == ((8, 2048, 32), (8, 512, 32))


@pytest.mark.parametrize("N", [256, 512])
def test_probe_inputs_and_plain_path_match_jax(N):
    c, pos, halo = wr.probe_inputs(2, N, 32, seed=N, device="cpu")
    assert c.shape == (2, N, 32) and pos.shape == (2, N, 2)
    assert halo % 64 == 0 and halo >= 64
    real = (pos[..., 0] < tcu.PAD_POS).numpy()
    n = real.sum(1)
    assert np.all((n >= max(2, N - 256)) & (n <= N - 1))
    eta = pos[..., 0].numpy()
    for b in range(2):           # eta-sorted, padding last
        assert real[b, :n[b]].all()
        assert np.all(np.diff(eta[b, :n[b]]) >= 0)
    r2 = wr.R ** 2
    got = tcu.window_max_pipelined(c, pos, r2, halo)
    assert torch.equal(got, tcu.window_max(c, pos, r2, halo))
    want = np.asarray(jpal.window_max(jnp.asarray(c.numpy()),
                                      jnp.asarray(pos.numpy()), r2, halo,
                                      128, True))
    np.testing.assert_array_equal(got.numpy()[real], want[real])


def test_probe_needs_a_gpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the probe runs")
    assert wr.main() == 1
    assert "no CUDA GPU" in capsys.readouterr().err
