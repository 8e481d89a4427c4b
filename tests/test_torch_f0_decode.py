"""tpu_rvc_torch's f0 decode against tpu_rvc's on the CPU: RMVPE's local
average of cents on the device and on the host, the device and host f0
resize, and `f0/base.py`'s interpolation, post-processing and length
fitting.  (The RMVPE net and its paths are in tests/test_torch_rmvpe.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.f0 import device as jax_dev
from tpu_rvc.f0.rmvpe import to_local_average_cents as jax_cents_np

from tpu_rvc_torch.f0 import base as f0_base
from tpu_rvc_torch.f0 import device as port_dev
from tpu_rvc_torch.f0.rmvpe import to_local_average_cents


def test_to_local_average_cents_matches_jax():
    sal = np.random.default_rng(4).uniform(0, 1, (50, 360)).astype(np.float32)
    sal[5] *= 0.02                     # below the threshold
    sal[6, 0], sal[7, 359] = 2.0, 2.0  # peaks at both edges of the bins
    want = np.asarray(jax_dev.to_local_average_cents_jax(jnp.asarray(sal),
                                                         0.03))
    got = port_dev.to_local_average_cents(torch.from_numpy(sal), 0.03).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[5] == 0 and got[6] > 0
    np.testing.assert_allclose(to_local_average_cents(sal, 0.03),
                               jax_cents_np(sal, 0.03), rtol=1e-12)
    np.testing.assert_allclose(got, jax_cents_np(sal, 0.03), rtol=1e-5)


@pytest.mark.parametrize("n,target", [(40, 40), (40, 80), (40, 100),
                                      (57, 31), (31, 64), (10, 1)])
def test_resize_f0_matches_jax_and_numpy(n, target):
    """Voiced/unvoiced edges on the target grid (integer ratios) and off
    it; an unvoiced first and last frame."""
    rng = np.random.default_rng(n * 100 + target)
    f0 = rng.uniform(80, 400, n).astype(np.float32)
    f0[rng.uniform(size=n) < 0.3] = 0.0
    f0[n // 2: n // 2 + 3] = 0.0
    f0[0] = 0.0
    f0[-1] = 0.0 if target % 2 else f0[-1]
    want = np.asarray(jax_dev.resize_f0_jax(jnp.asarray(f0), target))
    got = port_dev.resize_f0(torch.from_numpy(f0), target).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (got == 0).sum() == (want == 0).sum()
    host = f0_base.resize_f0(f0, target)
    np.testing.assert_allclose(got, host, rtol=1e-4)
    from tpu_rvc.f0.base import resize_f0 as jax_host_resize
    np.testing.assert_array_equal(host, jax_host_resize(f0, target))


def test_f0_base_matches_jax():
    from tpu_rvc.f0 import base as jb
    f0 = np.array([0, 0, 100, 0, 0, 220, 230, 0, 0], np.float32)
    for a, b in zip(f0_base.interpolate_f0(f0), jb.interpolate_f0(f0)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(f0_base.interpolate_f0(f0 * 0)[0], f0 * 0)
    c, f = f0_base.post_process(f0, 3.0)
    cj, fj = jb.post_process(100, f0, 3.0, 0.0)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(f, fj)
    est = f0_base.F0Predictor()
    for m in (5, 9, 12):
        np.testing.assert_array_equal(
            est._fit_length(f0[:m] if m < 9 else np.pad(f0, (0, m - 9)), 9),
            jb.F0Predictor()._fit_length(
                f0[:m] if m < 9 else np.pad(f0, (0, m - 9)), 9))
