"""tpu_rvc_torch's conversion front end against tpu_rvc's on the CPU, fp32:
a small HuBERT from one fairseq-layout state_dict, with and without a
padding mask; pm f0 on the device; the top-8 retrieval blend and the RMS
envelope mix; polyphase resampling and linear interpolation.  (The
synthesizer and its parts are in tests/test_torch_modules.py.)"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.f0.device import pm_f0_device as jax_pm_f0_device
from tpu_rvc.models.hubert import Hubert as JaxHubert
from tpu_rvc.ops.resample import linear_interp_1d as jax_interp
from tpu_rvc.ops.resample import resample_poly as jax_resample
from tpu_rvc.pipeline.vc import _device_change_rms as jax_change_rms
from tpu_rvc.retrieval.search import knn_blend as jax_knn

from tpu_rvc_torch.ckpt.convert import hubert_state_from_jax
from tpu_rvc_torch.f0.device import pm_f0_device
from tpu_rvc_torch.ops.resample import linear_interp_1d, resample_poly
from tpu_rvc_torch.pipeline.vc import _device_change_rms
from tpu_rvc_torch.retrieval.search import knn_blend

from _torch_parity import SMALL_HUBERT, hubert_pair
from test_torch_modules import japply, t


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# HuBERT, f0, retrieval, resampling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hubert():
    return hubert_pair(SMALL_HUBERT, 21)


@pytest.mark.parametrize("masked", [False, True])
def test_hubert_matches_jax(hubert, masked):
    """Small HuBERT (the base model's layout at narrow widths) loaded from
    one fairseq-layout state_dict into both packages, with and without a
    wave-level padding mask: atol 1e-4.  The tpu_rvc params also go back
    through hubert_state_from_jax to the port's own state_dict."""
    port, v = hubert
    rng = np.random.default_rng(16)
    wav = rng.standard_normal((2, 8000)).astype(np.float32) * 0.1
    pad = np.zeros((2, 8000), bool)
    pad[1, 5000:] = True
    want = japply(JaxHubert(**SMALL_HUBERT), v, jnp.asarray(wav),
                  jnp.asarray(pad) if masked else None)
    got = port(t(wav), t(pad) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    back = hubert_state_from_jax(v)
    for k, w in port.state_dict().items():
        np.testing.assert_allclose(back[k].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_pm_f0_device_matches_jax():
    """pm pitch on a voiced sweep with noise and a silent gap: coarse bins
    equal on >= 99% of frames, f0 within 1e-3 relative on voiced frames
    (the two FFT libraries round differently)."""
    sr = 16000
    rng = np.random.default_rng(17)
    tt = np.arange(2 * sr) / sr
    f = 150 + 50 * np.sin(2 * np.pi * 0.7 * tt)
    ph = 2 * np.pi * np.cumsum(f) / sr
    wav = (0.4 * np.sin(ph) + 0.2 * np.sin(2 * ph)
           + 0.01 * rng.standard_normal(tt.shape)).astype(np.float32)
    wav[12000:16000] = 0.0
    c_want, f_want = jax_pm_f0_device(jnp.asarray(wav), 200, jnp.asarray(2.0))
    c_got, f_got = pm_f0_device(t(wav), 200, 2.0)
    c_want, f_want = np.asarray(c_want), np.asarray(f_want)
    assert np.mean(c_got.numpy() == c_want) >= 0.99
    voiced = f_want > 0
    np.testing.assert_allclose(f_got.numpy()[voiced], f_want[voiced],
                               rtol=1e-3)


def test_knn_blend_and_change_rms_match_jax():
    """Top-8 blend (atol 1e-5) and the device RMS envelope mix (rtol 1e-5)."""
    rng = np.random.default_rng(18)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    sq = (vecs * vecs).sum(1)
    want = jax_knn(jnp.asarray(q), jnp.asarray(vecs), jnp.asarray(sq),
                   jnp.asarray(0.75))
    got = knn_blend(t(q), t(vecs), t(sq), 0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

    src = rng.standard_normal(32000).astype(np.float32) * 0.3
    tgt = rng.standard_normal(96000).astype(np.float32) * 0.1
    want = jax_change_rms(jnp.asarray(src), 16000, jnp.asarray(tgt), 48000,
                          jnp.asarray(0.25))
    got = _device_change_rms(t(src), 16000, t(tgt), 48000, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_resample_and_interp_match_jax():
    rng = np.random.default_rng(19)
    x = rng.standard_normal((2, 4000)).astype(np.float32)
    np.testing.assert_allclose(
        resample_poly(t(x), 40000, 48000).numpy(),
        np.asarray(jax_resample(jnp.asarray(x), 40000, 48000)), atol=1e-5)
    np.testing.assert_allclose(
        linear_interp_1d(t(x), 5123).numpy(),
        np.asarray(jax_interp(jnp.asarray(x), 5123)), atol=1e-6)
