"""tpu_rvc_torch's complex STFT pair and spectral-gate denoiser against
tpu_rvc's on the CPU (the serving slice's host-side audio tools;
`StreamSession`'s noise reduction is held in tests/test_torch_serve.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_rvc.audio.torchgate import TorchGate as JaxTorchGate
from tpu_rvc.audio.torchgate import _amp_to_db as jax_amp_to_db
from tpu_rvc.ops import stft as jax_stft

from tpu_rvc_torch.audio.torchgate import TorchGate
from tpu_rvc_torch.ops.stft import istft, stft


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# stft / istft and TorchGate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,win", [(640, 160, 640), (512, 128, 400)])
def test_stft_istft_match_jax_and_round_trip(rng, n_fft, hop, win):
    """Complex STFT with win_length and its inverse against the JAX pair
    (atol 1e-5), and istft(stft(x)) == x.  The inverse is compared and
    inverted away from the first and last frame's edges, where the summed
    squared window is near zero and the division amplifies rounding."""
    x = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    got = stft(torch.from_numpy(x), n_fft, hop, win)
    want = jax_stft.stft(jnp.asarray(x), n_fft, hop, win)
    assert got.shape == want.shape == (2, n_fft // 2 + 1,
                                       1 + (4000 - n_fft) // hop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    T = n_fft + hop * (got.shape[-1] - 1)
    back = istft(got, n_fft, hop, win).numpy()
    jback = np.asarray(jax_stft.istft(want, n_fft, hop, win))
    assert back.shape == jback.shape == (2, T)
    mid = slice(n_fft, T - n_fft)
    np.testing.assert_allclose(back[:, mid], jback[:, mid], atol=1e-5)
    np.testing.assert_allclose(back[:, mid], x[:, :T][:, mid], atol=1e-5)
    cut = istft(got, n_fft, hop, win, length=3000).numpy()
    np.testing.assert_allclose(
        cut, np.asarray(jax_stft.istft(want, n_fft, hop, win, length=3000)),
        atol=1e-5)


def noisy_tone(rng, n=16000, batch=False):
    t = np.arange(n) / 16000
    x = 0.4 * np.sin(2 * np.pi * 220 * t) * (t > 0.3) \
        + 0.02 * rng.standard_normal(n)
    x = x.astype(np.float32)
    return np.stack([x, x[::-1].copy()]) if batch else x


@pytest.mark.parametrize("nonstationary", [False, True])
@pytest.mark.parametrize("batch,with_xn", [(False, False), (False, True),
                                           (True, False)])
def test_torchgate_matches_jax(rng, nonstationary, batch, with_xn):
    """1-D and 2-D input, with and without a noise clip, both modes: atol
    1e-4 of full scale.  The stationary mask is a hard threshold, and some
    of these 32,000 bins lie within 1e-4 dB of theirs, so the masks are
    compared too, by their disagreement rate: the port's against one made
    from the JAX package's own spectrogram and dB functions, at most one
    bin in 10,000."""
    kw = dict(nonstationary=nonstationary, n_fft=640, prop_decrease=0.9)
    x = noisy_tone(rng, batch=batch)
    xn = (0.02 * rng.standard_normal(32000)).astype(np.float32) \
        if with_xn else None
    port = TorchGate(16000, device="cpu", **kw)
    got = port(x, xn)
    jtg = JaxTorchGate(16000, **kw)
    want = jtg(x, xn)
    assert got.dtype == np.float32 and got.shape == x.shape == want.shape
    assert np.abs(got - want).max() < 1e-4
    if not nonstationary:
        mask, _ = port.signal_mask(
            torch.from_numpy(np.atleast_2d(x)),
            None if xn is None else torch.from_numpy(xn[None]))
        x_db = jax_amp_to_db(jtg._spec(jnp.asarray(np.atleast_2d(x))))
        n_db = x_db if xn is None else jax_amp_to_db(
            jtg._spec(jnp.asarray(xn[None])))
        thresh = jnp.mean(n_db, -1) + jnp.std(n_db, -1, ddof=1) * jtg.n_std
        jmask = np.where(np.asarray(x_db > thresh[..., None]), 1.0, 0.1)
        np.testing.assert_allclose(np.unique(mask.numpy()), [0.1, 1.0],
                                   atol=1e-6)
        assert np.mean(np.abs(mask.numpy() - jmask) > 0.5) <= 1e-4
    # it does gate: the noise-only head loses most of its energy
    head = np.atleast_2d(got)[0, 640:4000]
    assert np.sqrt(np.mean(head ** 2)) < 0.5 * 0.02


def test_torchgate_filter_and_device_rule():
    port = TorchGate(16000, n_fft=640, device="cpu")
    want = JaxTorchGate(16000, n_fft=640).smoothing_filter
    np.testing.assert_array_equal(port.smoothing_filter, want)
    assert TorchGate(16000, freq_mask_smooth_hz=None,
                     time_mask_smooth_ms=None,
                     device="cpu").smoothing_filter is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchGate(16000)
