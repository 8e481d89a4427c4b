"""tpu_rvc_torch's MCD against tpu_rvc's on the CPU: the mel cepstra and
the mean MCD of seeded speech-like waves at 16 and 48 kHz, ungated and
with an energy floor, on equal and unequal lengths, and the refusal of a
silent reference.  Both run their STFT in fp32 (the JAX one because x64
is off); the two MCDs agree to 1e-3 dB (measured: under 1e-5 dB)."""

import numpy as np
import pytest
import torch

from tpu_rvc.utils import mcd as jax_mcd
from tpu_rvc_torch.utils import mcd

MCD_DB = 1e-3     # |port - JAX| in dB


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread a worker: the suite runs in several processes, and
    torch's default pool in each of them oversubscribes the cores (this
    file's small operations ran 5-25x slower with it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def speech(seconds, sr, seed, f0=150.0):
    """Harmonics on a gliding pitch with a syllable envelope, breath noise
    and a stretch of digital silence."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    ph = 2 * np.pi * np.cumsum(f0 + 40 * np.sin(2 * np.pi * 0.4 * t)) / sr
    x = sum(0.3 / h * np.sin(h * ph) for h in range(1, 8))
    x = x * (0.55 + 0.45 * np.sin(2 * np.pi * 2.1 * t) ** 2)
    x = x + 0.01 * rng.standard_normal(t.shape)
    x[int(0.45 * len(x)):int(0.55 * len(x))] = 0.0
    return x


def converted(x, seed):
    """A second implementation's output: a slightly filtered, rescaled
    copy with a little noise, so the MCD is a few tenths of a dB."""
    rng = np.random.default_rng(seed)
    y = 0.97 * x + 0.05 * np.convolve(x, [0.5, 0.3, 0.2], mode="same")
    return y + 0.002 * rng.standard_normal(x.shape)


@pytest.mark.parametrize("sr", [16000, 48000])
def test_mel_cepstra_match_jax(sr):
    x = speech(1.0, sr, 1)
    got = mcd.mel_cepstra(x, sr, device="cpu")
    want = jax_mcd.mel_cepstra(x, sr)
    n_pad = len(x) + 2 * ((1024 - 256) // 2)
    assert got.shape == want.shape == (1 + (n_pad - 1024) // 256, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


@pytest.mark.parametrize("sr", [16000, 48000])
@pytest.mark.parametrize("energy_floor", [0.0, 0.02])
@pytest.mark.parametrize("lengths", ["equal", "unequal"])
def test_mcd_matches_jax(sr, energy_floor, lengths):
    x = speech(1.5, sr, 2)
    y = converted(x, 3)
    if lengths == "unequal":
        y = y[:len(y) - 1234]
    got = mcd.mcd(y, x, sr, energy_floor=energy_floor, device="cpu")
    want = jax_mcd.mcd(y, x, sr, energy_floor=energy_floor)
    print(f"sr {sr} floor {energy_floor} {lengths}: port {got:.6f} dB, "
          f"JAX {want:.6f} dB, |diff| {abs(got - want):.2e} dB")
    assert 0.05 < want < 5.0
    assert abs(got - want) <= MCD_DB


def test_energy_floor_leaves_out_silence():
    """The gate drops the reference's silent stretch: a copy that differs
    only by a faint hiss there reads less than half as far with it (the
    frames at the stretch's edges hold voice and hiss both)."""
    sr = 16000
    x = speech(1.5, sr, 4)
    q = x.copy()
    silent = x == 0.0
    q[silent] = 0.003 * np.random.default_rng(7).standard_normal(
        silent.sum())
    gated = mcd.mcd(q, x, sr, energy_floor=0.01, device="cpu")
    ungated = mcd.mcd(q, x, sr, device="cpu")
    assert gated == pytest.approx(jax_mcd.mcd(q, x, sr, energy_floor=0.01),
                                  abs=MCD_DB)
    assert 0.0 < gated < 0.5 * ungated


def test_silent_reference_raises_as_jax():
    sr = 16000
    x = speech(1.0, sr, 5)
    silent = np.zeros_like(x)
    with pytest.raises(ValueError) as got:
        mcd.mcd(x, silent, sr, energy_floor=0.01, device="cpu")
    with pytest.raises(ValueError) as want:
        jax_mcd.mcd(x, silent, sr, energy_floor=0.01)
    assert str(got.value) == str(want.value)


def test_identical_waves_give_zero():
    x = speech(0.5, 16000, 6)
    assert mcd.mcd(x, x, 16000, device="cpu") == 0.0
