"""Mel-cepstral distortion (MCD), the fidelity acceptance metric (port of
tpu_rvc/utils/mcd.py; BASELINE.md: output MCD within 0.1 dB of the
PyTorch reference).

MCD_k = (10 / ln 10) * sqrt(2 * sum_{i=1..k} (c1_i - c2_i)^2), averaged
over aligned frames, with cepstra from the log-mel spectrogram by an
orthonormal DCT-II.

The magnitude STFT runs on `device` (the card by default) in fp32: the
JAX module hands its float64 input to `jnp.asarray`, which with x64 off
(the JAX default) makes it fp32 too.  The mel product, the log, the DCT
and the distance are numpy on the host, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rvc_torch.core.device import resolve_device
from tpu_rvc_torch.ops.mel import mel_filterbank
from tpu_rvc_torch.ops.stft import stft_magnitude

N_FFT = 1024
HOP = 256


def mel_cepstra(wav: np.ndarray, sr: int, n_mfcc: int = 13,
                n_fft: int = N_FFT, hop: int = HOP, n_mels: int = 80,
                device=None) -> np.ndarray:
    """(T,) wave -> (frames, n_mfcc) mel cepstra (c0 excluded downstream)."""
    y = torch.as_tensor(np.asarray(wav, np.float32)[None],
                        device=resolve_device(device))
    spec = stft_magnitude(y, n_fft, hop)[0].cpu().numpy()
    basis = mel_filterbank(sr, n_fft, n_mels)
    logmel = np.log(np.maximum(basis @ spec, 1e-8))  # (n_mels, frames)
    # DCT-II, orthonormal
    k = np.arange(n_mfcc)[:, None]
    m = np.arange(n_mels)[None, :]
    dct = np.cos(np.pi * k * (2 * m + 1) / (2 * n_mels)) * np.sqrt(
        2.0 / n_mels)
    dct[0] /= np.sqrt(2.0)
    return (dct @ logmel).T  # (frames, n_mfcc)


def mcd(wav1: np.ndarray, wav2: np.ndarray, sr: int, n_mfcc: int = 13,
        energy_floor: float = 0.0, device=None) -> float:
    """Mean MCD in dB over aligned frames (no DTW: the inputs are the
    time-aligned outputs of two implementations on identical inputs).

    energy_floor > 0 leaves out the frames whose reference (wav2) RMS is
    below it, the standard speech-frame gate: in digital silence the
    residual is quantisation noise, whose log-spectral distance is
    unbounded and says nothing about model parity."""
    n = min(len(wav1), len(wav2))
    c1 = mel_cepstra(np.asarray(wav1[:n], np.float64), sr, n_mfcc,
                     device=device)
    c2 = mel_cepstra(np.asarray(wav2[:n], np.float64), sr, n_mfcc,
                     device=device)
    if energy_floor > 0.0:
        # the RMS over the samples each cepstral frame saw: stft_magnitude
        # reflect-pads (n_fft - hop) // 2 a side, so frame i covers
        # ref[i * hop - pad : i * hop - pad + n_fft]; the same pad here
        # gates onset and offset frames against their own audio
        pad = (N_FFT - HOP) // 2
        ref = np.pad(np.asarray(wav2[:n], np.float64), pad, mode="reflect")
        f = min(len(c1), len(c2))
        rms = np.asarray([np.sqrt((ref[i * HOP:i * HOP + N_FFT] ** 2).mean())
                          for i in range(f)])
        keep = rms >= energy_floor
        if not keep.any():
            raise ValueError(
                f"no frames above energy_floor={energy_floor} — the "
                "reference signal is effectively silent; an ungated MCD "
                "over quantization noise would be meaningless")
        c1, c2 = c1[:f][keep], c2[:f][keep]
    f = min(len(c1), len(c2))
    diff = c1[:f, 1:] - c2[:f, 1:]  # c0 (energy) left out
    per_frame = np.sqrt(2.0 * np.sum(diff ** 2, axis=1))
    return float((10.0 / np.log(10.0)) * per_frame.mean())
