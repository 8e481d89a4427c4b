"""Mel filterbank (port of tpu_rvc/ops/mel.py:26-82), numpy, cached per
arguments.  The RMVPE frontend uses the HTK scale (`htk=True`, reference
rvc/f0/mel.py:23); the Slaney scale is the default, and the Slaney area
normalisation applies to both, as in librosa.  The training frontend
(`:85-110`, reference mel_processing.py): `spectrogram`, `spec_to_mel`,
`mel_spectrogram`, `dynamic_range_compression`, differentiable."""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from tpu_rvc_torch.core.device import device_constant
from .stft import stft_magnitude


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3  # Slaney: linear below 1 kHz, log above
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_branch = min_log_mel + np.log(
        np.maximum(f, 1e-10) / min_log_hz) / logstep
    return np.where(f >= min_log_hz, log_branch, f / f_sp)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


@lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = "slaney") -> np.ndarray:
    """librosa.filters.mel-equivalent triangular filterbank, (n_mels, F)."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk),
                          n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        weights = weights * (2.0 / (hz_pts[2: n_mels + 2]
                                    - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def dynamic_range_compression(x: torch.Tensor,
                              clip_val: float = 1e-5) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=clip_val))


def spectrogram(y: torch.Tensor, n_fft: int, hop: int,
                win: int) -> torch.Tensor:
    """(B, T) -> (B, F, frames), reference `spectrogram_torch`."""
    return stft_magnitude(y, n_fft, hop, win)


def spec_to_mel(spec: torch.Tensor, n_fft: int, n_mels: int, sr: int,
                fmin: float = 0.0, fmax: Optional[float] = None
                ) -> torch.Tensor:
    """(B, F, frames) -> (B, n_mels, frames), log-compressed (reference
    `spec_to_mel_torch`)."""
    basis = device_constant(("mel", sr, n_fft, n_mels, fmin, fmax),
                            lambda: mel_filterbank(sr, n_fft, n_mels, fmin,
                                                   fmax), spec.device)
    return dynamic_range_compression(torch.einsum("mf,bft->bmt", basis,
                                                  spec.float()))


def mel_spectrogram(y: torch.Tensor, n_fft: int, n_mels: int, sr: int,
                    hop: int, win: int, fmin: float = 0.0,
                    fmax: Optional[float] = None) -> torch.Tensor:
    """(B, T) -> (B, n_mels, frames) (reference `mel_spectrogram_torch`)."""
    return spec_to_mel(spectrogram(y, n_fft, hop, win), n_fft, n_mels, sr,
                       fmin, fmax)
