"""Host DSP helpers (port of tpu_rvc/audio/dsp.py; reference
pipeline.py:23-45): the 48 Hz zero-phase Butterworth high-pass and the
half-second RMS envelope mix, in numpy/scipy."""

from __future__ import annotations

import numpy as np
from scipy import signal as sps

_BH, _AH = sps.butter(N=5, Wn=48, btype="high", fs=16000)


def highpass_filter(audio: np.ndarray, sr: int = 16000) -> np.ndarray:
    if sr == 16000:
        bh, ah = _BH, _AH
    else:
        bh, ah = sps.butter(N=5, Wn=48, btype="high", fs=sr)
    return sps.filtfilt(bh, ah, audio).astype(np.float32)


def rms_envelope(y: np.ndarray, frame_length: int,
                 hop_length: int) -> np.ndarray:
    """librosa.feature.rms equivalent (centred frames)."""
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad))
    n = 1 + (len(yp) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(yp[idx].astype(np.float64) ** 2, axis=1)).astype(
        np.float32)


def _interp_to(x: np.ndarray, out_len: int) -> np.ndarray:
    """torch F.interpolate(mode='linear', align_corners=False), 1-D."""
    T = len(x)
    if T == out_len:
        return x
    pos = (np.arange(out_len) + 0.5) * (T / out_len) - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, T - 1)
    hi = np.clip(lo + 1, 0, T - 1)
    frac = np.clip(pos - lo, 0.0, 1.0)
    return (x[lo] * (1 - frac) + x[hi] * frac).astype(np.float32)


def change_rms(source: np.ndarray, sr1: int, target: np.ndarray, sr2: int,
               rate: float) -> np.ndarray:
    """target *= rms(source)^(1-rate) * rms(target)^(rate-1)."""
    rms1 = _interp_to(rms_envelope(source, sr1 // 2 * 2, sr1 // 2),
                      len(target))
    rms2 = np.maximum(_interp_to(rms_envelope(target, sr2 // 2 * 2, sr2 // 2),
                                 len(target)), 1e-6)
    return (target * np.power(rms1, 1 - rate) *
            np.power(rms2, rate - 1)).astype(np.float32)
