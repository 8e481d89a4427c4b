"""f0 estimator base utilities, numpy (port of tpu_rvc/f0/base.py;
reference rvc/f0/f0.py, rvc/f0/gen.py:11)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

F0_MIN = 50.0
F0_MAX = 1100.0


def interpolate_f0(f0: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fill unvoiced (<= 0) gaps by linear interpolation between voiced
    neighbours, holding the edges (reference _interpolate_f0, f0.py:31,
    vectorised).  Returns (interpolated f0, voiced mask)."""
    f0 = np.asarray(f0, dtype=np.float32).reshape(-1)
    uv = (f0 > 0.0).astype(np.float32)
    idx = np.flatnonzero(f0 > 0.0)
    if idx.size == 0:
        return np.zeros_like(f0), uv
    out = np.interp(np.arange(f0.size), idx, f0[idx]).astype(np.float32)
    return out, uv


def resize_f0(x: np.ndarray, target_len: int) -> np.ndarray:
    """Length-resize an f0 track with unvoiced frames as NaN, so that a
    voiced/unvoiced edge does not interpolate through 0 (reference
    f0.py:69)."""
    source = np.asarray(x, dtype=np.float64).copy()
    source[source < 0.001] = np.nan
    target = np.interp(
        np.arange(0, len(source) * target_len, len(source)) / target_len,
        np.arange(0, len(source)), source)
    return np.nan_to_num(target).astype(np.float32)


def coarse_f0(f0: np.ndarray, f0_min: float = F0_MIN,
              f0_max: float = F0_MAX) -> np.ndarray:
    """Mel-scale quantisation of f0 to bins 1..255 (reference gen.py:33-40)."""
    f0_mel_min = 1127.0 * np.log(1 + f0_min / 700.0)
    f0_mel_max = 1127.0 * np.log(1 + f0_max / 700.0)
    f0_mel = 1127.0 * np.log(1 + np.asarray(f0, np.float64) / 700.0)
    scaled = np.where(
        f0_mel > 0,
        (f0_mel - f0_mel_min) * 254.0 / (f0_mel_max - f0_mel_min) + 1.0,
        f0_mel)
    return np.rint(np.clip(scaled, 1.0, 255.0)).astype(np.int32)


def post_process(f0: np.ndarray, f0_up_key: float, f0_min: float = F0_MIN,
                 f0_max: float = F0_MAX, manual_f0: Optional[np.ndarray] = None,
                 x_pad: float = 0.0, tf0: int = 100
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Transpose by f0_up_key semitones, splice in a manual curve, and
    quantise (reference rvc/f0/gen.py:11-41) -> (coarse int32, f0 float32).

    manual_f0: (n, 2) rows of (seconds, Hz).  The curve is resampled to
    `delta_t` frames of 10 ms and written over the transposed track from
    frame int(x_pad * tf0), where the padded signal's own audio starts;
    frames past the track's end are dropped.  tf0 is frames a second."""
    f0 = np.asarray(f0, np.float64) * (2.0 ** (f0_up_key / 12.0))
    if manual_f0 is not None:
        manual_f0 = np.asarray(manual_f0, np.float64)
        delta_t = int(np.round(
            (manual_f0[:, 0].max() - manual_f0[:, 0].min()) * tf0 + 1))
        replace = np.interp(np.arange(delta_t), manual_f0[:, 0] * 100,
                            manual_f0[:, 1])
        start = int(x_pad * tf0)
        n = f0[start:start + len(replace)].shape[0]
        f0[start:start + n] = replace[:n]
    return coarse_f0(f0, f0_min, f0_max), f0.astype(np.float32)


class F0Predictor:
    """Base estimator (reference rvc/f0/f0.py:7)."""

    def __init__(self, hop_length: int = 160, f0_min: float = F0_MIN,
                 f0_max: float = F0_MAX, sampling_rate: int = 16000):
        self.hop_length = hop_length
        self.f0_min = f0_min
        self.f0_max = f0_max
        self.sampling_rate = sampling_rate

    def compute_f0(self, wav: np.ndarray, p_len: Optional[int] = None,
                   filter_radius: Optional[Union[int, float]] = None
                   ) -> np.ndarray:
        raise NotImplementedError

    def _fit_length(self, f0: np.ndarray, p_len: int) -> np.ndarray:
        """Centre-pad or trim to exactly p_len frames (reference
        pm.py:36-39)."""
        if len(f0) >= p_len:
            return f0[:p_len]
        pad = (p_len - len(f0) + 1) // 2
        return np.pad(f0, (pad, p_len - len(f0) - pad))
