"""The numbers `correct` compares between what the program delivered and
what the reference computes for the same inputs."""

from __future__ import annotations

import numpy as np


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    """||got - want|| / ||want|| over the samples."""
    g, w = got.astype(np.float64), want.astype(np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-12))


def _magnitudes(x: np.ndarray, n_fft: int = 2048, hop: int = 512):
    x = x.astype(np.float64)
    if x.shape[0] < n_fft:
        x = np.pad(x, (0, n_fft - x.shape[0]))
    n = 1 + (x.shape[0] - n_fft) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.abs(np.fft.rfft(x[idx] * np.hanning(n_fft), axis=1))


def frame_errors(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Each STFT frame's relative gap of magnitudes, over the larger of
    that frame's norm in the reference and the median frame's, so that
    near-silent frames do not divide by nought."""
    g, w = _magnitudes(got), _magnitudes(want)
    norm = np.linalg.norm(w, axis=1)
    return np.linalg.norm(g - w, axis=1) / np.maximum(
        norm, max(float(np.median(norm)), 1e-12))


def worst_median(errors) -> float:
    """The largest, over the answers, of an answer's median frame gap."""
    return max((float(np.median(e)) for e in errors), default=0.0)
