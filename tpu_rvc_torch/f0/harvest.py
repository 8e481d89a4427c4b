"""Harvest estimator (port of tpu_rvc/f0/harvest.py; reference
rvc/f0/harvest.py:10 wraps pyworld Harvest + StoneMask + scipy medfilt).
The port's numpy copy of the WORLD-style implementation at a denser band
resolution (`world.py`), on the host, with the reference's median filter
applied when filter_radius > 2."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import F0Predictor, interpolate_f0, resize_f0
from .world import harvest as world_harvest


def median_filter_1d(x: np.ndarray, radius: int) -> np.ndarray:
    """Edge-padded running median over `radius` samples (raised to the
    next odd count); radius <= 1 returns x."""
    if radius <= 1:
        return x
    k = radius if radius % 2 == 1 else radius + 1
    pad = k // 2
    xp = np.pad(x, (pad, pad), mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, k)
    return np.median(windows, axis=-1).astype(x.dtype)


class Harvest(F0Predictor):
    def compute_f0(self, wav: np.ndarray, p_len: Optional[int] = None,
                   filter_radius: Optional[float] = None) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if p_len is None:
            p_len = wav.shape[0] // self.hop_length
        frame_ms = self.hop_length / self.sampling_rate * 1000.0
        f0, _ = world_harvest(wav, self.sampling_rate,
                              f0_floor=self.f0_min, f0_ceil=self.f0_max,
                              frame_period_ms=frame_ms)
        f0 = resize_f0(f0, p_len)
        if filter_radius is not None and filter_radius > 2:
            f0 = median_filter_1d(f0, int(filter_radius))
        return interpolate_f0(f0)[0]
