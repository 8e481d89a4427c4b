"""DIO estimator (port of tpu_rvc/f0/dio.py; reference rvc/f0/dio.py:9
wraps pyworld's C++ DIO + StoneMask).  Served by the port's numpy copy of
the WORLD-style implementation (`world.py`), on the host."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .base import F0Predictor, interpolate_f0, resize_f0
from .world import dio as world_dio, stonemask


class Dio(F0Predictor):
    def compute_f0(self, wav: np.ndarray, p_len: Optional[int] = None,
                   filter_radius=None) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if p_len is None:
            p_len = wav.shape[0] // self.hop_length
        frame_ms = self.hop_length / self.sampling_rate * 1000.0
        f0, times = world_dio(wav, self.sampling_rate,
                              f0_floor=self.f0_min, f0_ceil=self.f0_max,
                              frame_period_ms=frame_ms)
        f0 = stonemask(wav, self.sampling_rate, f0, times)
        return interpolate_f0(resize_f0(f0, p_len))[0]
