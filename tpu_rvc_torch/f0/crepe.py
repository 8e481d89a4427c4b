"""CREPE estimator (port of tpu_rvc/f0/crepe.py; reference
rvc/f0/crepe.py:10).

The salience comes from the card (`models/crepe.py`); the decode runs on
the host, as in the JAX estimator: the weighted argmax over the 9 bins
around each frame's peak (torchcrepe's non-Viterbi decoder), a median
filter on periodicity and a mean filter on f0 (3 frames each), f0 zeroed
where periodicity < 0.1 (reference crepe.py:52-55), clipped to f0_max,
then resize and gap interpolation.  Weights are torchcrepe's "full"
checkpoint, `model_path`, or a Crepe given as `model`; without either the
estimator raises ValueError, as the JAX one does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_rvc_torch.core.device import fp32_math, resolve_device
from tpu_rvc_torch.models.crepe import CENTS_MAPPING, crepe_salience
from .base import F0Predictor, interpolate_f0, resize_f0
from .harvest import median_filter_1d


def _mean_filter_1d(x: np.ndarray, k: int = 3) -> np.ndarray:
    pad = k // 2
    xp = np.pad(x, (pad, pad), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(xp, k)
    return win.mean(axis=-1).astype(x.dtype)


class CRePE(F0Predictor):
    def __init__(self, hop_length: int = 160, f0_min: float = 50.0,
                 f0_max: float = 1100.0, sampling_rate: int = 16000,
                 model_path: Optional[str] = None, model=None, device=None):
        super().__init__(hop_length, f0_min, f0_max, sampling_rate)
        self.device = resolve_device(device)
        if model is None and model_path is not None:
            from tpu_rvc_torch.ckpt.crepe_loader import load_crepe
            model = load_crepe(model_path, self.device)
        if model is None:
            raise ValueError(
                "CREPE requires weights: pass model_path=<torchcrepe full "
                ".pth> or model=")
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    @fp32_math()
    def salience(self, wav: np.ndarray) -> np.ndarray:
        """(T,) -> (1 + T // hop, 360), computed on the device."""
        x = torch.from_numpy(np.asarray(wav, np.float32)).to(self.device)
        return crepe_salience(self.model, x, self.hop_length).cpu().numpy()

    def compute_f0(self, wav: np.ndarray, p_len: Optional[int] = None,
                   filter_radius=None) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if p_len is None:
            p_len = wav.shape[0] // self.hop_length
        sal = self.salience(wav)
        center = np.argmax(sal, axis=1)
        sal_p = np.pad(sal, ((0, 0), (4, 4)))
        cents_p = np.pad(CENTS_MAPPING, (4, 4))
        idx = (center + 4)[:, None] + np.arange(-4, 5)[None, :]
        rows = np.arange(sal.shape[0])[:, None]
        w = sal_p[rows, idx]
        cents = (w * cents_p[idx]).sum(1) / np.maximum(w.sum(1), 1e-9)
        f0 = 10.0 * 2.0 ** (cents / 1200.0)
        periodicity = median_filter_1d(sal.max(axis=1).astype(np.float32), 3)
        f0 = _mean_filter_1d(f0.astype(np.float32), 3)
        f0[periodicity < 0.1] = 0
        f0 = np.clip(f0, 0, self.f0_max)
        return interpolate_f0(resize_f0(f0, p_len))[0]
