"""Spectral-gate denoiser (port of tpu_rvc/audio/torchgate.py:37-124;
reference infer/modules/gui/torchgate.py:8 `TorchGate`).

Stationary mode: per-frequency threshold = mean + n_std * std of the noise
log-spectrogram.  Non-stationary mode: temperature sigmoid over the
(X - movmean(X)) / movmean(X) ratio.  The binary or soft mask is smoothed
with a separable triangular 2D filter and applied to the complex STFT.

numpy in, numpy out; the work runs on `device` ("cuda" unless told
otherwise).  StreamSession uses it for input and output noise reduction
(gui.py I/O_noise_reduce paths).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.core.device import device_constant, resolve_device
from tpu_rvc_torch.ops.stft import istft, stft


def _amp_to_db(x: torch.Tensor, eps: float = 2.220446049250313e-16,
               top_db: float = 40.0) -> torch.Tensor:
    """Reference gui/utils.py amp_to_db: 20*log10(|x| + eps), floored per
    frequency row at (row max over time) - top_db."""
    db = 20.0 * torch.log10(x.abs() + eps)
    return torch.maximum(db, db.amax(dim=-1, keepdim=True) - top_db)


def _triangle(n: int) -> np.ndarray:
    up = np.linspace(0, 1, n + 1, endpoint=False)
    down = np.linspace(1, 0, n + 2)
    return np.concatenate([up, down])[1:-1]


class TorchGate:
    def __init__(self, sr: int, nonstationary: bool = False,
                 n_std_thresh_stationary: float = 1.5,
                 n_thresh_nonstationary: float = 1.3,
                 temp_coeff_nonstationary: float = 0.1,
                 n_movemean_nonstationary: int = 20,
                 prop_decrease: float = 1.0, n_fft: int = 1024,
                 win_length: Optional[int] = None,
                 hop_length: Optional[int] = None,
                 freq_mask_smooth_hz: Optional[float] = 500.0,
                 time_mask_smooth_ms: Optional[float] = 50.0,
                 device=None):
        self.device = resolve_device(device)
        self.sr = sr
        self.nonstationary = nonstationary
        self.n_std = n_std_thresh_stationary
        self.n_thresh_ns = n_thresh_nonstationary
        self.temp_ns = temp_coeff_nonstationary
        self.n_mm = n_movemean_nonstationary
        self.prop_decrease = prop_decrease
        self.n_fft = n_fft
        self.win_length = n_fft if win_length is None else win_length
        self.hop_length = (self.win_length // 4 if hop_length is None
                           else hop_length)
        self.smoothing_filter = self._smoothing_filter(
            freq_mask_smooth_hz, time_mask_smooth_ms)

    def _smoothing_filter(self, f_hz, t_ms) -> Optional[np.ndarray]:
        n_f = 1 if f_hz is None else int(f_hz / (self.sr / (self.n_fft / 2)))
        n_t = 1 if t_ms is None else int(
            t_ms / ((self.hop_length / self.sr) * 1000))
        if n_f < 1 or n_t < 1 or (n_f == 1 and n_t == 1):
            return None
        filt = np.outer(_triangle(n_f), _triangle(n_t))
        return (filt / filt.sum()).astype(np.float32)

    def _spec(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.n_fft // 2
        return stft(F.pad(x, (pad, pad)), self.n_fft, self.hop_length,
                    self.win_length)

    def signal_mask(self, x: torch.Tensor,
                    xn: Optional[torch.Tensor]) -> torch.Tensor:
        """The mask before smoothing, (B, F, frames) in [1 - prop_decrease,
        1], and the spectrogram it gates."""
        X = self._spec(x)
        if self.nonstationary:
            X_abs = X.abs()
            pad_l = (self.n_mm - 1) // 2
            xs = F.pad(X_abs, (pad_l, self.n_mm - 1 - pad_l))
            X_smooth = F.avg_pool1d(xs, self.n_mm, stride=1)
            ratio = (X_abs - X_smooth) / (X_smooth + 1e-6)
            sig_mask = torch.sigmoid((ratio - self.n_thresh_ns)
                                     / self.temp_ns)
        else:
            X_db = _amp_to_db(X)
            XN_db = X_db if xn is None else _amp_to_db(self._spec(xn))
            noise_thresh = (XN_db.mean(dim=-1)
                            + XN_db.std(dim=-1, unbiased=True) * self.n_std)
            sig_mask = (X_db > noise_thresh[..., None]).to(torch.float32)
        return self.prop_decrease * (sig_mask - 1.0) + 1.0, X

    @torch.no_grad()
    def process(self, x: torch.Tensor,
                xn: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, T), xn (B', Tn) or None on one device -> (B, T)."""
        sig_mask, X = self.signal_mask(x, xn)
        if self.smoothing_filter is not None:
            filt = device_constant(
                ("torchgate_filter", self.smoothing_filter.shape,
                 self.smoothing_filter.tobytes()),
                lambda: self.smoothing_filter, x.device)
            kf, kt = filt.shape
            # same output size with the odd sample of an even filter on the
            # right, as the JAX conv pads it
            sm = F.pad(sig_mask[:, None], ((kt - 1) // 2, kt // 2,
                                           (kf - 1) // 2, kf // 2))
            sig_mask = F.conv2d(sm, filt[None, None])[:, 0]
        pad = self.n_fft // 2
        y = istft(X * sig_mask, self.n_fft, self.hop_length, self.win_length)
        return y[:, pad:pad + x.shape[-1]]

    def __call__(self, x: np.ndarray, xn: Optional[np.ndarray] = None
                 ) -> np.ndarray:
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(
                np.atleast_2d(np.asarray(a, np.float32)))).to(self.device)

        y = self.process(up(x), None if xn is None else up(xn)).cpu().numpy()
        return y[0] if np.ndim(x) == 1 else y
