"""Praat-style autocorrelation pitch (port of tpu_rvc/f0/pm.py:31-87;
Boersma 1993, reference rvc/f0/pm.py wraps parselmouth).

Per frame: subtract the mean, Hann window, normalised autocorrelation by
rFFT divided by the window's own autocorrelation, parabolic-interpolated
peaks in the [1/f0_max, 1/f0_min] lag range with Praat's octave cost, and
a voicing gate on peak strength, frame amplitude and range.  Unvoiced
frames are 0.
"""

from __future__ import annotations

import math

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.core.device import device_constant, resolve_device
from .base import F0Predictor, interpolate_f0


def _pm_f0(wav: torch.Tensor, sr: int, hop: int, win: int, f0_min: float,
           f0_max: float, voicing_threshold: float = 0.6) -> torch.Tensor:
    """wav: (..., T) -> f0 (..., n_frames) float32, frame i over
    [i*hop, i*hop+win); leading axes are independent signals."""
    dev = wav.device
    frames = wav.unfold(-1, win, hop)                        # (..., F, win)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    window = device_constant(
        ("pm_hann", win),
        lambda: (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / (win - 1))
                 ).astype(np.float32), dev)
    xw = frames * window
    nfft = int(2 ** math.ceil(math.log2(2 * win)))
    spec = torch.fft.rfft(xw, n=nfft, dim=-1)
    ac = torch.fft.irfft(spec * spec.conj(), n=nfft, dim=-1)[..., :win]
    r_x = ac / torch.clamp(ac[..., :1], min=1e-12)
    wspec = torch.fft.rfft(window, n=nfft)
    wac = torch.fft.irfft(wspec * wspec.conj(), n=nfft)[:win]
    r_w = wac / torch.clamp(wac[0], min=1e-12)
    r = r_x / torch.clamp(r_w, min=1e-3)

    lag_min = max(int(sr / f0_max), 2)
    lag_max = min(int(sr / f0_min), win - 2)
    lags = torch.arange(lag_min, lag_max + 1, device=dev)
    rl = r[..., lag_min:lag_max + 1]
    rm = r[..., lag_min - 1:lag_max]
    rp = r[..., lag_min + 1:lag_max + 2]
    is_peak = (rl >= rm) & (rl >= rp)
    # Praat octave cost: longer lags pay log2(lag * f0_min / sr) * 0.01
    lag_penalty = 0.01 * torch.log2(lags.to(torch.float32) * (f0_min / sr))
    strength = torch.where(is_peak, rl - lag_penalty,
                           torch.full_like(rl, -math.inf))
    best = torch.argmax(strength, dim=-1, keepdim=True)
    y0, y1, y2 = (rm.gather(-1, best)[..., 0], rl.gather(-1, best)[..., 0],
                  rp.gather(-1, best)[..., 0])
    denom = y0 - 2 * y1 + y2
    delta = torch.where(denom.abs() > 1e-9,
                        0.5 * (y0 - y2) / torch.where(denom == 0,
                                                      torch.ones_like(denom),
                                                      denom),
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    f0 = sr / (lag_min + best[..., 0] + delta)
    frame_amp = frames.abs().amax(dim=-1)
    global_amp = torch.clamp(wav.abs().amax(dim=-1, keepdim=True), min=1e-9)
    voiced = ((y1 > voicing_threshold) & (frame_amp > 0.03 * global_amp)
              & (f0 >= f0_min) & (f0 <= f0_max))
    return torch.where(voiced, f0, torch.zeros_like(f0)).to(torch.float32)


def pm_track(wav: torch.Tensor, p_len: int, sr: int, hop: int, f0_min: float,
             f0_max: float) -> torch.Tensor:
    """wav (T,) or (N, T) on any device -> raw pm f0 of exactly p_len
    frames a signal.  Praat window: 3 periods of f0_min, reflect-padded so
    that frame 0 is centred at t = 0; centre-padded or trimmed to p_len
    (base `_fit_length`)."""
    win = int(3 * sr / f0_min)
    win -= win % 2
    pad = win // 2
    wav_p = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (pad, pad),
                  mode="reflect").reshape(*wav.shape[:-1], -1)
    f0 = _pm_f0(wav_p, sr, hop, win, float(f0_min), float(f0_max))
    m = f0.shape[-1]
    if m >= p_len:
        return f0[..., :p_len]
    left = (p_len - m + 1) // 2
    return F.pad(f0, (left, p_len - m - left))


class PM(F0Predictor):
    """Autocorrelation ("parselmouth") estimator (reference
    rvc/f0/pm.py:9): the track on `device`, the gap interpolation in
    numpy."""

    def __init__(self, hop_length: int = 160, f0_min: float = 50.0,
                 f0_max: float = 1100.0, sampling_rate: int = 16000,
                 device=None):
        super().__init__(hop_length, f0_min, f0_max, sampling_rate)
        self.device = resolve_device(device)

    @torch.no_grad()
    def compute_f0(self, wav: np.ndarray, p_len: Optional[int] = None,
                   filter_radius=None) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if p_len is None:
            p_len = wav.shape[0] // self.hop_length
        f0 = pm_track(torch.from_numpy(wav).to(self.device), p_len,
                      self.sampling_rate, self.hop_length, self.f0_min,
                      self.f0_max)
        return interpolate_f0(f0.cpu().numpy())[0]
