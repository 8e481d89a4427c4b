"""On-device f0 post-processing and the pm pitch track (port of
tpu_rvc/f0/device.py:20-83).

Gap interpolation, transpose and coarse mel quantization stay on the
device between the estimator and the synthesizer, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .base import F0_MAX, F0_MIN
from .pm import _pm_f0


def interpolate_f0(f0: torch.Tensor) -> torch.Tensor:
    """(T,) with 0 = unvoiced -> linear interpolation between voiced
    neighbours, edge-hold at both ends, all-zero passthrough."""
    n = f0.shape[-1]
    idx = torch.arange(n, device=f0.device)
    voiced = f0 > 0.0
    prev_idx = torch.cummax(torch.where(voiced, idx, -1), dim=0).values
    next_idx = torch.flip(torch.cummin(torch.flip(
        torch.where(voiced, idx, n), [0]), dim=0).values, [0])
    prev_val = f0[prev_idx.clamp(0, n - 1)]
    next_val = f0[next_idx.clamp(0, n - 1)]
    has_prev, has_next = prev_idx >= 0, next_idx < n
    span = torch.clamp(next_idx - prev_idx, min=1)
    w = (idx - prev_idx).to(f0.dtype) / span.to(f0.dtype)
    interp = prev_val * (1 - w) + next_val * w
    zero = torch.zeros_like(f0)
    out = torch.where(has_prev & has_next, interp,
                      torch.where(has_prev, prev_val,
                                  torch.where(has_next, next_val, zero)))
    return torch.where(voiced, f0, out)


def post_process(f0: torch.Tensor, f0_up_key: float,
                 f0_min: float = F0_MIN, f0_max: float = F0_MAX):
    """Transpose by f0_up_key semitones and quantise to mel bins 1..255
    (round half to even, as `jnp.rint`)."""
    f0 = f0 * (2.0 ** (float(f0_up_key) / 12.0))
    mel_min = 1127.0 * torch.log(torch.tensor(1 + f0_min / 700.0))
    mel_max = 1127.0 * torch.log(torch.tensor(1 + f0_max / 700.0))
    mel = 1127.0 * torch.log(1 + f0 / 700.0)
    scaled = torch.where(mel > 0,
                         (mel - mel_min) * 254.0 / (mel_max - mel_min) + 1.0,
                         mel)
    coarse = torch.round(torch.clamp(scaled, 1.0, 255.0)).to(torch.int32)
    return coarse, f0.to(torch.float32)


def pm_f0_device(wav: torch.Tensor, p_len: int, f0_up_key: float,
                 sr: int = 16000, hop: int = 160, f0_min: float = F0_MIN,
                 f0_max: float = F0_MAX):
    """Device-side pm pitch: estimate -> fit length -> interpolate ->
    transpose -> quantise.  wav: (T,) at `sr` -> (coarse, f0) of p_len."""
    win = int(3 * sr / f0_min)
    win -= win % 2
    pad = win // 2
    wav_p = F.pad(wav[None, None], (pad, pad), mode="reflect")[0, 0]
    f0 = _pm_f0(wav_p, sr, hop, win, float(f0_min), float(f0_max))
    m = f0.shape[0]
    if m >= p_len:
        f0 = f0[:p_len]
    else:  # centre pad (base._fit_length)
        left = (p_len - m + 1) // 2
        f0 = F.pad(f0, (left, p_len - m - left))
    return post_process(interpolate_f0(f0), f0_up_key, f0_min, f0_max)
