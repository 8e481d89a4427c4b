"""Resampling and interpolation (port of tpu_rvc/ops/resample.py:27-86).

`resample_poly` is the same windowed-sinc polyphase bank as the JAX
package, run as one strided `F.conv1d`; the two interpolations reproduce
torch `F.interpolate` (linear, align_corners=False; nearest) on the last
axis exactly as the JAX versions do.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .device import device_constant


@lru_cache(maxsize=32)
def _sinc_kernel(up: int, down: int, width: int = 64, rolloff: float = 0.945,
                 beta: float = 14.769656459379492) -> np.ndarray:
    """Kaiser-windowed sinc bank, one row per output phase: (up, K)."""
    cutoff = rolloff * min(1.0, up / down) / 2.0
    half = int(width * max(1.0, down / up))
    idx = np.arange(-half, half + 1, dtype=np.float64)
    t = (idx[None, :] - np.arange(up)[:, None] / up) * 2 * cutoff
    window = np.i0(beta * np.sqrt(np.clip(
        1 - (t / (2 * cutoff * half)) ** 2, 0, 1))) / np.i0(beta)
    safe_t = np.where(t == 0, 1.0, t)
    kern = np.where(t == 0, 1.0,
                    np.sin(np.pi * safe_t) / (np.pi * safe_t)) * window
    return (kern * (2 * cutoff)).astype(np.float32)


def resample_poly(x: torch.Tensor, orig_sr: int, new_sr: int) -> torch.Tensor:
    """Resample (..., T) from orig_sr to new_sr."""
    if orig_sr == new_sr:
        return x
    g = math.gcd(orig_sr, new_sr)
    up, down = new_sr // g, orig_sr // g
    kern = device_constant(("sinc", up, down),
                           lambda: _sinc_kernel(up, down), x.device)  # (up, K)
    half = (kern.shape[1] - 1) // 2
    shape = x.shape
    xb = F.pad(x.reshape(-1, 1, shape[-1]).float(), (half, half + down))
    y = F.conv1d(xb, kern[:, None, :])          # (B, up, T')
    y = y.transpose(1, 2).reshape(y.shape[0], -1)  # interleave phases
    t_out = int(math.ceil(shape[-1] * up / down))
    y = y[:, ::down][:, :t_out]
    return y.reshape(*shape[:-1], t_out)


def linear_interp_1d(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(..., T) -> (..., out_len), torch linear/align_corners=False."""
    T = x.shape[-1]
    if T == out_len:
        return x
    pos = ((torch.arange(out_len, dtype=torch.float32, device=x.device)
            + 0.5) * (T / out_len) - 0.5)
    lo = torch.clamp(torch.floor(pos).long(), 0, T - 1)
    hi = torch.clamp(lo + 1, 0, T - 1)
    frac = torch.clamp(pos - lo, 0.0, 1.0).to(x.dtype)
    return x[..., lo] * (1 - frac) + x[..., hi] * frac


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """torch F.interpolate(mode='nearest', scale_factor=factor), last axis."""
    return torch.repeat_interleave(x, factor, dim=-1)
