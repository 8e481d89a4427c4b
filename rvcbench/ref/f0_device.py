"""On-device f0 post-processing and the RMVPE pitch track (frozen from
tpu_rvc_torch/f0/device.py).

Decode, resize, gap interpolation, transpose and coarse mel quantization
stay on the device between the estimator and the synthesizer, as in the
JAX package: nothing here waits for the device or reads a tensor's value
on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F0_MIN = 50.0
F0_MAX = 1100.0
from .f0_rmvpe import rmvpe_salience


def interpolate_f0(f0: torch.Tensor) -> torch.Tensor:
    """(..., T) with 0 = unvoiced -> linear interpolation between voiced
    neighbours along the last axis, edge-hold at both ends, all-zero
    passthrough."""
    n = f0.shape[-1]
    idx = torch.arange(n, device=f0.device)
    voiced = f0 > 0.0
    prev_idx = torch.cummax(torch.where(voiced, idx, -1), dim=-1).values
    next_idx = torch.flip(torch.cummin(torch.flip(
        torch.where(voiced, idx, n), [-1]), dim=-1).values, [-1])
    prev_val = f0.gather(-1, prev_idx.clamp(0, n - 1))
    next_val = f0.gather(-1, next_idx.clamp(0, n - 1))
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


def to_local_average_cents(salience: torch.Tensor,
                           threshold: float = 0.05) -> torch.Tensor:
    """Device-side RMVPE decode (f0/rmvpe.py `to_local_average_cents`):
    salience (..., T, 360) -> cents, 0 where the peak is not above the
    threshold.  Where a row's maximum is tied the CPU takes the first bin;
    the CUDA argmax does not promise which."""
    cents = 20.0 * torch.arange(360, device=salience.device,
                                dtype=torch.float32) + 1997.3794084376191
    cents_p = F.pad(cents, (4, 4))
    sal_p = F.pad(salience, (4, 4))
    center = torch.argmax(salience, dim=-1) + 4
    idx = center[..., None] + torch.arange(-4, 5, device=salience.device)
    todo_sal = sal_p.gather(-1, idx)
    divided = (todo_sal * cents_p[idx]).sum(-1) / todo_sal.sum(-1)
    maxx = salience.amax(dim=-1)
    return torch.where(maxx > threshold, divided, torch.zeros_like(divided))


def resize_f0(f0: torch.Tensor, target_len: int) -> torch.Tensor:
    """Device-side f0 resize (base.resize_f0) along the last axis:
    unvoiced frames become NaN, linear resample, NaN -> 0, so a
    voiced/unvoiced edge never interpolates through 0."""
    n = f0.shape[-1]
    f0 = f0.to(torch.float32)
    src = torch.where(f0 < 0.001, torch.full_like(f0, float("nan")), f0)
    pos = torch.arange(target_len, device=f0.device) * (n / target_len)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = pos - lo
    out = src[..., lo] * (1 - frac) + src[..., hi] * frac
    # a point on the grid must not pull NaN in from its other neighbour
    # (0 * NaN is NaN, and would zero a voiced frame) ...
    out = torch.where(frac == 0, src[..., lo], out)
    # ... and np.interp holds the last source point beyond it
    out = torch.where(pos >= n - 1, src[..., n - 1:], out)
    return torch.nan_to_num(out, nan=0.0)


def rmvpe_f0_device(wav: torch.Tensor, p_len: int, f0_up_key: float,
                    rmvpe_model, threshold: float = 0.03):
    """Device-side RMVPE pitch: mel -> E2E -> local-average decode ->
    resize -> interpolate -> transpose -> quantise.  wav: (T,) or (N, T)
    at 16 kHz -> (coarse, f0) of p_len frames a signal: the U-net and the
    GRU take the batch, the decode works row by row.  The quantisation
    range is the global F0_MIN/F0_MAX, not the estimator's 30-8000 Hz
    search range."""
    hidden = rmvpe_salience(rmvpe_model, wav.reshape(-1, wav.shape[-1]))
    hidden = hidden.reshape(*wav.shape[:-1], *hidden.shape[1:]).float()
    cents = to_local_average_cents(hidden, threshold)
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    f0 = torch.where(f0 == 10.0, torch.zeros_like(f0), f0)
    return post_process(interpolate_f0(resize_f0(f0, p_len)), f0_up_key)
