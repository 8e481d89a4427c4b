"""STFT as the RMVPE mel frontend needs it (port of tpu_rvc/ops/stft.py:
`hann_window` :25, `frame_signal` :32, `stft` :45).

center=False framing of a signal the caller has already padded:
n_frames = 1 + (T - n_fft) // hop, periodic Hann window, one rFFT per
frame.  `torch.stft` computes exactly that.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_rvc_torch.core.device import device_constant


def hann_window(win_length: int, device="cpu") -> torch.Tensor:
    """torch.hann_window(periodic=True), float32, cached per device."""
    def make():
        n = np.arange(win_length)
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
            np.float32)

    return device_constant(("hann", win_length), make, device)


def stft(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex STFT, center=False.  y: (B, T) -> (B, n_fft//2+1, n_frames)."""
    return torch.stft(y.float(), n_fft, hop_length=hop, win_length=n_fft,
                      window=hann_window(n_fft, y.device), center=False,
                      return_complex=True)
