"""STFT and inverse STFT (port of tpu_rvc/ops/stft.py: `hann_window` :25,
`frame_signal` :32, `stft` :45, `stft_magnitude` :66, `istft` :89).

center=False framing of a signal the caller has already padded:
n_frames = 1 + (T - n_fft) // hop, periodic Hann window (centred in the
frame when win_length < n_fft), one rFFT per frame.  `torch.stft` computes
exactly that.  `istft` is the overlap-add of the windowed inverse frames
divided by the overlap-added squared window; the caller trims.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.core.device import device_constant


def hann_window(win_length: int, device="cpu") -> torch.Tensor:
    """torch.hann_window(periodic=True), float32, cached per device."""
    def make():
        n = np.arange(win_length)
        return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(
            np.float32)

    return device_constant(("hann", win_length), make, device)


def frame_window(n_fft: int, win_length: Optional[int],
                 device) -> torch.Tensor:
    """The Hann window of `win_length` (default n_fft) zero-padded to
    n_fft, centred in the frame as `torch.stft` has it."""
    if win_length is None:
        win_length = n_fft
    window = hann_window(win_length, device)
    if win_length < n_fft:
        pad = (n_fft - win_length) // 2
        window = F.pad(window, (pad, n_fft - win_length - pad))
    return window


def stft(y: torch.Tensor, n_fft: int, hop: int,
         win_length: Optional[int] = None) -> torch.Tensor:
    """Complex STFT, center=False.  y: (B, T) -> (B, n_fft//2+1, n_frames)."""
    if win_length is None:
        win_length = n_fft
    return torch.stft(y.float(), n_fft, hop_length=hop, win_length=win_length,
                      window=hann_window(win_length, y.device), center=False,
                      return_complex=True)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop: int,
                   win_length: Optional[int] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """The training spectrogram (reference `spectrogram_torch`): reflect-pad
    (n_fft - hop) // 2 a side, center=False, sqrt(|X|^2 + eps).  y: (B, T)
    -> (B, n_fft//2+1, frames), T // hop frames for T a multiple of hop.
    Differentiable; eps inside the root keeps the gradient finite at zero
    magnitude.  The frames are `unfold`'s, not `torch.stft`'s: the same
    values, but a backward that sums each sample's frames in a fixed
    order, where `torch.stft`'s overlapping strided view adds them up
    with atomics on a card (the training step's mel loss runs through it,
    so its gradient would differ from run to run)."""
    p = (n_fft - hop) // 2
    y = F.pad(y.float()[:, None], (p, p), mode="reflect")[:, 0]
    frames = y.unfold(-1, n_fft, hop) * frame_window(n_fft, win_length,
                                                     y.device)
    spec = torch.view_as_real(torch.fft.rfft(frames, dim=-1)).transpose(1, 2)
    return torch.sqrt(spec.pow(2).sum(-1) + eps)


def istft(spec: torch.Tensor, n_fft: int, hop: int,
          win_length: Optional[int] = None,
          length: Optional[int] = None) -> torch.Tensor:
    """Inverse STFT: spec (B, F, n_frames) complex -> (B, T) with
    T = n_fft + hop * (n_frames - 1), or the `length` samples around its
    centre.  Overlap-add with window-square normalisation (floor 1e-11)."""
    window = frame_window(n_fft, win_length, spec.device)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1) * window
    n_frames = frames.shape[1]
    T = n_fft + hop * (n_frames - 1)

    # overlap-add as a col2im (`F.fold`): no atomics, so the sums come in
    # the same order in every run
    def ola(cols):  # (B', n_fft, n_frames) -> (B', T)
        return F.fold(cols, (1, T), (1, n_fft), stride=(1, hop))[:, 0, 0]

    y = ola(frames.transpose(1, 2))
    wsq = ola((window * window)[None, :, None].expand(1, n_fft, n_frames))
    y = y / torch.clamp(wsq, min=1e-11)
    if length is not None:
        start = (T - length) // 2 if length < T else 0
        y = y[:, start:start + length]
    return y
