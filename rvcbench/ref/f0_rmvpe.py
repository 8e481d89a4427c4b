"""RMVPE's front end and salience (frozen from tpu_rvc_torch/f0/rmvpe.py;
reference rvc/f0/rmvpe.py:40).

Mel frontend: 128 HTK mels over [30, 8000] Hz, n_fft 1024, hop 160,
reflect pad 512 (center=True framing), log-clamp 1e-5 (reference
rvc/f0/mel.py:10).  The model runs on frames padded to a multiple of 32
(reference _mel2hidden, rmvpe.py:139); the decode is local-average cents
around the salience argmax (rmvpe.py:119), `f0_device.py`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .device import device_constant
from .mel import mel_filterbank
from .stft import stft


def rmvpe_mel(wav: torch.Tensor, sr: int = 16000, n_fft: int = 1024,
              hop: int = 160, n_mels: int = 128, fmin: float = 30.0,
              fmax: float = 8000.0, clamp: float = 1e-5) -> torch.Tensor:
    """(B, T) -> (B, 128, frames), center=True framing."""
    basis = device_constant(
        ("mel_htk", sr, n_fft, n_mels, fmin, fmax),
        lambda: mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=True),
        wav.device)
    pad = n_fft // 2
    y = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    mag = stft(y, n_fft, hop).abs()
    return torch.log(torch.clamp(basis @ mag, min=clamp))


def rmvpe_salience(model, wav: torch.Tensor, sr: int = 16000,
                   hop: int = 160) -> torch.Tensor:
    """wav (B, T) -> salience (B, frames, 360): mel, frames zero-padded to
    a multiple of 32 for the U-net's five poolings, E2E, padding cut."""
    mel = rmvpe_mel(wav, sr, hop=hop)
    n_frames = mel.shape[-1]
    n_pad = 32 * ((n_frames - 1) // 32 + 1) - n_frames
    return model(F.pad(mel, (0, n_pad)))[:, :n_frames]
