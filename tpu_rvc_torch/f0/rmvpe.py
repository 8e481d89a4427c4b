"""RMVPE estimator (port of tpu_rvc/f0/rmvpe.py; reference
rvc/f0/rmvpe.py:40).

Mel frontend: 128 HTK mels over [30, 8000] Hz, n_fft 1024, hop 160,
reflect pad 512 (center=True framing), log-clamp 1e-5 (reference
rvc/f0/mel.py:10).  The model runs on frames padded to a multiple of 32
(reference _mel2hidden, rmvpe.py:139); the decode is local-average cents
around the salience argmax (rmvpe.py:119).  wav -> salience runs on the
estimator's device; `RMVPE.compute_f0` decodes in numpy, the on-device
decode is `f0/device.py:rmvpe_f0_device`.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.core.device import (device_constant, fp32_math,
                                       resolve_device)
from tpu_rvc_torch.ops.mel import mel_filterbank
from tpu_rvc_torch.ops.stft import stft
from .base import F0Predictor, interpolate_f0, resize_f0

CENTS_MAPPING = 20 * np.arange(360) + 1997.3794084376191


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


def to_local_average_cents(salience: np.ndarray, threshold: float = 0.05
                           ) -> np.ndarray:
    """(T, 360) salience -> cents, the salience-weighted mean over the 9
    bins around the argmax; 0 where the peak is not above the threshold
    (reference rmvpe.py:119, vectorised)."""
    center = np.argmax(salience, axis=1)
    sal_p = np.pad(salience, ((0, 0), (4, 4)))
    cents_p = np.pad(CENTS_MAPPING, (4, 4))
    idx = (center + 4)[:, None] + np.arange(-4, 5)[None, :]
    rows = np.arange(salience.shape[0])[:, None]
    todo_sal = sal_p[rows, idx]
    divided = (todo_sal * cents_p[idx]).sum(1) / todo_sal.sum(1)
    divided[salience.max(axis=1) <= threshold] = 0
    return divided


class RMVPE(F0Predictor):
    """`model_path` is read with `load_rmvpe` unless `model` (an E2E
    module) is given; a missing file raises FileNotFoundError here."""

    def __init__(self, model_path: str = "assets/rmvpe/rmvpe.pt",
                 hop_length: int = 160, sampling_rate: int = 16000,
                 model=None, device=None):
        super().__init__(hop_length, 30.0, 8000.0, sampling_rate)
        self.device = resolve_device(device)
        if model is None:
            from tpu_rvc_torch.ckpt.rmvpe_loader import load_rmvpe
            model = load_rmvpe(model_path, self.device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    @fp32_math()
    def compute_f0(self, wav: np.ndarray, p_len: Optional[int] = None,
                   filter_radius: Optional[Union[int, float]] = 0.03
                   ) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if p_len is None:
            p_len = wav.shape[0] // self.hop_length
        hidden = rmvpe_salience(
            self.model, torch.from_numpy(wav).to(self.device)[None],
            self.sampling_rate, self.hop_length)[0].cpu().numpy()
        thred = 0.03 if filter_radius is None else float(filter_radius)
        cents = to_local_average_cents(hidden, threshold=thred)
        f0 = 10.0 * (2.0 ** (cents / 1200.0))
        f0[f0 == 10] = 0
        return interpolate_f0(resize_f0(f0, p_len))[0]
