"""CREPE "full" pitch model (port of tpu_rvc/models/crepe.py; reference
rvc/f0/crepe.py:10 wraps torchcrepe).

Kim et al. 2018 in torchcrepe's layout: a 1024-sample frame at 16 kHz as
an (N, 1, 1024, 1) image, six blocks of conv (k x 1; filters
1024/128/128/128/256/512, widths 512/64/64/64/64/64, the first with stride
4; "same" padding with the odd sample at the start), ReLU, BatchNorm
(folded at load, `ckpt/crepe_loader.py`) and max-pool 2, then a 2048 ->
360 sigmoid classifier over 20-cent bins.  Module names follow torchcrepe's
`full.pth` (`conv{i}`, `conv{i}_BN`, `classifier`).  `crepe_salience`
frames and standardises the signal on the device, as torchcrepe's
preprocess does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .rmvpe import FoldedBN

WINDOW = 1024
FILTERS = (1024, 128, 128, 128, 256, 512)
WIDTHS = (512, 64, 64, 64, 64, 64)
STRIDES = (4, 1, 1, 1, 1, 1)
N_BINS = 360
CENTS_MAPPING = 20 * np.arange(N_BINS) + 1997.3794084376191


class Crepe(nn.Module):
    """Standardised frames (N, 1024) -> salience (N, 360)."""

    def __init__(self):
        super().__init__()
        c_in = 1
        for i, (f, w, s) in enumerate(zip(FILTERS, WIDTHS, STRIDES), 1):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, f, (w, 1), (s, 1)))
            setattr(self, f"conv{i}_BN", FoldedBN(f))
            c_in = f
        self.classifier = nn.Linear(FILTERS[-1] * 4, N_BINS)

    def forward(self, frames):
        x = frames[:, None, :, None]
        for i, (w, s) in enumerate(zip(WIDTHS, STRIDES), 1):
            n = x.shape[2]
            pad = max((-(-n // s) - 1) * s + w - n, 0)
            x = F.pad(x, (0, 0, pad - pad // 2, pad // 2))
            x = F.relu(getattr(self, f"conv{i}")(x))
            x = getattr(self, f"conv{i}_BN")(x)
            x = F.max_pool2d(x, (2, 1), (2, 1))
        # (N, C, H, 1) flattened h-major, as torchcrepe's classifier reads it
        x = x.permute(0, 2, 1, 3).reshape(x.shape[0], -1)
        return torch.sigmoid(self.classifier(x))


def crepe_salience(model: Crepe, wav: torch.Tensor,
                   hop: int = 160) -> torch.Tensor:
    """wav (T,) at 16 kHz -> salience (1 + T // hop, 360): frames of 1024
    centred on every hop of the zero-padded signal, each standardised to
    zero mean and unit variance (std floor 1e-10)."""
    frames = F.pad(wav, (WINDOW // 2, WINDOW // 2)).unfold(0, WINDOW, hop)
    mu = frames.mean(dim=1, keepdim=True)
    sd = frames.std(dim=1, unbiased=False, keepdim=True).clamp_min(1e-10)
    return model((frames - mu) / sd)
