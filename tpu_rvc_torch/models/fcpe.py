"""FCPE pitch model (port of tpu_rvc/models/fcpe.py:36-169; reference
rvc/f0/fcpe.py:9 wraps torchfcpe's bundled model).

The conv-only CFNaiveMelPE of torchfcpe's bundled `fcpe_c_v001`
configuration, channels-first:

  log-mel (B, 128, T)
    -> input stem: conv3 -> GroupNorm(4) -> LeakyReLU(0.01) -> conv3
    -> n_layers residual conformer conv modules: LayerNorm over channels
       -> 1x1 to 2*inner -> GLU -> depthwise conv (31, padding 15/15)
       -> SiLU -> 1x1 back
    -> LayerNorm -> Linear -> sigmoid                     (B, T, 360)

Module names follow torchfcpe's checkpoint (`input_stem.{0,1,3}`,
`net.encoder_layers.i.conformer.net.{0,2,4,6}`, `norm`, `output_proj`),
with the transposes of its (B, T, C) layout as identities, so a state dict
in that layout loads once `ckpt/fcpe_loader.py` has folded the output
projection's weight norm.  Decode ("local_argmax"): the salience-weighted
mean of the cent table over the 9 bins around each frame's argmax
(indices clipped at the table's ends); a frame whose peak is not above
the threshold is unvoiced (f0 = 0).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_rvc_torch.core.device import device_constant
from tpu_rvc_torch.ops.mel import mel_filterbank
from tpu_rvc_torch.ops.stft import stft


def f0_to_cent(f0: float) -> float:
    return 1200.0 * math.log2(f0 / 10.0)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of (B, C, T), eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        mu = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        return ((x - mu) * torch.rsqrt(var + 1e-5) * self.weight[:, None]
                + self.bias[:, None])


class DepthWiseConv1d(nn.Module):
    """Depthwise conv with torchfcpe's padding (k // 2, (k - 1) // 2)."""

    def __init__(self, channels: int, kernel: int):
        super().__init__()
        self.padding = (kernel // 2, (kernel - 1) // 2)
        self.conv = nn.Conv1d(channels, channels, kernel, groups=channels)

    def forward(self, x):
        return self.conv(F.pad(x, self.padding))


class ConformerConvModule(nn.Module):
    """The residual branch of one conv-only conformer layer."""

    def __init__(self, dim: int, expansion: int = 2, kernel: int = 31):
        super().__init__()
        inner = dim * expansion
        self.net = nn.Sequential(
            ChannelLayerNorm(dim), nn.Identity(),
            nn.Conv1d(dim, 2 * inner, 1), nn.GLU(dim=1),
            DepthWiseConv1d(inner, kernel), nn.SiLU(),
            nn.Conv1d(inner, dim, 1), nn.Identity())

    def forward(self, x):
        return self.net(x)


class _Layer(nn.Module):
    def __init__(self, dim: int, expansion: int, kernel: int):
        super().__init__()
        self.conformer = ConformerConvModule(dim, expansion, kernel)


class _Encoder(nn.Module):
    def __init__(self, dim: int, n_layers: int, expansion: int, kernel: int):
        super().__init__()
        self.encoder_layers = nn.ModuleList(
            [_Layer(dim, expansion, kernel) for _ in range(n_layers)])


class CFNaiveMelPE(nn.Module):
    """torchfcpe CFNaiveMelPE, conv-only: mel (B, in_dims, T) -> salience
    (B, T, out_dims) in (0, 1)."""

    def __init__(self, in_dims: int = 128, hidden_dims: int = 512,
                 out_dims: int = 360, n_layers: int = 6, expansion: int = 2,
                 kernel: int = 31, f0_min: float = 32.70,
                 f0_max: float = 1975.5):
        super().__init__()
        self.out_dims = out_dims
        self.f0_min, self.f0_max = f0_min, f0_max
        self.input_stem = nn.Sequential(
            nn.Conv1d(in_dims, hidden_dims, 3, padding=1),
            nn.GroupNorm(4, hidden_dims), nn.LeakyReLU(0.01),
            nn.Conv1d(hidden_dims, hidden_dims, 3, padding=1))
        self.net = _Encoder(hidden_dims, n_layers, expansion, kernel)
        self.norm = nn.LayerNorm(hidden_dims)
        self.output_proj = nn.Linear(hidden_dims, out_dims)

    def forward(self, mel):
        x = self.input_stem(mel)
        for layer in self.net.encoder_layers:
            x = x + layer.conformer(x)
        x = self.norm(x.transpose(1, 2))
        return torch.sigmoid(self.output_proj(x))

    def cent_table(self, device) -> torch.Tensor:
        """out_dims equal steps from f0_min's to f0_max's cents."""
        lo, hi, n = f0_to_cent(self.f0_min), f0_to_cent(self.f0_max), \
            self.out_dims
        return device_constant(
            ("fcpe_cents", lo, hi, n),
            lambda: np.linspace(lo, hi, n).astype(np.float32), device)


def latent2cents_local(y: torch.Tensor, cent_table: torch.Tensor,
                       threshold: float = 0.006) -> torch.Tensor:
    """local_argmax decode: (..., T, D) -> (..., T) cents, -inf where the
    peak confidence is not above the threshold.  Where a row's maximum is
    tied the CPU takes the first bin; the CUDA argmax does not promise
    which."""
    D = y.shape[-1]
    conf = y.amax(dim=-1)
    center = torch.argmax(y, dim=-1)
    idx = torch.clamp(center[..., None]
                      + torch.arange(-4, 5, device=y.device), 0, D - 1)
    y_l = y.gather(-1, idx)
    cents = (y_l * cent_table[idx]).sum(-1) / y_l.sum(-1)
    return torch.where(conf > threshold, cents,
                       torch.full_like(cents, -math.inf))


def cents_to_f0(cents: torch.Tensor) -> torch.Tensor:
    """cent = 1200 * log2(f0 / 10); -inf cents decode to f0 = 0."""
    return 10.0 * torch.pow(2.0, cents / 1200.0)


def fcpe_mel(wav: torch.Tensor, sr: int = 16000, n_fft: int = 1024,
             hop: int = 160, n_mels: int = 128, fmin: float = 0.0,
             fmax: float = 8000.0, clamp: float = 1e-5) -> torch.Tensor:
    """torchfcpe Wav2Mel: the Slaney mel of a reflect-padded centred STFT
    magnitude, log-clamped.  (B, T) -> (B, n_mels, T // hop + 1)."""
    basis = device_constant(
        ("mel_slaney", sr, n_fft, n_mels, fmin, fmax),
        lambda: mel_filterbank(sr, n_fft, n_mels, fmin, fmax, htk=False),
        wav.device)
    pad = n_fft // 2
    y = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
    mag = stft(y, n_fft, hop).abs()
    return torch.log(torch.clamp(basis @ mag, min=clamp))


def fcpe_infer(model: CFNaiveMelPE, wav: torch.Tensor,
               threshold: float = 0.006) -> torch.Tensor:
    """wav (B, T) at 16 kHz -> f0 (B, T // 160 + 1), 0 = unvoiced."""
    latent = model(fcpe_mel(wav)).float()
    return cents_to_f0(latent2cents_local(latent, model.cent_table(
        wav.device), threshold))
