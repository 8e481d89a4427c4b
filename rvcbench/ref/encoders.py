"""Text/unit encoder enc_p and posterior encoder enc_q (port of
tpu_rvc/nn/encoders.py).

Channel-last like the JAX modules: phone (B, T, D), pitch (B, T) int
coarse bins, spec (B, T, F); they return m/logs (B, T', C) and the mask
(B, T', 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .device import draw_normal
from .attention import Encoder
from .modules import WN, Conv1d, Linear


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) 0/1 float mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(torch.float32)


class TextEncoder(nn.Module):
    """Reference rvc/layers/encoders.py:84: phone(+pitch) embedding ->
    relative-attention encoder -> (m, logs)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int, f0: bool = True,
                 p_dropout: float = 0.0):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb_phone = Linear(in_channels, hidden_channels)
        self.emb_pitch = nn.Embedding(256, hidden_channels) if f0 else None
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size, p_dropout=p_dropout)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, phone, pitch, lengths, skip_head: Optional[int] = None,
                train: bool = False):
        """`train=True` takes the encoder's differentiable branches (see
        nn/attention.py)."""
        x = self.emb_phone(phone)
        if self.emb_pitch is not None and pitch is not None:
            x = x + self.emb_pitch(pitch.long())
        x = F.leaky_relu(x * math.sqrt(self.hidden_channels), 0.1)
        x_mask = sequence_mask(lengths, x.shape[1])[..., None].to(x.dtype)
        x = self.encoder(x * x_mask, x_mask, train)
        if skip_head is not None:
            x = x[:, int(skip_head):]
            x_mask = x_mask[:, int(skip_head):]
        stats = F.linear(x, self.proj.weight[:, :, 0], self.proj.bias) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=-1)
        return m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """enc_q, training only (reference encoders.py:162;
    tpu_rvc/nn/encoders.py:70-104): linear spectrogram -> WN(16) ->
    (z, m, logs).  `eps` (B, T, C) pins the reparametrisation draw, else
    it comes from `generator` (or a list of them, one a row)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0, weight_norm: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels, weight_norm)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, x, x_lengths, g=None, eps=None,
                generator: Optional[torch.Generator] = None):
        # x: (B, T, spec_channels); g: (B, gin, 1)
        x_mask = sequence_mask(x_lengths, x.shape[1])[:, None, :].to(x.dtype)
        h = self.pre(x.transpose(1, 2)) * x_mask
        h = self.enc(h, x_mask, g=g)
        stats = (self.proj(h) * x_mask).transpose(1, 2)      # (B, T, 2C)
        m, logs = torch.split(stats, self.out_channels, dim=-1)
        if eps is None:
            eps = draw_normal(m.shape, generator, m)
        mask = x_mask.transpose(1, 2)
        z = (m + eps.to(m.dtype) * torch.exp(logs)) * mask
        return z, m, logs, mask
