"""Text/unit encoder enc_p (port of tpu_rvc/nn/encoders.py:16-67).

Channel-last like the JAX module: phone (B, T, D), pitch (B, T) int coarse
bins; returns m/logs (B, T', C) and the mask (B, T', 1).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import Encoder
from .modules import Conv1d, Linear


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) 0/1 float mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(torch.float32)


class TextEncoder(nn.Module):
    """Reference rvc/layers/encoders.py:84: phone(+pitch) embedding ->
    relative-attention encoder -> (m, logs)."""

    def __init__(self, in_channels: int, out_channels: int,
                 hidden_channels: int, filter_channels: int, n_heads: int,
                 n_layers: int, kernel_size: int, f0: bool = True):
        super().__init__()
        self.out_channels = out_channels
        self.hidden_channels = hidden_channels
        self.emb_phone = Linear(in_channels, hidden_channels)
        self.emb_pitch = nn.Embedding(256, hidden_channels) if f0 else None
        self.encoder = Encoder(hidden_channels, filter_channels, n_heads,
                               n_layers, kernel_size)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1)

    def forward(self, phone, pitch, lengths, skip_head: Optional[int] = None):
        x = self.emb_phone(phone)
        if self.emb_pitch is not None and pitch is not None:
            x = x + self.emb_pitch(pitch.long())
        x = F.leaky_relu(x * math.sqrt(self.hidden_channels), 0.1)
        x_mask = sequence_mask(lengths, x.shape[1])[..., None].to(x.dtype)
        x = self.encoder(x * x_mask, x_mask)
        if skip_head is not None:
            x = x[:, int(skip_head):]
            x_mask = x_mask[:, int(skip_head):]
        stats = F.linear(x, self.proj.weight[:, :, 0], self.proj.bias) * x_mask
        m, logs = torch.split(stats, self.out_channels, dim=-1)
        return m, logs, x_mask
