"""Mean-only affine coupling flow (port of tpu_rvc/nn/flows.py; reference
residuals.py:166-334): the reverse direction for inference, the forward
one (posterior z -> prior space) for training.

Channel-first (B, C, T).  `flows` alternates couplings and parameterless
Flips, so the couplings' reference names are `flow.flows.{0,2,4,6}`.
"""

from __future__ import annotations

import torch
from torch import nn

from .modules import Conv1d, WN


class ResidualCouplingLayer(nn.Module):
    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 weight_norm: bool = False):
        super().__init__()
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels, weight_norm)
        self.post = Conv1d(hidden_channels, self.half, 1)
        nn.init.zeros_(self.post.weight)
        nn.init.zeros_(self.post.bias)

    def _mean(self, x0, x_mask, g):
        h = self.enc(self.pre(x0) * x_mask, x_mask, g=g)
        return self.post(h) * x_mask

    def forward(self, x, x_mask, g=None):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        return torch.cat([x0, (self._mean(x0, x_mask, g) + x1) * x_mask],
                         dim=1)

    def reverse(self, x, x_mask, g=None):
        x0, x1 = x[:, :self.half], x[:, self.half:]
        return torch.cat([x0, (x1 - self._mean(x0, x_mask, g)) * x_mask],
                         dim=1)


class Flip(nn.Module):
    def forward(self, x):
        return torch.flip(x, dims=[1])


class ResidualCouplingBlock(nn.Module):
    """n_flows x (coupling + Flip).  `forward` runs the inference (reverse)
    direction unless `reverse=False`, the training one (the JAX module's
    `reverse` flag with the inference default; the logdet of mean-only
    couplings is 0 and is not returned)."""

    def __init__(self, channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1,
                 n_layers: int = 3, n_flows: int = 4, gin_channels: int = 0,
                 weight_norm: bool = False):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate,
                n_layers, gin_channels, weight_norm))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse: bool = True):
        if not reverse:
            for layer in self.flows:
                x = layer(x) if isinstance(layer, Flip) else layer(x, x_mask,
                                                                   g=g)
            return x
        for layer in reversed(self.flows):
            x = layer(x) if isinstance(layer, Flip) else \
                layer.reverse(x, x_mask, g=g)
        return x
