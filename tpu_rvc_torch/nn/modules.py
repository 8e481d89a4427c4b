"""Base layers (port of tpu_rvc/nn/modules.py:60-399).

Parameters carry the reference torch names and layouts (Conv1d weight
(C_out, C_in, K), ConvTranspose1d (C_in, C_out, K), Linear (out, in)), so
an RVC `.pth` loads almost directly; weight norm is folded at load
(ckpt/convert.py), so no module here holds a (g, v) pair.  The conv stacks
(WN, ResBlock*) run channel-first (B, C, T) like the reference; LayerNorm1d
normalises the last axis of channel-last (B, T, C) input like the JAX
module.  The JAX package's TPU conv-policy branches (im2col vs direct) and
the time-packed conv are not ported: cuDNN takes these convs.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1


def normal_001_(module: nn.Module) -> nn.Module:
    """Reference `init_weights`: N(0, 0.01) for the vocoder's conv weights."""
    nn.init.normal_(module.weight, 0.0, 0.01)
    return module


class Conv1d(nn.Conv1d):
    """torch Conv1d on (B, C, T) with the reference's parameter names."""


class ConvTranspose1d(nn.ConvTranspose1d):
    """torch ConvTranspose1d, weight (C_in, C_out, K) as the reference
    stores it: no flip at load (the JAX layout flips K, convert.py)."""


class Linear(nn.Linear):
    """torch Linear, weight (out, in)."""


class LayerNorm1d(nn.Module):
    """Per-channel LayerNorm over the last axis of (B, T, C) (reference
    norms.py:12), parameters `gamma`/`beta` as the reference names them."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.gamma, self.beta, self.eps)


def gated_tanh_sigmoid(x_in, g_l, channels: int):
    """tanh(a[:h]) * sigmoid(a[h:]) with a = x_in + g_l, channel axis 1."""
    acts = x_in + g_l
    return torch.tanh(acts[:, :channels]) * torch.sigmoid(acts[:, channels:])


class WN(nn.Module):
    """Non-causal WaveNet block with global conditioning (reference
    norms.py:27).  x: (B, H, T); x_mask: (B, 1, T); g: (B, gin, 1)."""

    def __init__(self, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        self.gin_channels = gin_channels
        h = hidden_channels
        if gin_channels != 0:
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            padding = (kernel_size * dilation - dilation) // 2
            self.in_layers.append(Conv1d(h, 2 * h, kernel_size,
                                         dilation=dilation, padding=padding))
            res_skip = 2 * h if i < n_layers - 1 else h
            self.res_skip_layers.append(Conv1d(h, res_skip, 1))

    def forward(self, x, x_mask, g=None):
        h = self.hidden_channels
        output = torch.zeros_like(x)
        g_all = (self.cond_layer(g)
                 if g is not None and self.gin_channels != 0 else None)
        for i in range(self.n_layers):
            x_in = self.in_layers[i](x)
            g_l = (g_all[:, i * 2 * h:(i + 1) * 2 * h] if g_all is not None
                   else torch.zeros_like(x_in))
            acts = gated_tanh_sigmoid(x_in, g_l, h)
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask


def get_padding(kernel_size: int, dilation: int) -> int:
    return (kernel_size * dilation - dilation) // 2


class ResBlock1(nn.Module):
    """HiFiGAN ResBlock1 (reference residuals.py:19): 3x (dilated + plain)
    convs.  A weight container with no forward of its own: the decoder
    runs whole stages of these through the stage kernel, or its plain
    twin for CPU tensors (ops/kernels/resblock.py, `stage_weights`)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            normal_001_(Conv1d(channels, channels, kernel_size, dilation=d,
                               padding=get_padding(kernel_size, d)))
            for d in self.dilation)
        self.convs2 = nn.ModuleList(
            normal_001_(Conv1d(channels, channels, kernel_size,
                               padding=get_padding(kernel_size, 1)))
            for _ in self.dilation)


class ResBlock2(nn.Module):
    """HiFiGAN ResBlock2 (reference residuals.py:103)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs = nn.ModuleList(
            normal_001_(Conv1d(channels, channels, kernel_size, dilation=d,
                               padding=get_padding(kernel_size, d)))
            for d in self.dilation)

    def forward(self, x):
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x
