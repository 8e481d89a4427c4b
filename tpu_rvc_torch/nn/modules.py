"""Base layers (port of tpu_rvc/nn/modules.py:60-399).

Parameters carry the reference torch names and layouts (Conv1d weight
(C_out, C_in, K), ConvTranspose1d (C_in, C_out, K), Linear (out, in)), so
an RVC `.pth` loads almost directly.  The inference modules hold plain
weights, weight norm folded at load (ckpt/convert.py); built with
`weight_norm=True` (the trainer's layout) the convs the reference keeps
under weight norm hold `weight_g`/`weight_v` instead (`WNConv1d`,
`WNConvTranspose1d`), as its training checkpoints do.  The conv stacks
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
    """Reference `init_weights`: N(0, 0.01) for the vocoder's conv weights
    (for a weight-normed conv: v drawn so, g its norm, so weight = v)."""
    with torch.no_grad():
        if isinstance(module, _WeightNorm):
            nn.init.normal_(module.weight_v, 0.0, 0.01)
            module.weight_g.copy_(_norm_but_0(module.weight_v))
        else:
            nn.init.normal_(module.weight, 0.0, 0.01)
    return module


class Conv1d(nn.Conv1d):
    """torch Conv1d on (B, C, T) with the reference's parameter names."""


class ConvTranspose1d(nn.ConvTranspose1d):
    """torch ConvTranspose1d, weight (C_in, C_out, K) as the reference
    stores it: no flip at load (the JAX layout flips K, convert.py)."""


def _norm_but_0(v: torch.Tensor) -> torch.Tensor:
    """||v|| over every axis but 0, kept as (n, 1, ...)."""
    return torch.sqrt((v * v).sum(dim=tuple(range(1, v.dim())), keepdim=True))


class _WeightNorm:
    """Weight norm as the reference's training checkpoints hold it
    (torch.nn.utils.weight_norm, dim 0): parameters `weight_g` (n, 1, 1)
    and `weight_v`, and `weight` = v g / ||v|| computed at every use (one
    fused op, `torch._weight_norm`, forward and backward), so a reader of
    `.weight` (the decoder's stage cache) never sees a stale fold.  The
    kept axis 0 is C_out of a Conv1d and C_in of a ConvTranspose1d
    (tpu_rvc/ckpt/convert.py:68-96)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)          # the conv, with its `weight`
        w = self._parameters.pop("weight").detach()
        self.weight_g = nn.Parameter(_norm_but_0(w))
        self.weight_v = nn.Parameter(w.clone())

    @property
    def weight(self) -> torch.Tensor:
        p = self._parameters
        if "weight_v" in p:
            return torch._weight_norm(p["weight_v"], p["weight_g"], 0)
        if "weight" in p:          # inside the conv's __init__, before the split
            return p["weight"]
        raise AttributeError("weight")


class WNConv1d(_WeightNorm, Conv1d):
    pass


class WNConvTranspose1d(_WeightNorm, ConvTranspose1d):
    pass


class WNConv2d(_WeightNorm, nn.Conv2d):
    pass


def conv1d(*args, weight_norm: bool = False, **kw) -> Conv1d:
    return (WNConv1d if weight_norm else Conv1d)(*args, **kw)


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
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 weight_norm: bool = False):
        super().__init__()
        self.hidden_channels = hidden_channels
        self.n_layers = n_layers
        self.gin_channels = gin_channels
        h, wn = hidden_channels, weight_norm
        if gin_channels != 0:
            self.cond_layer = conv1d(gin_channels, 2 * h * n_layers, 1,
                                     weight_norm=wn)
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            padding = (kernel_size * dilation - dilation) // 2
            self.in_layers.append(conv1d(h, 2 * h, kernel_size,
                                         dilation=dilation, padding=padding,
                                         weight_norm=wn))
            res_skip = 2 * h if i < n_layers - 1 else h
            self.res_skip_layers.append(conv1d(h, res_skip, 1,
                                               weight_norm=wn))

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
    convs.  Inference runs whole stages of these through the stage kernel,
    or its plain twin for CPU tensors (ops/kernels/resblock.py,
    `stage_weights`); `forward` is the differentiable path the trainer
    runs (tpu_rvc/nn/modules.py:355-375)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5),
                 weight_norm: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs1 = nn.ModuleList(
            normal_001_(conv1d(channels, channels, kernel_size, dilation=d,
                               padding=get_padding(kernel_size, d),
                               weight_norm=weight_norm))
            for d in self.dilation)
        self.convs2 = nn.ModuleList(
            normal_001_(conv1d(channels, channels, kernel_size,
                               padding=get_padding(kernel_size, 1),
                               weight_norm=weight_norm))
            for _ in self.dilation)

    def forward(self, x, x_mask=None):
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            xt = F.leaky_relu(c1(xt), LRELU_SLOPE)
            if x_mask is not None:
                xt = xt * x_mask
            x = c2(xt) + x
        return x if x_mask is None else x * x_mask


class ResBlock2(nn.Module):
    """HiFiGAN ResBlock2 (reference residuals.py:103)."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3), weight_norm: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilation = tuple(dilation)
        self.convs = nn.ModuleList(
            normal_001_(conv1d(channels, channels, kernel_size, dilation=d,
                               padding=get_padding(kernel_size, d),
                               weight_norm=weight_norm))
            for d in self.dilation)

    def forward(self, x):
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x
