"""Multi-period discriminator, training only (port of
tpu_rvc/nn/discriminators.py; reference rvc/layers/discriminators.py).

The reference's layout and names, so a reference `D_*.pth` loads with
`load_state_dict` (tpu_rvc/ckpt/convert.py:352-354): `discriminators.0`
is `DiscriminatorS`, a stack of grouped weight-normed Conv1d on the
waveform; `discriminators.{1..}` are `DiscriminatorP(period)`, weight-normed
Conv2d with (k, 1) kernels on the waveform folded to (T / p, p), reflect
padded to a multiple of p.  v1 periods (2, 3, 5, 7, 11, 17), v2 adds
(23, 37).  Waveforms are channel-first (B, 1, T); feature maps come out
as torch lays them, (B, C, T') and (B, C, T' / p, p).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .modules import LRELU_SLOPE, WNConv1d, WNConv2d, get_padding

V1_PERIODS = (2, 3, 5, 7, 11, 17)
V2_PERIODS = (2, 3, 5, 7, 11, 17, 23, 37)


class DiscriminatorS(nn.Module):
    """Scale discriminator on the raw waveform (reference :69)."""

    def __init__(self):
        super().__init__()
        self.convs = nn.ModuleList([
            WNConv1d(1, 16, 15, 1, padding=7),
            WNConv1d(16, 64, 41, 4, groups=4, padding=20),
            WNConv1d(64, 256, 41, 4, groups=16, padding=20),
            WNConv1d(256, 1024, 41, 4, groups=64, padding=20),
            WNConv1d(1024, 1024, 41, 4, groups=256, padding=20),
            WNConv1d(1024, 1024, 5, 1, padding=2),
        ])
        self.conv_post = WNConv1d(1024, 1, 3, 1, padding=1)

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fmap = []
        for conv in self.convs:
            x = grouped_conv1d(conv, x) if conv.groups > 1 else conv(x)
            x = F.leaky_relu(x, LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


def grouped_conv1d(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A grouped Conv1d as one batched product over the unfolded frames
    of x (B, C, T): the same sums as the convolution.  cuDNN's
    deterministic algorithms for DiscriminatorS's grouped layers (4 input
    channels a group, kernel 41, stride 4), which the deterministic
    training step takes on the card (`core/device.py`
    `deterministic_math`), made their backward 4-7x slower than the
    default's on an NVIDIA H100 80GB HBM3 at 700 W
    (`tools/determinism_probe.py --profile`); a product's backward has
    no atomic adds."""
    G, (k,), (s,), (p,) = (conv.groups, conv.kernel_size, conv.stride,
                           conv.padding)
    B, C = x.shape[:2]
    w = conv.weight
    O = w.shape[0]
    frames = F.pad(x, (p, p)).unfold(-1, k, s)          # (B, C, T', k)
    frames = frames.reshape(B, G, C // G, frames.shape[2], k)
    y = torch.einsum("bgctk,gock->bgot", frames,
                     w.reshape(G, O // G, C // G, k))
    return y.reshape(B, O, -1) + conv.bias[:, None].to(y.dtype)


class DiscriminatorP(nn.Module):
    """Period discriminator (reference :104)."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3):
        super().__init__()
        self.period = period
        pad = (get_padding(kernel_size, 1), 0)
        chans = (1, 32, 128, 512, 1024)
        self.convs = nn.ModuleList(
            [WNConv2d(ci, co, (kernel_size, 1), (stride, 1), padding=pad)
             for ci, co in zip(chans[:-1], chans[1:])]
            + [WNConv2d(1024, 1024, (kernel_size, 1), 1, padding=pad)])
        self.conv_post = WNConv2d(1024, 1, (3, 1), 1, padding=(1, 0))

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, c, t = x.shape
        if t % self.period:
            n_pad = self.period - t % self.period
            x = F.pad(x, (0, n_pad), "reflect")
            t += n_pad
        x = x.view(b, c, t // self.period, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return torch.flatten(x, 1, -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """DiscriminatorS and one DiscriminatorP per period (reference :14).
    Each discriminator sees the real and the generated batch as one batch
    of 2B; per sample this is the reference's two calls."""

    def __init__(self, version: str = "v2"):
        super().__init__()
        periods = V2_PERIODS if version == "v2" else V1_PERIODS
        self.discriminators = nn.ModuleList(
            [DiscriminatorS()] + [DiscriminatorP(p) for p in periods])

    def forward(self, y, y_hat):
        # y, y_hat: (B, 1, T)
        B = y.shape[0]
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        both = torch.cat([y, y_hat.to(y.dtype)], dim=0)
        for d in self.discriminators:
            out, fmap = d(both)
            y_d_rs.append(out[:B])
            y_d_gs.append(out[B:])
            fmap_rs.append([f[:B] for f in fmap])
            fmap_gs.append([f[B:] for f in fmap])
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
