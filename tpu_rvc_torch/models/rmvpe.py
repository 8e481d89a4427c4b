"""RMVPE pitch model (port of tpu_rvc/models/rmvpe.py; reference
rvc/f0/e2e.py:8, rvc/f0/deepunet.py).

E2E(n_blocks=4, n_gru=1, kernel=(2, 2)): a 5-level res-conv U-net over the
128-mel log spectrogram, one bidirectional GRU and a 360-bin salience
head.  Layout is NCHW with (time, mel) as (H, W).  Module names follow the
reference checkpoint (`unet.encoder.layers.i.conv.j.conv.{0,1,3,4}`,
`unet.decoder.layers.i.conv1.{0,1}`, `fc.0.gru`, `fc.1`), so its keys load
as they are; BatchNorm is inference-only and kept folded into a
per-channel (scale, bias) pair, as the JAX package keeps it
(`ckpt/rmvpe_loader.py` folds the running statistics at load time).
Time must be a multiple of 2 ** en_de_layers (the callers pad to 32).
"""

from __future__ import annotations

import torch
from torch import nn

from tpu_rvc_torch.ops.kernels import bigru

N_MELS = 128
N_CLASS = 360


class FoldedBN(nn.Module):
    """Inference BatchNorm2d: y = x * scale + bias per channel."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.scale[:, None, None] + self.bias[:, None, None]


class ConvBlockRes(nn.Module):
    """2x (conv3x3 -> BN -> relu) + residual (reference deepunet.py:7)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False),
            FoldedBN(out_channels), nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1, bias=False),
            FoldedBN(out_channels), nn.ReLU())
        if in_channels != out_channels:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        h = self.conv(x)
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return h + x


class ResEncoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 n_blocks: int = 4, pool: bool = True):
        super().__init__()
        self.conv = nn.ModuleList(
            [ConvBlockRes(in_channels, out_channels)] +
            [ConvBlockRes(out_channels, out_channels)
             for _ in range(n_blocks - 1)])
        self.pool = nn.AvgPool2d(2) if pool else None

    def forward(self, x):
        for block in self.conv:
            x = block(x)
        if self.pool is not None:
            return x, self.pool(x)
        return x


class ResDecoderBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 n_blocks: int = 4):
        super().__init__()
        # out = 2 * in; the JAX side writes it as an lhs-dilated conv with
        # the kernel flipped (tpu_rvc/models/rmvpe.py:109-117)
        self.conv1 = nn.Sequential(
            nn.ConvTranspose2d(in_channels, out_channels, 3, stride=2,
                               padding=1, output_padding=1, bias=False),
            FoldedBN(out_channels), nn.ReLU())
        self.conv2 = nn.ModuleList(
            [ConvBlockRes(out_channels * 2, out_channels)] +
            [ConvBlockRes(out_channels, out_channels)
             for _ in range(n_blocks - 1)])

    def forward(self, x, skip):
        x = torch.cat([self.conv1(x), skip], dim=1)
        for block in self.conv2:
            x = block(x)
        return x


class _Layers(nn.Module):
    """A `layers` ModuleList under the reference's `encoder` /
    `intermediate` / `decoder` names."""

    def __init__(self, layers, bn_channels: int = 0):
        super().__init__()
        if bn_channels:
            self.bn = FoldedBN(bn_channels)
        self.layers = nn.ModuleList(layers)


class DeepUnet(nn.Module):
    def __init__(self, n_blocks: int = 4, en_de_layers: int = 5,
                 inter_layers: int = 4, en_out_channels: int = 16):
        super().__init__()
        enc, cin, cout = [], 1, en_out_channels
        for _ in range(en_de_layers):
            enc.append(ResEncoderBlock(cin, cout, n_blocks))
            cin, cout = cout, cout * 2
        self.encoder = _Layers(enc, bn_channels=1)
        self.intermediate = _Layers(
            [ResEncoderBlock(cin if i == 0 else cout, cout, n_blocks,
                             pool=False) for i in range(inter_layers)])
        dec, cin = [], cout
        for _ in range(en_de_layers):
            dec.append(ResDecoderBlock(cin, cin // 2, n_blocks))
            cin //= 2
        self.decoder = _Layers(dec)

    def forward(self, x):
        # x: (B, 1, T, 128)
        x = self.encoder.bn(x)
        skips = []
        for layer in self.encoder.layers:
            skip, x = layer(x)
            skips.append(skip)
        for layer in self.intermediate.layers:
            x = layer(x)
        for layer, skip in zip(self.decoder.layers, reversed(skips)):
            x = layer(x, skip)
        return x


class BiGRU(nn.Module):
    """1-layer bidirectional GRU (reference e2e.py:50); gate order r, z, n
    is torch's own.  `self.gru` only holds the parameters (the `fc.0.gru.*`
    keys); the forward is `ops/kernels/bigru.py`: the persistent kernel on
    the card, its plain twin on the CPU, never cuDNN's RNN."""

    def __init__(self, in_features: int, hidden: int = 256):
        super().__init__()
        self.gru = nn.GRU(in_features, hidden, batch_first=True,
                          bidirectional=True)

    def forward(self, x):
        return bigru(x, self.gru)


class E2E(nn.Module):
    """RMVPE end to end: mel (B, 128, T) -> salience (B, T, 360)."""

    def __init__(self, n_blocks: int = 4, n_gru: int = 1,
                 en_de_layers: int = 5, inter_layers: int = 4,
                 en_out_channels: int = 16):
        super().__init__()
        self.unet = DeepUnet(n_blocks, en_de_layers, inter_layers,
                             en_out_channels)
        self.cnn = nn.Conv2d(en_out_channels, 3, 3, padding=1)
        # the reference builds the GRU head for any n_gru > 0 and the
        # checkpoint has one; n_gru is kept for the constructor's parity
        self.fc = nn.Sequential(BiGRU(3 * N_MELS, 256),
                                nn.Linear(512, N_CLASS))

    def forward(self, mel):
        x = mel.transpose(1, 2)[:, None]              # (B, 1, T, 128)
        x = self.cnn(self.unet(x))                    # (B, 3, T, 128)
        x = x.transpose(1, 2).flatten(-2)             # (B, T, 3 * 128)
        return torch.sigmoid(self.fc(x))
