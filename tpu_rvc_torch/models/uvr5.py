"""UVR5 vocal/instrument separation nets (port of tpu_rvc/models/uvr5.py;
reference infer/lib/uvr5_pack/lib_v5/nets_123821KB.py `CascadedASPPNet`
with layers_123821KB.py, the HP2/HP3/HP5 weights, and nets.py
`CascadedNet` with layers.py, the VR-DeEcho/DeReverb weights).

NCHW: a spectrogram window is (B, 2 stereo channels, F bins, T frames), so
(H, W) is (frequency, time).  Module names follow the reference
checkpoints; BatchNorm is inference-only and kept folded into a
per-channel (scale, bias) pair, as the JAX package keeps it
(`ckpt/uvr5_loader.py` folds the running statistics at load time).  Each
net returns `mask * mix` for its whole input window; the separator crops
the `offset` frames of each edge.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tpu_rvc_torch.models.rmvpe import FoldedBN

Pair = Union[int, Tuple[int, int]]


class FoldedBN1d(nn.Module):
    """Inference BatchNorm1d over the last axis: y = x * scale + bias."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x * self.scale + self.bias


def _activ(name: str) -> nn.Module:
    return nn.ReLU() if name == "relu" else nn.LeakyReLU(0.01)


class Conv2DBNActiv(nn.Module):
    """conv -> folded BN -> activation (layers_123821KB.py:8, layers.py:8);
    `pad` and `dilation` may be (freq, time) pairs."""

    def __init__(self, nin: int, nout: int, ksize: int = 3, stride: int = 1,
                 pad: Pair = 1, dilation: Pair = 1, activ: str = "relu"):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, ksize, stride, pad, dilation, bias=False),
            FoldedBN(nout), _activ(activ))

    def forward(self, x):
        return self.conv(x)


class SeperableConv2DBNActiv(nn.Module):
    """depthwise -> pointwise -> folded BN -> activation
    (layers_123821KB.py:29)."""

    def __init__(self, nin: int, nout: int, ksize: int = 3, stride: int = 1,
                 pad: int = 1, dilation: int = 1, activ: str = "relu"):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nin, ksize, stride, pad, dilation, groups=nin,
                      bias=False),
            nn.Conv2d(nin, nout, 1, bias=False),
            FoldedBN(nout), _activ(activ))

    def forward(self, x):
        return self.conv(x)


class EncoderBlock(nn.Module):
    """conv (stride 1) -> skip, conv (stride) -> h (layers_123821KB.py:54)."""

    def __init__(self, nin: int, nout: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, 1, 1, activ="leaky")
        self.conv2 = Conv2DBNActiv(nout, nout, 3, stride, 1, activ="leaky")

    def forward(self, x):
        skip = self.conv1(x)
        return self.conv2(skip), skip


def crop_center(skip: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Crop `skip` to `like`'s (F, T) about the centre, time first, as
    tpu_rvc/models/uvr5.py:129-135 does."""
    if skip.shape[3] != like.shape[3]:
        s = (skip.shape[3] - like.shape[3]) // 2
        skip = skip[:, :, :, s:s + like.shape[3]]
    if skip.shape[2] != like.shape[2]:
        s = (skip.shape[2] - like.shape[2]) // 2
        skip = skip[:, :, s:s + like.shape[2]]
    return skip


class DecoderBlock(nn.Module):
    """2x bilinear upsample (align_corners=True), concat the centre-cropped
    skip, conv (layers_123821KB.py:76)."""

    def __init__(self, nin: int, nout: int):
        super().__init__()
        self.conv = Conv2DBNActiv(nin, nout, 3, 1, 1)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if skip is not None:
            x = torch.cat([x, crop_center(skip, x)], dim=1)
        return self.conv(x)


class ASPPModule(nn.Module):
    """Pooled, 1x1 and three dilated separable branches -> 1x1 bottleneck
    (layers_123821KB.py:95).  The pooled branch averages over frequency to
    (1, T), a 1x1 conv, and back to (F, T) bilinearly.  The reference's
    `conv1` is Sequential(pool, conv) and its `bottleneck` Sequential(conv,
    dropout): the port keeps their indices so that the keys load as they
    are."""

    def __init__(self, nin: int, nout: int,
                 dilations: Sequence[int] = (4, 8, 16)):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Identity(),
                                   Conv2DBNActiv(nin, nin, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nin, 1, 1, 0)
        self.conv3 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[0],
                                            dilations[0])
        self.conv4 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[1],
                                            dilations[1])
        self.conv5 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[2],
                                            dilations[2])
        self.bottleneck = nn.Sequential(Conv2DBNActiv(nin * 5, nout, 1, 1, 0))

    def forward(self, x):
        feats = [self.conv1[1](x.mean(dim=2, keepdim=True)), self.conv2(x),
                 self.conv3(x), self.conv4(x), self.conv5(x)]
        feats[0] = F.interpolate(feats[0], size=x.shape[2:], mode="bilinear",
                                 align_corners=True)
        return self.bottleneck(torch.cat(feats, dim=1))


class BaseASPPNet(nn.Module):
    """Four stride-2 encoders, ASPP, four decoders (nets_123821KB.py:8)."""

    def __init__(self, nin: int, ch: int,
                 dilations: Sequence[int] = (4, 8, 16)):
        super().__init__()
        self.enc1 = EncoderBlock(nin, ch)
        self.enc2 = EncoderBlock(ch, ch * 2)
        self.enc3 = EncoderBlock(ch * 2, ch * 4)
        self.enc4 = EncoderBlock(ch * 4, ch * 8)
        self.aspp = ASPPModule(ch * 8, ch * 16, dilations)
        self.dec4 = DecoderBlock(ch * (8 + 16), ch * 8)
        self.dec3 = DecoderBlock(ch * (4 + 8), ch * 4)
        self.dec2 = DecoderBlock(ch * (2 + 4), ch * 2)
        self.dec1 = DecoderBlock(ch * (1 + 2), ch)

    def forward(self, x):
        h, e1 = self.enc1(x)
        h, e2 = self.enc2(h)
        h, e3 = self.enc3(h)
        h, e4 = self.enc4(h)
        h = self.aspp(h)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        return self.dec1(h, e1)


def _mask_times_mix(mask: torch.Tensor, mix: torch.Tensor, output_bin: int,
                    aggressiveness: Optional[Tuple[float, int]]
                    ) -> torch.Tensor:
    """Replicate-pad the mask's frequency axis to `output_bin`, raise the
    bins below and above `split_bin` to 1 + value / 3 and 1 + value
    (tpu_rvc/models/uvr5.py:210-219), multiply by the input."""
    pad_f = output_bin - mask.shape[2]
    if pad_f > 0:
        mask = torch.cat([mask, mask[:, :, -1:].expand(-1, -1, pad_f, -1)],
                         dim=2)
    if aggressiveness is not None:
        value, split_bin = aggressiveness
        mask = torch.cat([mask[:, :, :split_bin] ** (1 + value / 3),
                          mask[:, :, split_bin:] ** (1 + value)], dim=2)
    return mask * mix


class CascadedASPPNet(nn.Module):
    """HP2/HP3/HP5 separator (nets_123821KB.py:40).  Input (B, 2, F, T)
    magnitude with F = n_fft // 2 + 1; output the masked magnitude, same
    shape.  `aggressiveness` is (value, split_bin); `value` may be a
    0-d tensor."""

    def __init__(self, n_fft: int, offset: int = 128):
        super().__init__()
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.offset = offset   # frames cropped from each window edge
        self.stg1_low_band_net = BaseASPPNet(2, 32)
        self.stg1_high_band_net = BaseASPPNet(2, 32)
        self.stg2_bridge = Conv2DBNActiv(34, 16, 1, 1, 0)
        self.stg2_full_band_net = BaseASPPNet(16, 32)
        self.stg3_bridge = Conv2DBNActiv(66, 32, 1, 1, 0)
        self.stg3_full_band_net = BaseASPPNet(32, 64)
        self.out = nn.Conv2d(64, 2, 1, bias=False)

    def forward(self, x, aggressiveness: Optional[Tuple] = None):
        mix = x
        x = x[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bandw]),
                          self.stg1_high_band_net(x[:, :, bandw:])], dim=2)
        h = self.stg2_bridge(torch.cat([x, aux1], dim=1))
        aux2 = self.stg2_full_band_net(h)
        h = self.stg3_bridge(torch.cat([x, aux1, aux2], dim=1))
        h = self.stg3_full_band_net(h)
        mask = torch.sigmoid(self.out(h))
        return _mask_times_mix(mask, mix, self.output_bin, aggressiveness)


# ---------------------------------------------------------------------------
# DeEcho / DeReverb: CascadedNet with BiLSTM bottlenecks (reference nets.py
# + layers.py)
# ---------------------------------------------------------------------------


class LSTMModule(nn.Module):
    """1x1 conv to one channel -> BiLSTM over time with the bins as
    features -> dense, folded BatchNorm1d, ReLU (layers.py:109).
    (B, C, F, T) -> (B, 1, F, T)."""

    def __init__(self, nin_conv: int, nin_lstm: int, nout_lstm: int):
        super().__init__()
        self.conv = Conv2DBNActiv(nin_conv, 1, 1, 1, 0)
        self.lstm = nn.LSTM(nin_lstm, nout_lstm // 2, bidirectional=True)
        self.dense = nn.Sequential(nn.Linear(nout_lstm, nin_lstm),
                                   FoldedBN1d(nin_lstm), nn.ReLU())

    def forward(self, x):
        h = self.conv(x)[:, 0].permute(2, 0, 1)   # (T, B, F)
        h, _ = self.lstm(h)
        h = self.dense(h)                         # (T, B, F)
        return h.permute(1, 2, 0)[:, None]


class ASPPModuleNew(nn.Module):
    """Pooled, 1x1 and three dense dilated branches with (freq, time)
    dilation pairs -> 1x1 bottleneck (layers.py:70)."""

    def __init__(self, nin: int, nout: int,
                 dilations: Sequence[Tuple[int, int]] = ((4, 2), (8, 4),
                                                         (12, 6))):
        super().__init__()
        self.conv1 = nn.Sequential(nn.Identity(),
                                   Conv2DBNActiv(nin, nout, 1, 1, 0))
        self.conv2 = Conv2DBNActiv(nin, nout, 1, 1, 0)
        self.conv3 = Conv2DBNActiv(nin, nout, 3, 1, dilations[0],
                                   dilations[0])
        self.conv4 = Conv2DBNActiv(nin, nout, 3, 1, dilations[1],
                                   dilations[1])
        self.conv5 = Conv2DBNActiv(nin, nout, 3, 1, dilations[2],
                                   dilations[2])
        self.bottleneck = Conv2DBNActiv(nout * 5, nout, 1, 1, 0)

    forward = ASPPModule.forward


class EncoderNew(nn.Module):
    """conv (stride) -> conv (stride 1), one output (layers.py:30)."""

    def __init__(self, nin: int, nout: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, 3, stride, 1, activ="leaky")
        self.conv2 = Conv2DBNActiv(nout, nout, 3, 1, 1, activ="leaky")

    def forward(self, x):
        return self.conv2(self.conv1(x))


class BaseNetNew(nn.Module):
    """The DeEcho CascadedNet's BaseNet (nets.py:8): four stride-2
    encoders, dense ASPP, decoders, and a BiLSTM over the dec2 level
    concatenated before the last decoder."""

    def __init__(self, nin: int, nout: int, nin_lstm: int, nout_lstm: int,
                 dilations: Sequence[Tuple[int, int]] = ((4, 2), (8, 4),
                                                         (12, 6))):
        super().__init__()
        self.enc1 = Conv2DBNActiv(nin, nout, 3, 1, 1)
        self.enc2 = EncoderNew(nout, nout * 2)
        self.enc3 = EncoderNew(nout * 2, nout * 4)
        self.enc4 = EncoderNew(nout * 4, nout * 6)
        self.enc5 = EncoderNew(nout * 6, nout * 8)
        self.aspp = ASPPModuleNew(nout * 8, nout * 8, dilations)
        self.dec4 = DecoderBlock(nout * (6 + 8), nout * 6)
        self.dec3 = DecoderBlock(nout * (4 + 6), nout * 4)
        self.dec2 = DecoderBlock(nout * (2 + 4), nout * 2)
        self.lstm_dec2 = LSTMModule(nout * 2, nin_lstm, nout_lstm)
        self.dec1 = DecoderBlock(nout * (1 + 2) + 1, nout)

    def forward(self, x):
        e1 = self.enc1(x)
        e2 = self.enc2(e1)
        e3 = self.enc3(e2)
        e4 = self.enc4(e3)
        e5 = self.enc5(e4)
        h = self.aspp(e5)
        h = self.dec4(h, e4)
        h = self.dec3(h, e3)
        h = self.dec2(h, e2)
        h = torch.cat([h, self.lstm_dec2(h)], dim=1)
        return self.dec1(h, e1)


class CascadedNetDeEcho(nn.Module):
    """DeEcho/DeReverb separator (nets.py:47 `CascadedNet`).  Input
    (B, 2, F, T) magnitude; output the masked magnitude, same shape."""

    def __init__(self, n_fft: int, nout: int = 32, nout_lstm: int = 128,
                 offset: int = 64):
        super().__init__()
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.offset = offset
        nin_lstm = self.max_bin // 2
        self.stg1_low_band_net = nn.Sequential(
            BaseNetNew(2, nout // 2, nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout // 2, nout // 4, 1, 1, 0))
        self.stg1_high_band_net = BaseNetNew(2, nout // 4, nin_lstm // 2,
                                             nout_lstm // 2)
        self.stg2_low_band_net = nn.Sequential(
            BaseNetNew(nout // 4 + 2, nout, nin_lstm // 2, nout_lstm),
            Conv2DBNActiv(nout, nout // 2, 1, 1, 0))
        self.stg2_high_band_net = BaseNetNew(nout // 4 + 2, nout // 2,
                                             nin_lstm // 2, nout_lstm // 2)
        self.stg3_full_band_net = BaseNetNew(3 * nout // 4 + 2, nout,
                                             nin_lstm, nout_lstm)
        self.out = nn.Conv2d(nout, 2, 1, bias=False)

    def forward(self, x, aggressiveness: Optional[Tuple] = None):
        mix = x
        x = x[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        l1_in, h1_in = x[:, :, :bandw], x[:, :, bandw:]
        l1 = self.stg1_low_band_net(l1_in)
        h1 = self.stg1_high_band_net(h1_in)
        aux1 = torch.cat([l1, h1], dim=2)
        l2 = self.stg2_low_band_net(torch.cat([l1_in, l1], dim=1))
        h2 = self.stg2_high_band_net(torch.cat([h1_in, h1], dim=1))
        aux2 = torch.cat([l2, h2], dim=2)
        f3 = self.stg3_full_band_net(torch.cat([x, aux1, aux2], dim=1))
        mask = torch.sigmoid(self.out(f3))
        return _mask_times_mix(mask, mix, self.output_bin, aggressiveness)
