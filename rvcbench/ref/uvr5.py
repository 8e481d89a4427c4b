"""UVR5's HP2/HP3/HP5 separator net written out again from upstream
(infer/lib/uvr5_pack/lib_v5/nets_123821KB.py `CascadedASPPNet` with
layers_123821KB.py, RVC-Project/Retrieval-based-Voice-Conversion-WebUI):
three cascaded U-Nets of four stride-2 encoders, an ASPP block (a pooled
branch, a 1x1 branch, three dilated depthwise-separable branches) and
four decoders, each convolution followed by a BatchNorm that keeps its
running statistics (eval mode, nothing folded), then a sigmoid mask
raised by the aggressiveness and applied to the input magnitude.

The modules and their names are upstream's, so a checkpoint's
state_dict loads as it is, the training-only auxiliary heads included.
NCHW: a window is (B, 2 channels, F bins, T frames)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def crop_center(h1: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """h1 cut to h2's frames about the centre (upstream spec_utils.py's
    crop_center: time only)."""
    if h1.shape[3] == h2.shape[3]:
        return h1
    if h1.shape[3] < h2.shape[3]:
        raise ValueError("h1_shape[3] must be greater than h2_shape[3]")
    s = (h1.shape[3] - h2.shape[3]) // 2
    return h1[:, :, :, s:s + h2.shape[3]]


class Conv2DBNActiv(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1,
                 activ=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nout, kernel_size=ksize, stride=stride,
                      padding=pad, dilation=dilation, bias=False),
            nn.BatchNorm2d(nout), activ())

    def forward(self, x):
        return self.conv(x)


class SeperableConv2DBNActiv(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, dilation=1,
                 activ=nn.ReLU):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Conv2d(nin, nin, kernel_size=ksize, stride=stride,
                      padding=pad, dilation=dilation, groups=nin,
                      bias=False),
            nn.Conv2d(nin, nout, kernel_size=1, bias=False),
            nn.BatchNorm2d(nout), activ())

    def forward(self, x):
        return self.conv(x)


class Encoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1,
                 activ=nn.LeakyReLU):
        super().__init__()
        self.conv1 = Conv2DBNActiv(nin, nout, ksize, 1, pad, activ=activ)
        self.conv2 = Conv2DBNActiv(nout, nout, ksize, stride, pad,
                                   activ=activ)

    def forward(self, x):
        skip = self.conv1(x)
        return self.conv2(skip), skip


class Decoder(nn.Module):
    def __init__(self, nin, nout, ksize=3, stride=1, pad=1, activ=nn.ReLU):
        super().__init__()
        self.conv = Conv2DBNActiv(nin, nout, ksize, 1, pad, activ=activ)

    def forward(self, x, skip=None):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if skip is not None:
            x = torch.cat([x, crop_center(skip, x)], dim=1)
        return self.conv(x)


class ASPPModule(nn.Module):
    def __init__(self, nin, nout, dilations=(4, 8, 16), activ=nn.ReLU):
        super().__init__()
        self.conv1 = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, None)),
            Conv2DBNActiv(nin, nin, 1, 1, 0, activ=activ))
        self.conv2 = Conv2DBNActiv(nin, nin, 1, 1, 0, activ=activ)
        self.conv3 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[0],
                                            dilations[0], activ=activ)
        self.conv4 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[1],
                                            dilations[1], activ=activ)
        self.conv5 = SeperableConv2DBNActiv(nin, nin, 3, 1, dilations[2],
                                            dilations[2], activ=activ)
        self.bottleneck = nn.Sequential(
            Conv2DBNActiv(nin * 5, nout, 1, 1, 0, activ=activ),
            nn.Dropout2d(0.1))

    def forward(self, x):
        _, _, h, w = x.shape
        feat1 = F.interpolate(self.conv1(x), size=(h, w), mode="bilinear",
                              align_corners=True)
        out = torch.cat((feat1, self.conv2(x), self.conv3(x), self.conv4(x),
                         self.conv5(x)), dim=1)
        return self.bottleneck(out)


class BaseASPPNet(nn.Module):
    def __init__(self, nin, ch, dilations=(4, 8, 16)):
        super().__init__()
        self.enc1 = Encoder(nin, ch, 3, 2, 1)
        self.enc2 = Encoder(ch, ch * 2, 3, 2, 1)
        self.enc3 = Encoder(ch * 2, ch * 4, 3, 2, 1)
        self.enc4 = Encoder(ch * 4, ch * 8, 3, 2, 1)
        self.aspp = ASPPModule(ch * 8, ch * 16, dilations)
        self.dec4 = Decoder(ch * (8 + 16), ch * 8, 3, 1, 1)
        self.dec3 = Decoder(ch * (4 + 8), ch * 4, 3, 1, 1)
        self.dec2 = Decoder(ch * (2 + 4), ch * 2, 3, 1, 1)
        self.dec1 = Decoder(ch * (1 + 2), ch, 3, 1, 1)

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


class CascadedASPPNet(nn.Module):
    def __init__(self, n_fft: int, offset: int = 128):
        super().__init__()
        self.stg1_low_band_net = BaseASPPNet(2, 32)
        self.stg1_high_band_net = BaseASPPNet(2, 32)
        self.stg2_bridge = Conv2DBNActiv(34, 16, 1, 1, 0)
        self.stg2_full_band_net = BaseASPPNet(16, 32)
        self.stg3_bridge = Conv2DBNActiv(66, 32, 1, 1, 0)
        self.stg3_full_band_net = BaseASPPNet(32, 64)
        self.out = nn.Conv2d(64, 2, 1, bias=False)
        self.aux1_out = nn.Conv2d(32, 2, 1, bias=False)
        self.aux2_out = nn.Conv2d(32, 2, 1, bias=False)
        self.max_bin = n_fft // 2
        self.output_bin = n_fft // 2 + 1
        self.offset = offset

    def forward(self, x, aggressiveness=None):
        """The eval branch: the mask, raised below and above the split bin
        by 1 + value / 3 and 1 + value, times the input."""
        mix = x.detach()
        x = x.clone()[:, :, :self.max_bin]
        bandw = x.shape[2] // 2
        aux1 = torch.cat([self.stg1_low_band_net(x[:, :, :bandw]),
                          self.stg1_high_band_net(x[:, :, bandw:])], dim=2)
        h = torch.cat([x, aux1], dim=1)
        aux2 = self.stg2_full_band_net(self.stg2_bridge(h))
        h = torch.cat([x, aux1, aux2], dim=1)
        h = self.stg3_full_band_net(self.stg3_bridge(h))
        mask = torch.sigmoid(self.out(h))
        mask = F.pad(mask, (0, 0, 0, self.output_bin - mask.shape[2]),
                     mode="replicate")
        if aggressiveness:
            split = aggressiveness["split_bin"]
            mask[:, :, :split] = torch.pow(
                mask[:, :, :split], 1 + aggressiveness["value"] / 3)
            mask[:, :, split:] = torch.pow(
                mask[:, :, split:], 1 + aggressiveness["value"])
        return mask * mix

    def predict(self, x_mag, aggressiveness=None):
        h = self.forward(x_mag, aggressiveness)
        if self.offset > 0:
            h = h[:, :, :, self.offset:-self.offset]
            assert h.shape[3] > 0
        return h
