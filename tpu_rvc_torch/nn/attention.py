"""VITS relative-position attention encoder, channel-last (B, T, C)
(port of tpu_rvc/nn/attention.py:95-297).

Inference (the default) sends T > W + 1 through `banded_rel_attention`
(ops/kernels/rel_attention.py): the CUDA kernel on the card, its plain
banded twin on the CPU.  The training forward (`train=True`, which
`Synthesizer.forward` passes down) takes the JAX module's XLA branch
instead (`:178-233`): dense scores with the band added in (by pads and
reshapes, not the JAX branch's scatter), whole padded rows and columns
masked, differentiable; the kernel has no
backward, in the JAX package as here.  A graph that `torch.export`
traces holds the kernel's plain twin, on any device: the ctypes launch is
opaque to it.  Short sequences (T <= W + 1) take
the Shaw index-shuffle branch in both modes (`:212-216`).  Parameter
names follow the reference torch modules (`attn_layers.0.conv_q.weight`,
`emb_rel_k`, ...).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tpu_rvc_torch.ops.kernels.rel_attention import (
    banded_rel_attention, banded_rel_attention_plain)
from .modules import Conv1d, LayerNorm1d


def relative_to_absolute(x):
    """(B, H, L, 2L-1) relative logits -> (B, H, L, L) absolute."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(b, h, l * 2 * l)
    x = F.pad(x, (0, l - 1)).reshape(b, h, l + 1, 2 * l - 1)
    return x[:, :, :l, l - 1:]


def absolute_to_relative(x):
    """(B, H, L, L) attention weights -> (B, H, L, 2L-1) relative layout."""
    b, h, l, _ = x.shape
    x = F.pad(x, (0, l - 1)).reshape(b, h, l * l + l * (l - 1))
    x = F.pad(x, (l, 0)).reshape(b, h, l, 2 * l)
    return x[:, :, :, 1:]


def window_relative_embeddings(emb, length: int, window: int):
    """Slice/pad the (1, 2W+1, dk) table to (1, 2L-1, dk)."""
    pad_len = max(length - (window + 1), 0)
    start = max((window + 1) - length, 0)
    if pad_len > 0:
        emb = F.pad(emb, (0, 0, pad_len, pad_len))
    return emb[:, start:start + 2 * length - 1]


def _pointwise(conv: Conv1d, x):
    """A k=1 Conv1d applied to channel-last x."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class MultiHeadRelAttention(nn.Module):
    """Self-attention with windowed relative positions (reference
    attentions.py:9).  x: (B, T, C); lengths: (B,) true lengths."""

    def __init__(self, channels: int, out_channels: int, n_heads: int,
                 window_size: int = 10, p_dropout: float = 0.0):
        super().__init__()
        self.drop = nn.Dropout(p_dropout)
        self.channels, self.n_heads, self.window_size = (channels, n_heads,
                                                         window_size)
        dk = channels // n_heads
        self.conv_q = Conv1d(channels, channels, 1)
        self.conv_k = Conv1d(channels, channels, 1)
        self.conv_v = Conv1d(channels, channels, 1)
        self.conv_o = Conv1d(channels, out_channels, 1)
        for conv in (self.conv_q, self.conv_k, self.conv_v, self.conv_o):
            nn.init.xavier_uniform_(conv.weight)
        shape = (1, 2 * window_size + 1, dk)
        self.emb_rel_k = nn.Parameter(torch.randn(shape) * dk ** -0.5)
        self.emb_rel_v = nn.Parameter(torch.randn(shape) * dk ** -0.5)

    def forward(self, x, lengths: Optional[torch.Tensor] = None,
                train: bool = False):
        B, T, C = x.shape
        h, W = self.n_heads, self.window_size
        dk = C // h

        def split(t):
            return t.reshape(B, T, h, dk).transpose(1, 2)

        qh = split(_pointwise(self.conv_q, x))
        kh = split(_pointwise(self.conv_k, x))
        vh = split(_pointwise(self.conv_v, x))
        if lengths is None:
            lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
        if T <= W + 1:
            out = self._shaw(qh, kh, vh, lengths, train)
        elif train:
            out = self._banded(qh, kh, vh, lengths)
        else:
            # a traced graph holds the kernel's plain twin on any device:
            # the ctypes launch is opaque to torch.export
            attend = (banded_rel_attention_plain
                      if torch.compiler.is_exporting()
                      else banded_rel_attention)
            bh_len = lengths.to(torch.int32).repeat_interleave(h).contiguous()
            out = attend(
                qh.reshape(B * h, T, dk).contiguous(),
                kh.reshape(B * h, T, dk).contiguous(),
                vh.reshape(B * h, T, dk).contiguous(),
                self.emb_rel_k[0].contiguous(), self.emb_rel_v[0].contiguous(),
                bh_len, window=W).reshape(B, h, T, dk)
        out = out.transpose(1, 2).reshape(B, T, C)
        return _pointwise(self.conv_o, out)

    def _softmax(self, scores, lengths, train):
        """Rows and columns beyond the length set to -1e4, softmax,
        dropout in training."""
        T = scores.shape[-1]
        m = (torch.arange(T, device=scores.device)[None, :]
             < lengths.to(scores.device)[:, None]).to(scores.dtype)
        mask = m[:, None, :, None] * m[:, None, None, :]
        p = torch.softmax(scores.masked_fill(mask == 0, -1e4), dim=-1)
        return self.drop(p) if train else p

    def _shaw(self, qh, kh, vh, lengths, train=False):
        """Short-sequence branch: full relative tables and index shuffles."""
        T, W = qh.shape[2], self.window_size
        qs = qh * (1.0 / math.sqrt(qh.shape[-1]))
        scores = qs @ kh.transpose(-1, -2)
        kr = window_relative_embeddings(self.emb_rel_k, T, W)
        scores = scores + relative_to_absolute(qs @ kr[0].t())
        p = self._softmax(scores, lengths, train)
        vr = window_relative_embeddings(self.emb_rel_v, T, W)
        return p @ vh + absolute_to_relative(p) @ vr[0]

    def _banded(self, qh, kh, vh, lengths):
        """The training branch for T > W + 1 (tpu_rvc/nn/attention.py:
        197-233): the relative tables are zero outside |i - j| <= W, so the
        Shaw shuffles reduce to adding the band (B, H, T, 2W+1) onto the
        dense scores and reading it back out of the probabilities.  The
        JAX branch scatters and gathers at clamped columns; here the band
        is skewed in and out by pads and reshapes (`band_to_dense`,
        `dense_to_band`), which give the same values bit for bit and a
        backward without atomic adds, so the card's step is reproducible."""
        B, H, T, dk = qh.shape
        W = self.window_size
        qs = qh * (1.0 / math.sqrt(dk))
        scores = qs @ kh.transpose(-1, -2)                   # (B, H, T, T)
        band = qs @ self.emb_rel_k[0].t()                    # (B, H, T, 2W+1)
        scores = scores + band_to_dense(band.to(scores.dtype), W)
        p = self._softmax(scores, lengths, True)
        rel_w = dense_to_band(p, W)
        return p @ vh + rel_w @ self.emb_rel_v[0].to(p.dtype)


def band_to_dense(band, W: int):
    """(..., T, 2W+1) -> (..., T, T) with out[i, j] = band[i, j - i + W]
    where |i - j| <= W and zero elsewhere (band entries whose column
    i + w - W falls outside [0, T) are dropped).  Each row padded by T
    zeros and the whole re-cut into rows one shorter shifts row i right
    by i."""
    *lead, T, n = band.shape
    flat = F.pad(band, (0, T)).reshape(*lead, T * (n + T))
    skew = flat[..., :T * (n + T - 1)].reshape(*lead, T, n + T - 1)
    return skew[..., W:W + T]


def dense_to_band(p, W: int):
    """The inverse read of `band_to_dense`: (..., T, T) -> (..., T, 2W+1)
    with out[i, w] = p[i, i + w - W] where that column lies in [0, T),
    zero elsewhere."""
    *lead, T, _ = p.shape
    n = 2 * W + 1
    flat = F.pad(p, (W, W)).reshape(*lead, T * (T + n - 1))
    rows = F.pad(flat, (0, T)).reshape(*lead, T, T + n)
    return rows[..., :n]


class FFN(nn.Module):
    """Conv feed-forward (reference attentions.py:228), relu, same padding;
    channel-last in and out."""

    def __init__(self, in_channels: int, out_channels: int,
                 filter_channels: int, kernel_size: int,
                 p_dropout: float = 0.0):
        super().__init__()
        self.kernel_size = kernel_size
        self.drop = nn.Dropout(p_dropout)
        self.conv_1 = Conv1d(in_channels, filter_channels, kernel_size)
        self.conv_2 = Conv1d(filter_channels, out_channels, kernel_size)

    def _pad(self, x):
        k = self.kernel_size
        return F.pad(x, ((k - 1) // 2, k // 2)) if k > 1 else x

    def forward(self, x, x_mask, train: bool = False):
        # x: (B, T, C); x_mask: (B, T, 1)
        m = x_mask.transpose(1, 2)
        y = torch.relu(self.conv_1(self._pad(x.transpose(1, 2) * m)))
        if train:
            y = self.drop(y)
        y = self.conv_2(self._pad(y * m))
        return (y * m).transpose(1, 2)


class Encoder(nn.Module):
    """n_layers x (rel-attention + FFN), post-norm (reference encoders.py:12)."""

    def __init__(self, hidden_channels: int, filter_channels: int,
                 n_heads: int, n_layers: int, kernel_size: int = 1,
                 window_size: int = 10, p_dropout: float = 0.0):
        super().__init__()
        self.n_layers = n_layers
        self.attn_layers = nn.ModuleList(
            MultiHeadRelAttention(hidden_channels, hidden_channels, n_heads,
                                  window_size, p_dropout)
            for _ in range(n_layers))
        self.norm_layers_1 = nn.ModuleList(
            LayerNorm1d(hidden_channels) for _ in range(n_layers))
        self.ffn_layers = nn.ModuleList(
            FFN(hidden_channels, hidden_channels, filter_channels,
                kernel_size, p_dropout) for _ in range(n_layers))
        self.norm_layers_2 = nn.ModuleList(
            LayerNorm1d(hidden_channels) for _ in range(n_layers))

    def forward(self, x, x_mask, train: bool = False):
        # x: (B, T, H); x_mask: (B, T, 1)
        lengths = x_mask[:, :, 0].sum(dim=1).to(torch.int32)
        x = x * x_mask
        for i in range(self.n_layers):
            y = self.attn_layers[i](x, lengths, train)
            x = self.norm_layers_1[i](x + y)
            y = self.ffn_layers[i](x, x_mask, train)
            x = self.norm_layers_2[i](x + y)
        return x * x_mask
