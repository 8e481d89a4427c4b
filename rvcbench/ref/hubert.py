"""HuBERT-base content encoder (port of tpu_rvc/models/hubert.py;
reference rvc/hubert.py:27-339 around fairseq's HubertModel).

  wave (B, T) 16 kHz
   -> 7 convs (512 ch, 320x down, GELU; per-channel GroupNorm after conv0)
   -> LayerNorm(512) -> Linear 512->768 (padded frames zeroed)
   -> + GELU(grouped positional conv, k=128, groups=16, one frame trimmed)
   -> LayerNorm -> post-norm transformer layers (12 heads, FFN 3072)
   -> tap at `output_layer` (v1: 9 + final_proj to 256; v2: 12)

Parameters carry fairseq's names; the positional conv's weight norm is
folded at load.  Attention is a plain matmul/softmax with -inf on padded
keys (this attention never had a TPU kernel).  Output (B, F, D).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .device import fp32_math

BASE_CONV_LAYERS: Tuple[Tuple[int, int, int], ...] = (
    (512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
    (512, 3, 2), (512, 2, 2), (512, 2, 2),
)


class ConvFeatureExtractor(nn.Module):
    def __init__(self, conv_layers: Sequence[Tuple[int, int, int]]):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        cin = 1
        for i, (ch, k, s) in enumerate(conv_layers):
            layers = [nn.Conv1d(cin, ch, k, stride=s, bias=False),
                      nn.Dropout(0.0)]
            if i == 0:
                layers.append(nn.GroupNorm(ch, ch, affine=True))
            layers.append(nn.GELU())
            self.conv_layers.append(nn.Sequential(*layers))
            cin = ch

    def forward(self, wav):
        x = wav[:, None, :]
        for layer in self.conv_layers:
            x = layer(x)
        return x.transpose(1, 2)                            # (B, F, C)


class SelfAttention(nn.Module):
    """fairseq MultiheadAttention: separate projections, q pre-scaled."""

    def __init__(self, embed: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.q_proj = nn.Linear(embed, embed)
        self.k_proj = nn.Linear(embed, embed)
        self.v_proj = nn.Linear(embed, embed)
        self.out_proj = nn.Linear(embed, embed)

    def forward(self, x, key_padding_mask=None):
        B, T, C = x.shape
        h = self.n_heads
        dk = C // h

        def split(t):
            return t.reshape(B, T, h, dk).transpose(1, 2)

        q = split(self.q_proj(x) * dk ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        scores = q @ k.transpose(-1, -2)
        if key_padding_mask is not None:
            scores = scores.masked_fill(key_padding_mask[:, None, None, :],
                                        float("-inf"))
        o = torch.softmax(scores, dim=-1) @ v
        return self.out_proj(o.transpose(1, 2).reshape(B, T, C))


class TransformerLayer(nn.Module):
    """Post-norm encoder layer (layer_norm_first=False for hubert-base)."""

    def __init__(self, embed: int, ffn_dim: int, n_heads: int):
        super().__init__()
        self.self_attn = SelfAttention(embed, n_heads)
        self.self_attn_layer_norm = nn.LayerNorm(embed)
        self.fc1 = nn.Linear(embed, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed)
        self.final_layer_norm = nn.LayerNorm(embed)

    def forward(self, x, key_padding_mask=None):
        x = self.self_attn_layer_norm(x + self.self_attn(x, key_padding_mask))
        y = self.fc2(F.gelu(self.fc1(x)))
        return self.final_layer_norm(x + y)


class _Encoder(nn.Module):
    def __init__(self, embed, ffn_dim, n_heads, n_layers, pos_conv_k,
                 pos_conv_groups):
        super().__init__()
        self.pos_conv = nn.Sequential(
            nn.Conv1d(embed, embed, pos_conv_k, padding=pos_conv_k // 2,
                      groups=pos_conv_groups))
        self.layer_norm = nn.LayerNorm(embed)
        self.layers = nn.ModuleList(
            TransformerLayer(embed, ffn_dim, n_heads) for _ in range(n_layers))


class Hubert(nn.Module):
    """HuBERT-base with the layer tap (1-based `output_layer`, reference
    rvc/hubert.py:327)."""

    def __init__(self, output_layer: int = 12, final_proj: bool = False,
                 embed: int = 768, ffn_dim: int = 3072, n_heads: int = 12,
                 final_dim: int = 256, pos_conv_k: int = 128,
                 pos_conv_groups: int = 16,
                 conv_layers: Sequence[Tuple[int, int, int]] = BASE_CONV_LAYERS):
        super().__init__()
        self.output_layer = output_layer
        self.pos_conv_k = pos_conv_k
        self.feature_extractor = ConvFeatureExtractor(conv_layers)
        c = conv_layers[-1][0]
        self.layer_norm = nn.LayerNorm(c)
        self.post_extract_proj = nn.Linear(c, embed)
        self.encoder = _Encoder(embed, ffn_dim, n_heads, output_layer,
                                pos_conv_k, pos_conv_groups)
        self.final_proj = nn.Linear(embed, final_dim) if final_proj else None

    @torch.no_grad()
    @fp32_math()
    def forward(self, wav, padding_mask: Optional[torch.Tensor] = None):
        # wav: (B, T) float32 16 kHz; padding_mask: (B, T) bool, True = pad
        x = self.post_extract_proj(self.layer_norm(
            self.feature_extractor(wav)))
        B, n = x.shape[:2]
        frame_pad = None
        if padding_mask is not None:
            # a frame is padded iff all its samples are (fairseq
            # forward_padding_mask)
            extra = padding_mask.shape[1] % n
            pm = padding_mask[:, :padding_mask.shape[1] - extra]
            frame_pad = pm.reshape(B, n, -1).all(dim=-1)
            x = x.masked_fill(frame_pad[:, :, None], 0.0)
        pos = self.encoder.pos_conv(x.transpose(1, 2))
        if self.pos_conv_k % 2 == 0:  # SamePad trims one for even kernels
            pos = pos[:, :, :-1]
        x = self.encoder.layer_norm(x + F.gelu(pos).transpose(1, 2))
        pad_len = n % 2  # required_seq_len_multiple = 2
        if pad_len:
            x = F.pad(x, (0, 0, 0, pad_len))
            fp = (torch.zeros((B, n), dtype=torch.bool, device=x.device)
                  if frame_pad is None else frame_pad)
            frame_pad = F.pad(fp, (0, pad_len), value=True)
        for layer in self.encoder.layers:
            x = layer(x, frame_pad)
        if pad_len:
            x = x[:, :-pad_len]
        if self.final_proj is not None:
            x = self.final_proj(x)
        return x
