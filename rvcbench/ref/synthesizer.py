"""The VITS synthesizer (port of tpu_rvc/models/synthesizer.py; reference
rvc/layers/synthesizers.py).

`infer` keeps the JAX layouts: phone (B, T, encoder_dim), pitch (B, T)
int, pitchf (B, T) Hz, sid (B,) -> audio (B, T * hop, 1).  `forward` is
the training forward (`:91-123`): enc_p + enc_q -> flow forward -> a
random latent slice -> decoder, through the differentiable branches
(`train=True`).  Module names follow the reference (`enc_p`, `enc_q`,
`flow`, `dec`, `emb_g`).  Built with `train=True` (`make_synthesizer`)
it holds enc_q and keeps the reference's convs under weight norm
(`weight_g`/`weight_v`), the layout of a training checkpoint; built
without, it is the folded inference model a small model loads into.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from .device import draw_normal, draw_uniform, fp32_math
from .encoders import PosteriorEncoder, TextEncoder
from .flows import ResidualCouplingBlock
from .generators import Generator, NSFGenerator

FLOW_PREROLL = 24  # flow pre-roll frames ahead of a streamed tail


class Synthesizer(nn.Module):
    def __init__(self, spec_channels: int, segment_size: int,
                 inter_channels: int, hidden_channels: int,
                 filter_channels: int, n_heads: int, n_layers: int,
                 kernel_size: int, p_dropout: float, resblock: str,
                 resblock_kernel_sizes: Tuple[int, ...],
                 resblock_dilation_sizes: Tuple[Tuple[int, ...], ...],
                 upsample_rates: Tuple[int, ...],
                 upsample_initial_channel: int,
                 upsample_kernel_sizes: Tuple[int, ...], spk_embed_dim: int,
                 gin_channels: int, sr: int, encoder_dim: int,
                 use_f0: bool, train: bool = False):
        super().__init__()
        self.sr = sr
        self.use_f0 = use_f0
        self.spk_embed_dim = spk_embed_dim
        self.segment_size = segment_size
        self.upsample_rates = tuple(upsample_rates)
        self.enc_p = TextEncoder(encoder_dim, inter_channels, hidden_channels,
                                 filter_channels, n_heads, n_layers,
                                 kernel_size, f0=use_f0, p_dropout=p_dropout)
        dec = dict(initial_channel=inter_channels, resblock=resblock,
                   resblock_kernel_sizes=resblock_kernel_sizes,
                   resblock_dilation_sizes=resblock_dilation_sizes,
                   upsample_rates=upsample_rates,
                   upsample_initial_channel=upsample_initial_channel,
                   upsample_kernel_sizes=upsample_kernel_sizes,
                   gin_channels=gin_channels, weight_norm=train)
        self.dec = NSFGenerator(sr=sr, **dec) if use_f0 else Generator(**dec)
        if train:
            self.enc_q = PosteriorEncoder(spec_channels, inter_channels,
                                          hidden_channels, 5, 1, 16,
                                          gin_channels=gin_channels)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5,
                                          1, 3, gin_channels=gin_channels,
                                          weight_norm=train)
        self.emb_g = nn.Embedding(spk_embed_dim, gin_channels)

    @property
    def hop(self) -> int:
        return math.prod(self.upsample_rates)

    def forward(self, phone, phone_lengths, y, y_lengths, ds, pitch=None,
                pitchf=None, ids_slice: Optional[torch.Tensor] = None,
                noise_eps: Optional[torch.Tensor] = None,
                deterministic: bool = False,
                generator: Optional[torch.Generator] = None):
        """The training forward (reference synthesizers.py:132), channel-
        last in and out: y is the linear spectrogram (B, T, F).  Returns
        (audio slice (B, segment, 1), ids_slice (B,), x_mask, y_mask,
        (z, z_p, m_p, logs_p, m_q, logs_q)), masks (B, T, 1), latents
        (B, T, C).  `ids_slice` and `noise_eps` (B, T, C) pin the latent
        slice and the posterior draw, `deterministic` zeroes the sine
        source's noise; every other draw comes from `generator`, or from
        a `core/device.py` `RowGenerators`, one generator a row (the
        slice, the posterior eps, the sine noise) and one the batch shares
        (the sine source's initial phase)."""
        g = self.emb_g(ds.long())[:, :, None]                 # (B, gin, 1)
        m_p, logs_p, x_mask = self.enc_p(phone, pitch, phone_lengths,
                                         train=True)
        z, m_q, logs_q, y_mask = self.enc_q(y, y_lengths, g=g, eps=noise_eps,
                                            generator=generator)
        mask_cf = y_mask.transpose(1, 2)
        z_p = self.flow(z.transpose(1, 2), mask_cf, g=g,
                        reverse=False).transpose(1, 2)
        seg = self.segment_size // self.hop
        if ids_slice is None:
            max_start = torch.clamp(y_lengths - seg - 1, min=1).float()
            u = draw_uniform((z.shape[0],), generator, max_start)
            ids_slice = (u * max_start).to(torch.int32)
        idx = ids_slice.long()[:, None] + torch.arange(seg, device=z.device)
        z_slice = torch.gather(
            z, 1, idx[:, :, None].expand(-1, -1, z.shape[-1]))
        if self.use_f0 and pitchf is not None:
            o = self.dec(z_slice.transpose(1, 2), torch.gather(pitchf, 1, idx),
                         g=g, generator=generator,
                         deterministic=deterministic, train=True)
        else:
            o = self.dec(z_slice.transpose(1, 2), g=g, train=True)
        return (o.transpose(1, 2), ids_slice, x_mask, y_mask,
                (z, z_p, m_p, logs_p, m_q, logs_q))

    @torch.no_grad()
    @fp32_math()
    def infer(self, phone, phone_lengths, sid, pitch=None, pitchf=None,
              skip_head: Optional[int] = None,
              return_length: Optional[int] = None,
              return_length2: Optional[int] = None,
              noise_scale: float = 0.66666, deterministic: bool = False,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Inference (reference synthesizers.py:160).  deterministic=True
        zeroes every random term (prior noise, sine noise); `noise`
        supplies the prior eps (B, T, C) from outside; `generator` draws
        them otherwise, or a list of B generators, one a row
        (`core/device.py` `draw_normal`)."""
        g = self.emb_g(sid.long())[:, :, None]               # (B, gin, 1)
        streamed = skip_head is not None and return_length is not None
        head = int(skip_head) if streamed else 0
        flow_head = max(head - FLOW_PREROLL, 0) if streamed else None
        if True:
            m_p, logs_p, x_mask = self.enc_p(phone, pitch, phone_lengths,
                                             skip_head=flow_head)
            if noise is not None:
                eps = noise
            elif deterministic:
                eps = torch.zeros_like(m_p)
            else:
                eps = draw_normal(m_p.shape, generator, m_p)
            z_p = (m_p + torch.exp(logs_p) * eps * noise_scale) * x_mask
        if True:
            mask_cf = x_mask.transpose(1, 2)                 # (B, 1, T)
            z = self.flow(z_p.transpose(1, 2), mask_cf, g=g)
        if streamed:
            dec_head, length = head - flow_head, int(return_length)
            z = z[:, :, dec_head:dec_head + length]
            mask_cf = mask_cf[:, :, dec_head:dec_head + length]
            if pitchf is not None:
                pitchf = pitchf[:, head:head + length]
        if True:
            if self.use_f0 and pitchf is not None:
                o = self.dec(z * mask_cf, pitchf, g=g, n_res=return_length2,
                             generator=generator,
                             deterministic=deterministic)
            else:
                o = self.dec(z * mask_cf, g=g, n_res=return_length2)
        return o.transpose(1, 2)                             # (B, T*hop, 1)
