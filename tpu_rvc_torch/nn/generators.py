"""HiFiGAN / NSF-HiFiGAN decoders (port of tpu_rvc/nn/generators.py).

Channel-first (B, C, T).  Each upsample level's resblock stage goes through
`_resblock_stage`.  In inference ResBlock1 stages run in the stage kernel
(ops/kernels/resblock.py, `fused_stage`, or `fused_resblock` for one
resblock; the batch goes in whole, as the kernel's stream axis), ResBlock2
stages in plain PyTorch.  The stage weights are relaid for the kernel once
per stage and device and kept while the parameters stay as they were: the
cache is keyed on each parameter's storage and version counter, which
every in-place write (an optimizer step, `load_state_dict`) moves on.  The
training forward (`train=True`) runs `mean_j ResBlock1_j.forward(x)`, as
the JAX decoder does outside its kernel context
(tpu_rvc/nn/generators.py:78-83): the kernel has no backward.  So does a
graph that `torch.export` traces (`ckpt/export.py`, `ckpt/torch2onnx.py`),
as the JAX exporters trace the XLA path, never the Pallas kernel.

Two leaky-ReLU slopes: 0.1 between layers, the default 0.01 before
conv_post (reference generators.py / nsf.py).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from tpu_rvc_torch.core.device import draw_normal, draw_uniform
from tpu_rvc_torch.ops.kernels.resblock import (fused_resblock, fused_stage,
                                                 stage_weights)
from tpu_rvc_torch.ops.resample import linear_interp_1d, nearest_upsample
from .modules import (LRELU_SLOPE, Conv1d, ConvTranspose1d, Linear,
                      ResBlock1, ResBlock2, WNConvTranspose1d, normal_001_)


class _Decoder(nn.Module):
    """What both decoders share: conv_pre/cond, the upsamplers, the flat
    `resblocks` list (level i, kernel j at i * n_k + j) and conv_post."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]],
                 upsample_rates: Sequence[int], upsample_initial_channel: int,
                 upsample_kernel_sizes: Sequence[int], gin_channels: int = 0,
                 weight_norm: bool = False):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.upsample_rates = tuple(upsample_rates)
        self.gin_channels = gin_channels
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7,
                               padding=3)
        if gin_channels != 0:
            self.cond = Conv1d(gin_channels, upsample_initial_channel, 1)
        rb = ResBlock1 if resblock == "1" else ResBlock2
        up = WNConvTranspose1d if weight_norm else ConvTranspose1d
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(normal_001_(up(2 * ch, ch, k, u,
                                           padding=(k - u) // 2)))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(rb(ch, rk, rd, weight_norm=weight_norm))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False)
        self._stage_cache = {}

    def _pre(self, x, g):
        x = self.conv_pre(x)
        if g is not None and self.gin_channels != 0:
            x = x + self.cond(g)
        return x

    def _post(self, x):
        x = F.leaky_relu(x)  # default slope 0.01, as the reference
        return torch.tanh(self.conv_post(x))

    def _resblock_stage(self, x, i: int, train: bool = False):
        """mean_j ResBlock_j(x) of upsample level i."""
        blocks = self.resblocks[i * self.num_kernels:
                                (i + 1) * self.num_kernels]
        if train or torch.compiler.is_exporting() or \
                not isinstance(blocks[0], ResBlock1):
            # a traced graph (torch.export) takes the modules: the kernel
            # launch is opaque to it and the cache keys need real storage
            return sum(rb(x) for rb in blocks) / self.num_kernels
        version = stage_key(blocks)
        cached = self._stage_cache.get((i, x.device))
        if cached is None or cached[0] != version:
            cached = (version, stage_weights(blocks))
            self._stage_cache[(i, x.device)] = cached
        sw = cached[1]
        stage = fused_resblock if len(blocks) == 1 else fused_stage
        return stage(x.contiguous(), sw)  # the batch whole, no loop over it


def stage_key(blocks) -> tuple:
    """Each parameter's storage and in-place version counter: a load or an
    optimizer step changes it, so the relaid stage weights follow."""
    return tuple((p.data_ptr(), p._version) for p in blocks.parameters())


class Generator(_Decoder):
    """HiFiGAN generator without f0 (reference generators.py:14)."""

    def forward(self, x, g=None, n_res: Optional[int] = None,
                train: bool = False):
        if n_res is not None and int(n_res) != x.shape[-1]:
            x = linear_interp_1d(x, int(n_res))
        x = self._pre(x, g)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = self._resblock_stage(x, i, train)
        return self._post(x)


def f0_to_sine_phases(f0, upp: int, sampling_rate: int, n_harmonics: int,
                      rand_ini: Optional[torch.Tensor] = None):
    """Frame-rate f0 (B, L) Hz -> harmonic phases (B, L*upp, n) in cycles
    (reference SineGenerator._f02sine, generators.py:148).  Frame starts
    accumulate the wrapped phase advance; the wrap is floor-mod
    (`torch.remainder`, as `jnp.mod`) and the cumsum is fp32."""
    B, L = f0.shape
    inc = f0[:, :, None] / sampling_rate
    ramp = torch.arange(1, upp + 1, dtype=f0.dtype, device=f0.device)
    rad = inc * ramp[None, None, :]                   # (B, L, upp)
    frame_adv = rad[:, :-1, -1].float()
    wrapped = torch.remainder(frame_adv + 0.5, 1.0) - 0.5
    acc = torch.remainder(torch.cumsum(wrapped, dim=1), 1.0).to(f0.dtype)
    acc = F.pad(acc, (1, 0))                          # frame 0 at phase 0
    rad = (rad + acc[:, :, None]).reshape(B, L * upp, 1)
    harm = torch.arange(1, n_harmonics + 1, dtype=f0.dtype, device=f0.device)
    rad = rad * harm[None, None, :]
    if rand_ini is not None and n_harmonics > 1:
        rand_ini = rand_ini.clone()
        rand_ini[..., 0] = 0.0
        rad = rad + rand_ini
    return rad


class SineGenerator(nn.Module):
    """Sine + UV-gated noise source (reference generators.py:116)."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.dim = harmonic_num + 1
        self.sine_amp, self.noise_std = sine_amp, noise_std
        self.voiced_threshold = voiced_threshold

    def forward(self, f0, upp: int, generator: Optional[torch.Generator] = None,
                deterministic: bool = False):
        rand_ini = None
        if not deterministic and self.dim > 1:
            # one phase for the batch: a RowGenerators' shared generator
            rand_ini = draw_uniform((1, 1, self.dim),
                                    getattr(generator, "shared", generator),
                                    f0)
        phases = f0_to_sine_phases(f0, upp, self.sampling_rate, self.dim,
                                   rand_ini)
        sines = torch.sin(2 * math.pi * phases) * self.sine_amp
        uv = (f0 > self.voiced_threshold).to(f0.dtype)[:, None, :]
        uv = nearest_upsample(uv, upp).transpose(1, 2)  # (B, L*upp, 1)
        noise_amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
        if deterministic:
            noise = torch.zeros_like(sines)
        else:
            noise = noise_amp * draw_normal(sines.shape, generator, f0)
        return sines * uv + noise, uv, noise


class SourceModuleHnNSF(nn.Module):
    """Harmonics merged to one excitation by Linear + tanh (reference
    nsf.py:16).  Returns (B, L*upp, 1), channel-last like the JAX module."""

    def __init__(self, sampling_rate: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, add_noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.l_sin_gen = SineGenerator(sampling_rate, harmonic_num, sine_amp,
                                       add_noise_std, voiced_threshold)
        self.l_linear = Linear(harmonic_num + 1, 1)

    def forward(self, f0, upp: int = 1, generator=None,
                deterministic: bool = False):
        sine_wavs, _, _ = self.l_sin_gen(f0, upp, generator, deterministic)
        return torch.tanh(self.l_linear(sine_wavs))


class NSFGenerator(_Decoder):
    """NSF-HiFiGAN: the harmonic source is injected at every upsample
    level through a strided `noise_convs` conv (reference nsf.py:64)."""

    def __init__(self, initial_channel: int, resblock: str,
                 resblock_kernel_sizes, resblock_dilation_sizes,
                 upsample_rates, upsample_initial_channel: int,
                 upsample_kernel_sizes, gin_channels: int, sr: int,
                 weight_norm: bool = False):
        super().__init__(initial_channel, resblock, resblock_kernel_sizes,
                         resblock_dilation_sizes, upsample_rates,
                         upsample_initial_channel, upsample_kernel_sizes,
                         gin_channels, weight_norm)
        self.upp = math.prod(upsample_rates)
        self.m_source = SourceModuleHnNSF(sr, harmonic_num=0)
        self.noise_convs = nn.ModuleList()
        for i in range(len(upsample_rates)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            if i + 1 < len(upsample_rates):
                s = math.prod(upsample_rates[i + 1:])
                self.noise_convs.append(Conv1d(1, ch, 2 * s, stride=s,
                                               padding=s // 2))
            else:
                self.noise_convs.append(Conv1d(1, ch, 1))

    def forward(self, x, f0, g=None, n_res: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = False, train: bool = False):
        # x: (B, C, T) latent; f0: (B, T_frames) Hz; g: (B, gin, 1)
        upp = self.upp
        har = self.m_source(f0, upp, generator, deterministic)  # (B, T*upp, 1)
        har = har.transpose(1, 2)                                # (B, 1, T*upp)
        if n_res is not None:
            n = int(n_res)
            if n * upp != har.shape[-1]:
                har = linear_interp_1d(har, n * upp)
            if n != x.shape[-1]:
                x = linear_interp_1d(x, n)
        x = self._pre(x, g)
        for i, (up, nc) in enumerate(zip(self.ups, self.noise_convs)):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            x = x + nc(har)
            x = self._resblock_stage(x, i, train)
        return self._post(x)
