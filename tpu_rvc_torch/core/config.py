"""Hyperparameter presets (port of tpu_rvc/core/config.py:22-146).

The same frozen dataclasses and values as the JAX package, kept as this
package's own copy so nothing here imports `tpu_rvc`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class TrainConfig:
    log_interval: int = 200
    seed: int = 1234
    epochs: int = 20000
    learning_rate: float = 1e-4
    betas: Tuple[float, float] = (0.8, 0.99)
    eps: float = 1e-9
    batch_size: int = 4
    fp16_run: bool = True
    lr_decay: float = 0.999875
    segment_size: int = 12800
    init_lr_ratio: float = 1.0
    warmup_epochs: int = 0
    c_mel: float = 45.0
    c_kl: float = 1.0


@dataclass(frozen=True)
class DataConfig:
    max_wav_value: float = 32768.0
    sampling_rate: int = 40000
    filter_length: int = 2048
    hop_length: int = 400
    win_length: int = 2048
    n_mel_channels: int = 125
    mel_fmin: float = 0.0
    mel_fmax: Optional[float] = None

    @property
    def spec_channels(self) -> int:
        return self.filter_length // 2 + 1


@dataclass(frozen=True)
class ModelConfig:
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.0
    resblock: str = "1"
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    upsample_rates: Tuple[int, ...] = (10, 10, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    use_spectral_norm: bool = False
    gin_channels: int = 256
    spk_embed_dim: int = 109


@dataclass(frozen=True)
class HParams:
    version: str = "v2"  # "v1" (256-d features) | "v2" (768-d features)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    @property
    def encoder_dim(self) -> int:
        return 256 if self.version == "v1" else 768

    @property
    def sr(self) -> int:
        return self.data.sampling_rate


def _mk(version, sr, hop, nfft, win, nmel, seg, ups, ukern) -> HParams:
    return HParams(
        version=version,
        train=TrainConfig(segment_size=seg),
        data=DataConfig(sampling_rate=sr, filter_length=nfft,
                        hop_length=hop, win_length=win, n_mel_channels=nmel),
        model=ModelConfig(upsample_rates=tuple(ups),
                          upsample_kernel_sizes=tuple(ukern)),
    )


# The reference's configs/v{1,2}/{32k,40k,48k}.json values.
_PRESETS = {
    ("v1", 32000): _mk("v1", 32000, 320, 1024, 1024, 80, 12800,
                       (10, 4, 2, 2, 2), (16, 16, 4, 4, 4)),
    ("v1", 40000): _mk("v1", 40000, 400, 2048, 2048, 125, 12800,
                       (10, 10, 2, 2), (16, 16, 4, 4)),
    ("v1", 48000): _mk("v1", 48000, 480, 2048, 2048, 128, 11520,
                       (10, 6, 2, 2, 2), (16, 16, 4, 4, 4)),
    ("v2", 32000): _mk("v2", 32000, 320, 1024, 1024, 80, 12800,
                       (10, 8, 2, 2), (20, 16, 4, 4)),
    ("v2", 48000): _mk("v2", 48000, 480, 2048, 2048, 128, 17280,
                       (12, 10, 2, 2), (24, 20, 4, 4)),
}


def hparams_for(version: str, sr: int) -> HParams:
    """Built-in hyperparameters for a (version, sample-rate) pair."""
    key = (version, int(sr))
    if key == ("v2", 40000):  # v2-40k has no preset upstream: v1 template
        return dataclasses.replace(_PRESETS[("v1", 40000)], version="v2")
    if key not in _PRESETS:
        raise KeyError(f"no hparams preset for version={version} sr={sr}")
    return _PRESETS[key]
