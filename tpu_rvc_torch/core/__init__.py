from .config import (DataConfig, HParams, ModelConfig, TrainConfig,
                     hparams_for)
from .device import fp32_math, resolve_device

__all__ = ["DataConfig", "HParams", "ModelConfig", "TrainConfig",
           "fp32_math", "hparams_for", "resolve_device"]
