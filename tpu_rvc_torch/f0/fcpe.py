"""FCPE estimator (port of tpu_rvc/f0/fcpe.py; reference rvc/f0/fcpe.py:9,
torchfcpe's bundled model).

wav -> log-mel -> CFNaiveMelPE -> local_argmax decode runs on the
estimator's device (`models/fcpe.py`); the resize and the gap
interpolation run in numpy, as in the JAX estimator.  The checkpoint is
`model_path`, else the first of DEFAULT_PATHS that exists.  Without one
the estimator raises FileNotFoundError, where the JAX one quietly runs pm
instead: the port never swaps one pitch estimator for another.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from tpu_rvc_torch.core.device import fp32_math, resolve_device
from .base import F0Predictor, interpolate_f0, resize_f0

DEFAULT_PATHS = ("assets/fcpe/fcpe.pt", "assets/fcpe/fcpe_c_v001.pt")


class FCPE(F0Predictor):
    def __init__(self, hop_length: int = 160, f0_min: float = 50.0,
                 f0_max: float = 1100.0, sampling_rate: int = 16000,
                 model_path: Optional[str] = None, model=None, device=None):
        super().__init__(hop_length, f0_min, f0_max, sampling_rate)
        self.device = resolve_device(device)
        if model is None:
            if model_path is None:
                model_path = next((p for p in DEFAULT_PATHS
                                   if os.path.exists(p)), None)
            if model_path is None:
                raise FileNotFoundError(
                    "FCPE needs the torchfcpe bundled checkpoint: none of "
                    f"{', '.join(DEFAULT_PATHS)} exists; pass model_path=")
            from tpu_rvc_torch.ckpt.fcpe_loader import load_fcpe
            model = load_fcpe(model_path, self.device)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    @fp32_math()
    def compute_f0(self, wav: np.ndarray, p_len: Optional[int] = None,
                   filter_radius: Optional[float] = 0.006) -> np.ndarray:
        """`filter_radius` is the decode's voicing threshold (0.006)."""
        from tpu_rvc_torch.models.fcpe import fcpe_infer

        wav = np.asarray(wav, np.float32)
        if p_len is None:
            p_len = wav.shape[0] // self.hop_length
        thred = 0.006 if filter_radius is None else float(filter_radius)
        f0 = fcpe_infer(self.model, torch.from_numpy(wav).to(self.device)[None],
                        thred)[0].cpu().numpy()
        return interpolate_f0(resize_f0(f0, p_len))[0]
