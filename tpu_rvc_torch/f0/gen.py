"""f0 estimator dispatcher (port of tpu_rvc/f0/gen.py; reference
rvc/f0/gen.py:44 `Generator`).

Builds the requested estimator on first use, on the dispatcher's device,
and keeps it.  `pm` and `rmvpe` are ported; `dio`, `harvest`, `crepe` and
`fcpe` raise NotImplementedError.  Post-processing is `base.post_process`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from tpu_rvc_torch.core.device import resolve_device
from .base import F0_MAX, F0_MIN, post_process

PORTED = ("pm", "rmvpe")
_NOT_PORTED = ("dio", "harvest", "crepe", "fcpe")
F0_TODO = ("f0_method={!r} is not ported to tpu_rvc_torch yet: 'pm' and "
           "'rmvpe' are (ROADMAP.md queue A, 'Remaining f0 estimators': "
           "FCPE, CREPE, DIO and Harvest)")


class Generator:
    def __init__(self, rmvpe_root: Union[str, Path] = "assets/rmvpe",
                 x_pad: float = 3.0, window: int = 160, sr: int = 16000,
                 device=None):
        self.device = resolve_device(device)
        self.rmvpe_root = Path(rmvpe_root)
        self.x_pad = x_pad
        self.window = window
        self.sr = sr
        self._estimators = {}

    def _get(self, method: str):
        if method in self._estimators:
            return self._estimators[method]
        if method == "pm":
            from .pm import PM
            est = PM(self.window, F0_MIN, F0_MAX, self.sr, self.device)
        elif method == "rmvpe":
            from .rmvpe import RMVPE
            est = RMVPE(str(self.rmvpe_root / "rmvpe.pt"),
                        hop_length=self.window, sampling_rate=self.sr,
                        device=self.device)
        elif method in _NOT_PORTED:
            raise NotImplementedError(F0_TODO.format(method))
        else:
            raise ValueError(f"f0 method {method} not supported")
        self._estimators[method] = est
        return est

    def calculate(self, x: np.ndarray, p_len: Optional[int],
                  f0_up_key: float, f0_method: str,
                  filter_radius: Optional[Union[int, float]] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """x at `sr` -> (coarse pitch int32, f0 Hz float32), numpy."""
        est = self._get(f0_method)
        if f0_method == "rmvpe":
            f0 = est.compute_f0(x, p_len=p_len, filter_radius=0.03)
        else:
            f0 = est.compute_f0(x, p_len=p_len)
        return post_process(f0, f0_up_key, F0_MIN, F0_MAX)
