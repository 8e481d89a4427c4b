"""f0 estimator dispatcher (port of tpu_rvc/f0/gen.py; reference
rvc/f0/gen.py:44 `Generator`).

Builds the requested estimator on first use, on the dispatcher's device,
and keeps it: pm, dio, harvest, crepe, rmvpe and fcpe.  rmvpe reads
`rmvpe_root`/rmvpe.pt and fcpe the first of `f0/fcpe.py` DEFAULT_PATHS,
and each raises FileNotFoundError without its file; crepe has no default
file and raises ValueError unless its estimator is given in
`_estimators`.  Post-processing (transpose, manual-curve splice, coarse
quantisation) is `base.post_process`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from tpu_rvc_torch.core.device import resolve_device
from .base import F0_MAX, F0_MIN, post_process


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
        args = (self.window, F0_MIN, F0_MAX, self.sr)
        if method == "pm":
            from .pm import PM
            est = PM(*args, self.device)
        elif method == "dio":
            from .dio import Dio
            est = Dio(*args)
        elif method == "harvest":
            from .harvest import Harvest
            est = Harvest(*args)
        elif method == "crepe":
            from .crepe import CRePE
            est = CRePE(*args, device=self.device)
        elif method == "rmvpe":
            from .rmvpe import RMVPE
            est = RMVPE(str(self.rmvpe_root / "rmvpe.pt"),
                        hop_length=self.window, sampling_rate=self.sr,
                        device=self.device)
        elif method == "fcpe":
            from .fcpe import FCPE
            est = FCPE(*args, device=self.device)
        else:
            raise ValueError(f"f0 method {method} not supported")
        self._estimators[method] = est
        return est

    def calculate(self, x: np.ndarray, p_len: Optional[int],
                  f0_up_key: float, f0_method: str,
                  filter_radius: Optional[Union[int, float]] = None,
                  manual_f0: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """x at `sr` -> (coarse pitch int32, f0 Hz float32), numpy.  harvest
        median-filters with `filter_radius` when it is above 2; rmvpe
        decodes at the threshold 0.03; the others take their defaults.
        `manual_f0` ((n, 2) of seconds, Hz) is spliced in from x_pad
        seconds on."""
        est = self._get(f0_method)
        if f0_method == "harvest":
            f0 = est.compute_f0(x, p_len=p_len, filter_radius=filter_radius)
        elif f0_method == "rmvpe":
            f0 = est.compute_f0(x, p_len=p_len, filter_radius=0.03)
        else:
            f0 = est.compute_f0(x, p_len=p_len)
        return post_process(f0, f0_up_key, F0_MIN, F0_MAX, manual_f0,
                            self.x_pad, self.sr // self.window)
