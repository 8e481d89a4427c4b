"""Load rmvpe.pt (reference rvc/f0/models.py:4 `get_rmvpe`) into the
port's E2E, folding BatchNorm running statistics into (scale, bias) pairs
(port of tpu_rvc/ckpt/rmvpe_loader.py:13-20, 50-93)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


BN_EPS = 1e-5
_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def rmvpe_state_from_reference(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference `rmvpe.pt` state_dict -> the port's E2E state_dict: every
    BatchNorm (the modules that carry a `running_var`) becomes
    scale = weight / sqrt(var + eps), bias = bias - mean * scale, computed
    in float64; every other key goes through as float32.  The Dropout and
    Sigmoid of the reference's `fc` hold no weights."""
    def arr(k):
        v = sd[k]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return np.asarray(v, np.float64)

    bn = {k[: -len(".running_var")] for k in sd if k.endswith(".running_var")}
    out: Dict[str, torch.Tensor] = {}
    for prefix in bn:
        g, b, mean, var = (arr(f"{prefix}.{k}") for k in _BN_KEYS)
        scale = g / np.sqrt(var + BN_EPS)
        out[f"{prefix}.scale"] = torch.from_numpy(scale.astype(np.float32))
        out[f"{prefix}.bias"] = torch.from_numpy(
            (b - mean * scale).astype(np.float32))
    for k in sd:
        if k.rsplit(".", 1)[0] in bn:
            continue  # folded above, or num_batches_tracked
        out[k] = torch.from_numpy(arr(k).astype(np.float32))
    return out
