"""Load rmvpe.pt (reference rvc/f0/models.py:4 `get_rmvpe`) into the
port's E2E, folding BatchNorm running statistics into (scale, bias) pairs
(port of tpu_rvc/ckpt/rmvpe_loader.py:13-20, 50-93)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tpu_rvc_torch.core.device import resolve_device

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


def load_rmvpe(path: str, device=None):
    """E2E() with the weights of `path` on `device` (default "cuda"), in
    eval mode.  A missing file raises FileNotFoundError."""
    from tpu_rvc_torch.models.rmvpe import E2E

    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = E2E()
    model.load_state_dict(rmvpe_state_from_reference(sd))
    return model.to(dev).eval()


def draw_batchnorm_statistics(sd: Dict[str, torch.Tensor]
                              ) -> Dict[str, torch.Tensor]:
    """A folded state_dict -> the reference layout: every FoldedBN
    (`scale`, `bias`) becomes a BatchNorm with drawn weight, bias, running
    mean and running variance rather than the identity, from torch's
    global generator; every other key is copied."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        prefix, _, leaf = k.rpartition(".")
        if leaf == "scale":
            n = v.shape[0]
            out[f"{prefix}.weight"] = torch.empty(n).uniform_(0.5, 1.5)
            out[f"{prefix}.bias"] = torch.randn(n) * 0.1
            out[f"{prefix}.running_mean"] = torch.randn(n) * 0.1
            out[f"{prefix}.running_var"] = torch.empty(n).uniform_(0.5, 1.5)
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(1)
        elif f"{prefix}.scale" not in sd:
            out[k] = v.clone()
    return out


def random_rmvpe_reference_state(seed: int, **e2e_kwargs
                                 ) -> Dict[str, torch.Tensor]:
    """A random-weight E2E(**e2e_kwargs) as a state_dict in the reference
    `rmvpe.pt` layout, for runs without the trained file: torch's default
    initialisation from `seed`, and every BatchNorm with drawn weight,
    bias, running mean and running variance rather than the identity."""
    from tpu_rvc_torch.models.rmvpe import E2E

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return draw_batchnorm_statistics(E2E(**e2e_kwargs).state_dict())
