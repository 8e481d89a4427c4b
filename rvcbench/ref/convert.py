"""A small model's `weight` dict into the synthesizer's state_dict
(frozen from tpu_rvc_torch/ckpt/convert.py): legacy `weight_g`/`weight_v`
and torch>=2.1 `parametrizations.weight.original{0,1}` keys normalised,
weight norm folded, the training-only enc_q dropped."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def normalize_weight_norm_keys(sd: Dict[str, Any]) -> Dict[str, Any]:
    """parametrizations.weight.original{0,1} -> weight_{g,v}."""
    out = {}
    for k, v in sd.items():
        k = k.replace("parametrizations.weight.original0", "weight_g")
        k = k.replace("parametrizations.weight.original1", "weight_v")
        out[k] = v
    return out


def _tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, np.float32)))


def fold_weight_norm(sd: Dict[str, Any], dim: int = 0) -> StateDict:
    """Replace every (X.weight_g, X.weight_v) pair by X.weight =
    g * v / ||v||, the norm over all axes but `dim` (torch weight_norm)."""
    out: StateDict = {}
    for k, v in sd.items():
        if k.endswith(".weight_g"):
            continue
        if k.endswith(".weight_v"):
            base = k[:-len(".weight_v")]
            g, vv = _tensor(sd[base + ".weight_g"]), _tensor(v)
            axes = [a for a in range(vv.dim()) if a != dim % vv.dim()]
            norm = torch.sqrt((vv * vv).sum(dim=axes, keepdim=True))
            out[base + ".weight"] = (g * vv / norm).contiguous()
        else:
            out[k] = _tensor(v)
    return out


def synthesizer_state_from_reference(sd: Dict[str, Any]) -> StateDict:
    """Reference small-model `weight` dict -> the port's Synthesizer
    state_dict (float32, weight norm folded, training-only enc_q dropped)."""
    sd = {k: v for k, v in normalize_weight_norm_keys(sd).items()
          if not k.startswith("enc_q.")}
    return fold_weight_norm(sd)
