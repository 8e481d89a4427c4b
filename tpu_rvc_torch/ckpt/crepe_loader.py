"""Load a torchcrepe `full.pth` into the port's Crepe (port of
tpu_rvc/ckpt/crepe_loader.py).  torchcrepe's keys: conv{i}.weight (out, in,
k, 1) and .bias, conv{i}_BN.{weight, bias, running_mean, running_var},
classifier.{weight, bias}.  BatchNorm is folded with eps 1e-5, as
tpu_rvc's loader folds it (`ckpt/rmvpe_loader.py`)."""

from __future__ import annotations

from typing import Dict

import torch

from tpu_rvc_torch.core.device import resolve_device
from .rmvpe_loader import draw_batchnorm_statistics, rmvpe_state_from_reference


def load_crepe(path: str, device=None):
    """Crepe() with the weights of `path` on `device` (default "cuda"), in
    eval mode.  A missing file raises FileNotFoundError."""
    from tpu_rvc_torch.models.crepe import Crepe

    dev = resolve_device(device)
    model = Crepe()
    model.load_state_dict(rmvpe_state_from_reference(
        torch.load(path, map_location="cpu", weights_only=True)))
    return model.to(dev).eval()


def random_crepe_reference_state(seed: int) -> Dict[str, torch.Tensor]:
    """A random-weight Crepe as a state_dict in torchcrepe's `full.pth`
    layout: torch's default initialisation from `seed`, every BatchNorm
    with drawn weight, bias, running mean and running variance."""
    from tpu_rvc_torch.models.crepe import Crepe

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return draw_batchnorm_statistics(Crepe().state_dict())
