"""Load UVR5 VR checkpoints into the port's nets (port of
tpu_rvc/ckpt/uvr5_loader.py): the HP2/HP3/HP5 `CascadedASPPNet`
(reference nets_123821KB.py layout) and the VR-DeEcho/DeReverb
`CascadedNet` (reference nets.py layout).

The port's modules carry the reference's names, so a reference state_dict
loads once its BatchNorms are folded into (scale, bias) pairs
(`rmvpe_loader.rmvpe_state_from_reference`), the training-only auxiliary
heads are dropped, and the DeEcho decoders' `conv1` is read as `conv`.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import torch

from tpu_rvc_torch.ckpt.rmvpe_loader import (draw_batchnorm_statistics,
                                             rmvpe_state_from_reference)
from tpu_rvc_torch.core.device import resolve_device

# the reference's deep-supervision heads: used in training, never read
_AUX_HEADS = ("aux1_out.weight", "aux2_out.weight", "aux_out.weight")
_DEC_CONV1 = re.compile(r"(\.dec\d)\.conv1\.")


def cascaded_aspp_state_from_reference(sd: Dict[str, Any]
                                       ) -> Dict[str, torch.Tensor]:
    """Reference nets_123821KB.py `CascadedASPPNet` state_dict -> the
    port's `CascadedASPPNet` state_dict."""
    return rmvpe_state_from_reference(
        {k: v for k, v in sd.items() if k not in _AUX_HEADS})


def deecho_state_from_reference(sd: Dict[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Reference nets.py `CascadedNet` state_dict -> the port's
    `CascadedNetDeEcho` state_dict (its decoders' `conv1` is `conv`)."""
    return rmvpe_state_from_reference(
        {_DEC_CONV1.sub(r"\1.conv.", k): v for k, v in sd.items()
         if k not in _AUX_HEADS})


def _load(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_cascaded_aspp(path: str, n_fft: int = 1344, device=None):
    """An HP-style UVR5 `.pth` -> `CascadedASPPNet(n_fft)` on `device`
    (default "cuda"), in eval mode.  n_fft is the band parameters' bins x 2
    (4band_v2: 672 -> 1344)."""
    from tpu_rvc_torch.models.uvr5 import CascadedASPPNet

    dev = resolve_device(device)
    model = CascadedASPPNet(n_fft)
    model.load_state_dict(cascaded_aspp_state_from_reference(_load(path)))
    return model.to(dev).eval()


def load_deecho(path: str, n_fft: int = 1024, device=None):
    """A VR-DeEcho*/DeReverb `.pth` -> `CascadedNetDeEcho` on `device`,
    with `nout` from `out.weight`'s input channels and `nout_lstm` from the
    first LSTM's dense layer (tpu_rvc/ckpt/uvr5_loader.py:154-156)."""
    from tpu_rvc_torch.models.uvr5 import CascadedNetDeEcho

    dev = resolve_device(device)
    sd = _load(path)
    nout = int(sd["out.weight"].shape[1])
    nout_lstm = int(sd["stg1_low_band_net.0.lstm_dec2.dense.0.weight"]
                    .shape[1])
    model = CascadedNetDeEcho(n_fft, nout=nout, nout_lstm=nout_lstm)
    model.load_state_dict(deecho_state_from_reference(sd))
    return model.to(dev).eval()


def _reference_state(model: torch.nn.Module, aux_heads
                     ) -> Dict[str, torch.Tensor]:
    """`model`'s torch initialisation in the reference layout:
    every FoldedBN a BatchNorm with drawn statistics, plus the auxiliary
    heads' weights the reference checkpoints carry."""
    sd = draw_batchnorm_statistics(model.state_dict())
    for name, cin in aux_heads:
        sd[name] = torch.randn(2, cin, 1, 1) * 0.1
    return sd


def random_cascaded_aspp_reference_state(seed: int, n_fft: int = 1344
                                         ) -> Dict[str, torch.Tensor]:
    """A random-weight `CascadedASPPNet(n_fft)` as a state_dict in the
    reference nets_123821KB.py layout, for runs without trained files."""
    from tpu_rvc_torch.models.uvr5 import CascadedASPPNet

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return _reference_state(CascadedASPPNet(n_fft),
                                (("aux1_out.weight", 32),
                                 ("aux2_out.weight", 32)))


def random_deecho_reference_state(seed: int, n_fft: int = 1344,
                                  nout: int = 32, nout_lstm: int = 128
                                  ) -> Dict[str, torch.Tensor]:
    """A random-weight `CascadedNetDeEcho` as a state_dict in the reference
    nets.py layout (decoders' `conv1`, the `aux_out` head)."""
    from tpu_rvc_torch.models.uvr5 import CascadedNetDeEcho

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = _reference_state(
            CascadedNetDeEcho(n_fft, nout=nout, nout_lstm=nout_lstm),
            (("aux_out.weight", 3 * nout // 4),))
    return {re.sub(r"(\.dec\d)\.conv\.", r"\1.conv1.", k): v
            for k, v in sd.items()}
