"""Load a torchfcpe bundled checkpoint into the port's CFNaiveMelPE (port of
tpu_rvc/ckpt/fcpe_loader.py:31-98; reference rvc/f0/fcpe.py:26-30 loads it
through `torchfcpe.spawn_bundled_infer_model`).

The file is `{"config_dict"|"config": {"model": {...}}, "model":
state_dict}`.  Weight norm comes under either naming (`weight_g`/`weight_v`
or `parametrizations.weight.original0/1`); the output projection may be
weight-normed or folded; the depthwise conv's key may lack `.conv`.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from tpu_rvc_torch.core.device import resolve_device

_G = "parametrizations.weight.original0"
_V = "parametrizations.weight.original1"


def _model_config(ckpt: dict) -> dict:
    cfg = ckpt.get("config_dict") or ckpt.get("config") or {}
    m = cfg.get("model", cfg) if isinstance(cfg, dict) else {}
    return m if isinstance(m, dict) else {}


def _model_kwargs(ckpt: dict, sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """CFNaiveMelPE arguments from the checkpoint's model config; the
    depthwise kernel from its weight.  Raises NotImplementedError for the
    transformer (not conv-only) variant."""
    m = _model_config(ckpt)
    if not m.get("conv_only", True):
        raise NotImplementedError(
            "only the conv-only bundled FCPE configuration is supported")
    dw = sd["net.encoder_layers.0.conformer.net.4.conv.weight"]
    return dict(in_dims=int(m.get("input_channel", m.get("in_dims", 128))),
                hidden_dims=int(m.get("hidden_dims", 512)),
                out_dims=int(m.get("out_dims", 360)),
                n_layers=int(m.get("n_layers", 6)),
                kernel=int(dw.shape[-1]),
                f0_min=float(m.get("f0_min", 32.70)),
                f0_max=float(m.get("f0_max", 1975.5)))


def fcpe_state_from_reference(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchfcpe CFNaiveMelPE state_dict -> the port's, float32: the
    weight-normed output Linear folded row by row (w = g * v / |v|, in
    float64), the depthwise key given its `.conv`."""
    def t(v):
        return (v.detach().cpu() if isinstance(v, torch.Tensor)
                else torch.as_tensor(np.asarray(v)))

    sd = {k.replace(_G, "weight_g").replace(_V, "weight_v"): t(v)
          for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith("output_proj.weight_"):
            continue
        if ".conformer.net.4." in k and ".conv." not in k:
            k = k.replace(".conformer.net.4.", ".conformer.net.4.conv.")
        out[k] = v.float()
    if "output_proj.weight_v" in sd:
        v = sd["output_proj.weight_v"].double()
        g = sd["output_proj.weight_g"].double().reshape(-1, 1)
        out["output_proj.weight"] = (g * v / v.norm(dim=1, keepdim=True)
                                     ).float()
    return out


def load_fcpe(path: str, device=None):
    """CFNaiveMelPE with the weights of `path` on `device` (default
    "cuda"), in eval mode.  A missing file raises FileNotFoundError."""
    from tpu_rvc_torch.models.fcpe import CFNaiveMelPE

    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    raw = ckpt.get("model") or ckpt.get("model_state_dict") or ckpt
    sd = fcpe_state_from_reference(
        {k: v for k, v in raw.items() if hasattr(v, "shape")})
    model = CFNaiveMelPE(**_model_kwargs(ckpt, sd))
    model.load_state_dict(sd)
    return model.to(dev).eval()


def random_fcpe_reference_state(seed: int, **cfg) -> Dict[str, Any]:
    """A random-weight CFNaiveMelPE(**cfg) as a torchfcpe bundled
    checkpoint, for runs without the trained file: torch's default
    initialisation from `seed`, the output projection weight-normed as
    (g, v) with a drawn gain, and the model config under
    `config["model"]`.  The depthwise kernel must stay 31, which tpu_rvc's
    loader assumes."""
    from tpu_rvc_torch.models.fcpe import CFNaiveMelPE

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = CFNaiveMelPE(**cfg)
        sd = {k: v.clone() for k, v in net.state_dict().items()}
        w = sd.pop("output_proj.weight")
        sd["output_proj.weight_v"] = w * 3.0
        sd["output_proj.weight_g"] = (w.norm(dim=1, keepdim=True)
                                      * torch.empty(w.shape[0], 1)
                                      .uniform_(0.8, 1.2))
    config = {"input_channel": net.input_stem[0].in_channels,
              "hidden_dims": net.norm.normalized_shape[0],
              "out_dims": net.out_dims,
              "n_layers": len(net.net.encoder_layers),
              "f0_min": net.f0_min, "f0_max": net.f0_max,
              "conv_only": True}
    return {"config": {"model": config}, "model": sd}
