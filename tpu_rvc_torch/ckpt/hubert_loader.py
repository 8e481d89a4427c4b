"""Load a fairseq `hubert_base.pt` into the port's Hubert (port of
tpu_rvc/ckpt/hubert_loader.py:28; reference rvc/hubert.py:265)."""

from __future__ import annotations

from typing import Dict

import torch

from tpu_rvc_torch.core.device import resolve_device
from tpu_rvc_torch.models.hubert import Hubert


def hubert_state_from_fairseq(sd: Dict[str, torch.Tensor],
                              output_layer: int = 12,
                              final_proj: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """fairseq HubertModel state_dict -> the port's: the positional conv's
    weight norm (dim=2) folded, layers beyond the tap and the
    pretraining-only tensors dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith(("label_embs", "mask_emb")):
            continue
        if k.startswith("final_proj") and not final_proj:
            continue
        if k.startswith("encoder.layers."):
            if int(k.split(".")[2]) >= output_layer:
                continue
        out[k.replace("parametrizations.weight.original0", "weight_g")
             .replace("parametrizations.weight.original1", "weight_v")] = \
            v.detach().to("cpu", torch.float32)
    g = out.pop("encoder.pos_conv.0.weight_g", None)
    v = out.pop("encoder.pos_conv.0.weight_v", None)
    if v is not None:
        norm = torch.sqrt((v * v).sum(dim=(0, 1), keepdim=True))
        out["encoder.pos_conv.0.weight"] = g * v / norm
    return out


def load_hubert_base(path: str, version: str = "v2", device=None) -> Hubert:
    """hubert_base.pt (fairseq checkpoint) -> the port's Hubert on device."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if isinstance(ckpt, dict) and "model" in ckpt else ckpt
    mod = (Hubert(output_layer=9, final_proj=True) if version == "v1"
           else Hubert(output_layer=12, final_proj=False))
    mod.load_state_dict(hubert_state_from_fairseq(
        sd, mod.output_layer, mod.final_proj is not None))
    return mod.to(dev).eval()
