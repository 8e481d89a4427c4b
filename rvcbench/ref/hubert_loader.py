"""Load a fairseq `hubert_base.pt` into the port's Hubert (port of
tpu_rvc/ckpt/hubert_loader.py:28; reference rvc/hubert.py:265)."""

from __future__ import annotations

from typing import Dict

import torch



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
