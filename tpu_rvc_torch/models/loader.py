"""Synthesizer from an RVC `.pth` small model (port of
tpu_rvc/models/loader.py; reference rvc/synthesizer.py:10-31).

Small-model layout (infer/lib/train/process_ckpt.py:15-57):
  {"weight": state_dict, "config": [spec_channels, segment_size, inter,
   hidden, filter, n_heads, n_layers, kernel, p_dropout, resblock,
   resblock_kernel_sizes, resblock_dilation_sizes, upsample_rates,
   upsample_initial_channel, upsample_kernel_sizes, spk_embed_dim, gin,
   sr], "f0": 0|1, "version": "v1"|"v2", "sr": "32k|40k|48k", ...}
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from tpu_rvc_torch.ckpt.convert import synthesizer_state_from_reference
from tpu_rvc_torch.core.device import resolve_device
from .synthesizer import Synthesizer

SR_MAP = {"32k": 32000, "40k": 40000, "48k": 48000}


def synthesizer_from_config(config, version: str,
                            use_f0: bool) -> Synthesizer:
    (spec_channels, segment_size, inter, hidden, filt, n_heads, n_layers,
     kernel, p_drop, resblock, res_k, res_d, ups, up_init, up_k,
     spk_dim, gin, sr) = config
    if isinstance(sr, str):
        sr = SR_MAP[sr]
    return Synthesizer(
        spec_channels=int(spec_channels), segment_size=int(segment_size),
        inter_channels=int(inter), hidden_channels=int(hidden),
        filter_channels=int(filt), n_heads=int(n_heads),
        n_layers=int(n_layers), kernel_size=int(kernel),
        p_dropout=float(p_drop), resblock=str(resblock),
        resblock_kernel_sizes=tuple(int(k) for k in res_k),
        resblock_dilation_sizes=tuple(tuple(int(x) for x in d)
                                      for d in res_d),
        upsample_rates=tuple(int(u) for u in ups),
        upsample_initial_channel=int(up_init),
        upsample_kernel_sizes=tuple(int(k) for k in up_k),
        spk_embed_dim=int(spk_dim), gin_channels=int(gin), sr=int(sr),
        encoder_dim=256 if version == "v1" else 768, use_f0=bool(use_f0))


def load_synthesizer(path: str, device=None
                     ) -> Tuple[Synthesizer, Dict[str, Any]]:
    """Load an RVC small model -> (module on device, metadata)."""
    dev = resolve_device(device)
    cpt = torch.load(path, map_location="cpu", weights_only=False)
    meta = {k: v for k, v in cpt.items() if k != "weight"}
    version = cpt.get("version", "v1")
    use_f0 = bool(cpt.get("f0", 1))
    sd = synthesizer_state_from_reference(cpt["weight"])
    config = list(cpt["config"])
    # reference quirk (rvc/synthesizer.py:15): spk_embed_dim comes from the
    # emb_g table, since merged models may disagree with their config
    config[-3] = sd["emb_g.weight"].shape[0]
    # the phone embedding's width comes from the weights as well
    mod = synthesizer_from_config(config, version, use_f0)
    enc_dim = sd["enc_p.emb_phone.weight"].shape[1]
    if enc_dim != mod.enc_p.emb_phone.in_features:
        mod.enc_p.emb_phone = torch.nn.Linear(
            enc_dim, mod.enc_p.emb_phone.out_features)
    mod.load_state_dict(sd, strict=True)
    return mod.to(dev).eval(), meta
