"""The reference's networks, built from state dicts in the layouts that
RVC's files use (a small model's `weight` dict, fairseq's HuBERT, the
reference `rmvpe.pt`), and the shapes of those layouts, read off modules
on the meta device."""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .convert import synthesizer_state_from_reference
from .hubert import Hubert
from .hubert_loader import hubert_state_from_fairseq
from .rmvpe import E2E
from .rmvpe_loader import rmvpe_state_from_reference
from .synthesizer import Synthesizer

SR_MAP = {"32k": 32000, "40k": 40000, "48k": 48000}
Shapes = Dict[str, Tuple[int, ...]]


def synthesizer_from_config(config: Sequence, version: str, use_f0: bool,
                            train: bool = False) -> Synthesizer:
    """A small model's `config` list (process_ckpt.py's order) -> an
    empty Synthesizer."""
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
        encoder_dim=256 if version == "v1" else 768, use_f0=bool(use_f0),
        train=train)


def synthesizer(weight: Dict[str, torch.Tensor], config: Sequence,
                version: str, use_f0: bool, device) -> Synthesizer:
    """The inference synthesizer of a small model, in float32."""
    mod = synthesizer_from_config(config, version, use_f0)
    mod.load_state_dict(synthesizer_state_from_reference(weight), strict=True)
    return mod.to(device).eval()


def hubert_kwargs(cfg: Dict) -> Dict:
    """A configuration's `hubert` group -> Hubert's arguments (RVC v2:
    the last layer's output, no final_proj)."""
    return dict(embed=cfg["embed_dim"], ffn_dim=cfg["ffn_dim"],
                n_heads=cfg["heads"], output_layer=cfg["output_layer"],
                final_proj=bool(cfg["final_proj"]))


def hubert(sd: Dict[str, torch.Tensor], device, **kw) -> Hubert:
    """HuBERT from fairseq's layout, tapped at `output_layer`."""
    mod = Hubert(**kw)
    mod.load_state_dict(hubert_state_from_fairseq(
        sd, mod.output_layer, mod.final_proj is not None))
    return mod.to(device).eval()


def rmvpe(sd: Dict[str, torch.Tensor], device) -> E2E:
    mod = E2E()
    mod.load_state_dict(rmvpe_state_from_reference(sd))
    return mod.to(device).eval()


def _shapes(module: torch.nn.Module) -> Shapes:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def synthesizer_shapes(config: Sequence, version: str, use_f0: bool
                       ) -> Shapes:
    """The small model's `weight` layout: weight norm folded."""
    with torch.device("meta"):
        return _shapes(synthesizer_from_config(config, version, use_f0))


def hubert_shapes(**kw) -> Shapes:
    """fairseq's HuBERT layout up to the tapped layer: the positional conv
    under weight norm over dim 2 (weight_g (1, 1, K), weight_v)."""
    with torch.device("meta"):
        out = _shapes(Hubert(**kw))
    w = out.pop("encoder.pos_conv.0.weight")
    out["encoder.pos_conv.0.weight_g"] = (1, 1, w[2])
    out["encoder.pos_conv.0.weight_v"] = w
    return out


def rmvpe_shapes() -> Shapes:
    """The reference `rmvpe.pt` layout: each folded BatchNorm as its
    weight, bias, running mean and variance."""
    with torch.device("meta"):
        folded = _shapes(E2E())
    out: Shapes = {}
    for k, v in folded.items():
        prefix, _, leaf = k.rpartition(".")
        if leaf == "scale":
            for name in ("weight", "bias", "running_mean", "running_var"):
                out[f"{prefix}.{name}"] = v
        elif f"{prefix}.scale" not in folded:
            out[k] = v
    return out
