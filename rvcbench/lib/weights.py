"""Random weights from the seed, made on the device in one draw a model
and scaled leaf by leaf, in the layouts RVC's files use."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

Shapes = Dict[str, Tuple[int, ...]]


def fan_in(shape: Tuple[int, ...]) -> int:
    return max(1, math.prod(shape[1:]))


def default_rule(key: str, shape: Tuple[int, ...]):
    """(kind, value) for a leaf: "normal" scales its standard normal draw,
    "const" fills it, "sigmoid" maps it into (value, value + 1).  Matrices
    and kernels at 1/sqrt(fan-in), so activations keep their scale through
    the depth; vectors are norms' gains at 1 or small biases."""
    leaf = key.rsplit(".", 1)[-1]
    if len(shape) <= 1:
        if leaf in ("weight", "gamma"):
            return "const", 1.0
        if leaf == "beta":
            return "const", 0.0
        return "normal", 0.01
    return "normal", 1.0 / math.sqrt(fan_in(shape))


def random_state(shapes: Shapes, seed: int, device,
                 rule: Callable = default_rule,
                 dtype: Optional[torch.dtype] = None
                 ) -> Dict[str, torch.Tensor]:
    """One standard normal draw for every leaf together, from a generator
    on `device` seeded with `seed`, then each leaf scaled by `rule`."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for key, shape in shapes.items():
        n = math.prod(shape)
        leaf = flat[at: at + n].view(shape)
        at += n
        kind, value = rule(key, shape)
        if kind == "const":
            leaf.fill_(value)
        elif kind == "sigmoid":          # in (lo, lo + 1)
            leaf.sigmoid_().add_(value)
        else:
            leaf.mul_(value)
        out[key] = leaf if dtype is None else leaf.to(dtype)
    return out


UPS_GAIN = 5.0


def synthesizer_rule(key, shape):
    """The synthesizer: the decoder's upsamplers and resblocks drawn at
    0.01 as RVC initialises them, the upsamplers then scaled by
    `UPS_GAIN` towards a trained model's (at 0.01 the audio is the
    decoder's bias pattern, periodic in the hop, and SOLA's offsets tie);
    the relative-position tables at dk^-0.5; the speaker embedding at 1;
    the phone and pitch embeddings as below."""
    if key.startswith("dec.ups.") and key.endswith("weight"):
        return "normal", 0.01 * UPS_GAIN
    if key.startswith("dec.resblocks.") and key.endswith("weight"):
        return "normal", 0.01
    if key.endswith(("emb_rel_k", "emb_rel_v")):
        return "normal", shape[-1] ** -0.5
    if key == "emb_g.weight":
        return "normal", 1.0
    # the phone and pitch embeddings at the scale that gives the
    # encoder's input (their sum, times sqrt(hidden)) unit variance, a
    # trained model's regime: at torch's scales (1 for the pitch
    # table) the attention's logits reach hundreds, the softmax picks
    # one key, and one frame's pitch bin moves the whole output
    if key == "enc_p.emb_pitch.weight":
        return "normal", (2.0 * shape[1]) ** -0.5
    if key == "enc_p.emb_phone.weight":
        return "normal", (2.0 * shape[0] * shape[1]) ** -0.5
    return default_rule(key, shape)


def hubert_rule(key, shape):
    """fairseq's HuBERT: weight norm's g at 1 (the kernel's norm is v's)."""
    if key.endswith("weight_g"):
        return "const", 1.0
    return default_rule(key, shape)


def rmvpe_rule(key, shape):
    """RMVPE: each BatchNorm with drawn statistics rather than the
    identity: weight and running variance in (0.5, 1.5), bias and
    running mean at 0.1."""
    leaf = key.rsplit(".", 1)[-1]
    if leaf == "running_var" or (leaf == "weight" and len(shape) == 1):
        return "sigmoid", 0.5
    if leaf == "running_mean" or (leaf == "bias" and len(shape) == 1):
        return "normal", 0.1
    return default_rule(key, shape)
