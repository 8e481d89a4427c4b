"""Shared helpers of the tpu_rvc_torch parity tests.

Weights start as a seeded tpu_rvc_torch model, are written out in the
reference torch layout (weight norm as (g, v) where the reference keeps
it, fairseq names for HuBERT) and go from there into both packages
through their own loaders: tpu_rvc's `synthesizer_params_from_state_dict`
/ `hubert_params_from_fairseq`, tpu_rvc_torch's
`synthesizer_state_from_reference` / `hubert_state_from_fairseq`.
"""

import re

import numpy as np
import torch

from tpu_rvc.ckpt.convert import synthesizer_params_from_state_dict
from tpu_rvc.ckpt.hubert_loader import hubert_params_from_fairseq
from tpu_rvc.ckpt.rmvpe_loader import rmvpe_params_from_torch
from tpu_rvc.models.rmvpe import E2E as JaxE2E
from tpu_rvc_torch.ckpt.hubert_loader import hubert_state_from_fairseq
from tpu_rvc_torch.ckpt.rmvpe_loader import (random_rmvpe_reference_state,
                                             rmvpe_state_from_reference)
from tpu_rvc_torch.models.hubert import Hubert
from tpu_rvc_torch.models.rmvpe import E2E
from tpu_rvc_torch.models.synthesizer import Synthesizer

SMALL_HUBERT = dict(output_layer=2, final_proj=False, embed=64, ffn_dim=128,
                    n_heads=2, pos_conv_k=16, pos_conv_groups=2,
                    conv_layers=((32, 10, 5), (32, 4, 4), (32, 4, 4),
                                 (32, 2, 2), (32, 2, 2)))  # 320x downsample

SMALL_SYNTH = dict(
    spec_channels=129, segment_size=640, inter_channels=32,
    hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
    kernel_size=3, p_dropout=0.0, resblock="1",
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3, 5),),
    upsample_rates=(10, 16), upsample_initial_channel=64,
    upsample_kernel_sizes=(20, 32), spk_embed_dim=2, gin_channels=16,
    sr=16000, encoder_dim=64, use_f0=True)

TINY = dict(n_blocks=1, n_gru=1, en_de_layers=2, inter_layers=1,
            en_out_channels=4)   # the E2E tests/test_pipeline.py:241 drives
FULL = dict(n_blocks=4, n_gru=1, en_de_layers=5, inter_layers=4,
            en_out_channels=16)  # E2E(4, 1, (2, 2)), the rmvpe.pt shape

# the convs the reference keeps under weight norm
_WEIGHT_NORM = re.compile(r"^(dec\.ups\.|dec\.resblocks\.|flow\.flows\.\d+"
                          r"\.enc\.(in_layers|res_skip_layers|cond_layer))")


def seeded(cls, seed, **kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls(**kw).eval()


def reference_state(net: Synthesizer, seed: int):
    """The port model's weights in the reference layout, numpy, with the
    weight-normed convs split into (g, v): v is a rescaled copy of the
    weight and g carries a random gain, so folding is exercised."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, w in net.state_dict().items():
        w = w.numpy().astype(np.float32)
        if k.endswith(".weight") and _WEIGHT_NORM.match(k):
            base = k[:-len(".weight")]
            norm = np.sqrt((w * w).sum(axis=tuple(range(1, w.ndim)),
                                       keepdims=True))
            out[base + ".weight_v"] = w * 3.0
            out[base + ".weight_g"] = (norm * rng.uniform(
                0.8, 1.2, norm.shape)).astype(np.float32)
        else:
            out[k] = w
    return out


def jax_synth_params(sd, cfg):
    """tpu_rvc params (with (g, v)) from a reference-layout state_dict."""
    return {"params": synthesizer_params_from_state_dict(
        sd, n_layers=cfg["n_layers"], n_ups=len(cfg["upsample_rates"]),
        num_kernels=len(cfg["resblock_kernel_sizes"]),
        use_f0=cfg["use_f0"], fold_weight_norm=False)}


def hubert_pair(cfg, seed):
    """(port Hubert, tpu_rvc Hubert variables) with the same weights,
    carried over a fairseq-layout state_dict."""
    port = seeded(Hubert, seed, **cfg)
    sd = dict(port.state_dict())
    w = sd.pop("encoder.pos_conv.0.weight")
    g = torch.sqrt((w * w).sum(dim=(0, 1), keepdim=True))
    sd["encoder.pos_conv.0.weight_g"] = g
    sd["encoder.pos_conv.0.weight_v"] = w
    port.load_state_dict(hubert_state_from_fairseq(
        sd, cfg["output_layer"], cfg["final_proj"]))
    params = hubert_params_from_fairseq(
        {k: v.numpy() for k, v in sd.items()}, cfg["output_layer"],
        cfg["final_proj"])
    return port, {"params": params}


def e2e_pair(kw, seed):
    """(port E2E, JAX E2E, JAX variables) from one reference-layout state
    dict with non-trivial BatchNorm statistics."""
    sd = random_rmvpe_reference_state(seed, **kw)
    port = E2E(**kw).eval()
    port.load_state_dict(rmvpe_state_from_reference(sd))
    params = rmvpe_params_from_torch(
        {k: v.numpy() for k, v in sd.items()}, kw["n_blocks"],
        kw["en_de_layers"], kw["inter_layers"])
    return port, JaxE2E(**kw), {"params": params}
