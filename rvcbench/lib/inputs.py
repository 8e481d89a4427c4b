"""The weights every inference cell hands to the program and to the
reference alike, made from the seed: the synthesizer as a small model's
`weight` dict (fp16, as RVC stores it) with its `config` list, HuBERT in
fairseq's layout, RMVPE in the reference `rmvpe.pt` layout, and the
retrieval index's rows with their squared norms."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from rvcbench.ref import models
from . import weights


def subseeds(seed: int, n: int) -> List[int]:
    """n independent 63-bit seeds from the run's seed."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(
        n, dtype=np.uint64) >> np.uint64(1)]


def small_model_config(cfg: Dict) -> list:
    """process_ckpt.py's `config` list of a configuration."""
    m, d, t = cfg["model"], cfg["data"], cfg["train"]
    return [d["filter_length"] // 2 + 1, t["segment_size"],
            m["inter_channels"], m["hidden_channels"], m["filter_channels"],
            m["n_heads"], m["n_layers"], m["kernel_size"], m["p_dropout"],
            m["resblock"], list(m["resblock_kernel_sizes"]),
            [list(x) for x in m["resblock_dilation_sizes"]],
            list(m["upsample_rates"]), m["upsample_initial_channel"],
            list(m["upsample_kernel_sizes"]), m["spk_embed_dim"],
            m["gin_channels"], d["sampling_rate"]]


def make(cfg: Dict, seed: int, device, index_rows: int = None) -> Dict:
    """{"config", "synth", "hubert", "rmvpe", "index"}: the synthesizer and
    RMVPE dicts on the host in fp16, HuBERT on `device` in fp32, the index
    as numpy (rows, squared norms)."""
    s_syn, s_hub, s_rmv, s_idx = subseeds(seed, 4)
    config = small_model_config(cfg)
    use_f0 = bool(cfg["f0"])
    synth = weights.random_state(
        models.synthesizer_shapes(config, cfg["version"], use_f0), s_syn,
        device, weights.synthesizer_rule,
        torch.float16)
    hubert = weights.random_state(
        models.hubert_shapes(**models.hubert_kwargs(cfg["hubert"])), s_hub,
        device, weights.hubert_rule)
    rmvpe = weights.random_state(models.rmvpe_shapes(), s_rmv, device,
                                 weights.rmvpe_rule, torch.float16)
    rows = int(cfg["index_rows"] if index_rows is None else index_rows)
    dim = 256 if cfg["version"] == "v1" else 768
    gen = torch.Generator(device=device).manual_seed(s_idx)
    vecs = torch.randn((rows, dim), generator=gen,
                       device=device).cpu().numpy()
    return {"config": config, "synth": {k: v.cpu() for k, v in synth.items()},
            "hubert": hubert,
            "rmvpe": {k: v.cpu() for k, v in rmvpe.items()},
            "index": (vecs, (vecs * vecs).sum(1).astype(np.float32))}


def reference_nets(bundle: Dict, cfg: Dict, device):
    """The reference's HuBERT, synthesizer, RMVPE and index tensors from
    the same bundle."""
    hub = models.hubert(bundle["hubert"], device,
                        **models.hubert_kwargs(cfg["hubert"]))
    syn = models.synthesizer(bundle["synth"], bundle["config"],
                             cfg["version"], bool(cfg["f0"]), device)
    rmv = models.rmvpe(bundle["rmvpe"], device)
    vecs, sq = bundle["index"]
    index = (torch.as_tensor(vecs, device=device),
             torch.as_tensor(sq, device=device))
    return hub, syn, rmv, index
