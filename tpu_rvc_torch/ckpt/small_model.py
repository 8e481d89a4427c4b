"""Small-model export (port of tpu_rvc/ckpt/small_model.py:21-79;
reference infer/lib/train/process_ckpt.py:15-57).

A small model is RVC's interchange format: the generator's weights in
fp16 without enc_q (weight norm as (g, v), as a training checkpoint holds
it), the positional `config` list and metadata.  `models/loader.py` and
`tpu_rvc.models.loader` both read what `save_small_model` writes.  The
model identity hash (`tpu_rvc/ckpt/hash.py`) is not written: it is queued
with the other checkpoint tools (ROADMAP.md queue A).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

import torch

from tpu_rvc_torch.core.config import HParams


def config_list_from_hparams(hp: HParams) -> List:
    """The positional config list (process_ckpt.py:23-42)."""
    m, d = hp.model, hp.data
    return [d.filter_length // 2 + 1, 32, m.inter_channels,
            m.hidden_channels, m.filter_channels, m.n_heads, m.n_layers,
            m.kernel_size, m.p_dropout, m.resblock,
            list(m.resblock_kernel_sizes),
            [list(x) for x in m.resblock_dilation_sizes],
            list(m.upsample_rates), m.upsample_initial_channel,
            list(m.upsample_kernel_sizes), m.spk_embed_dim, m.gin_channels,
            d.sampling_rate]


def save_small_model(state_dict: Dict[str, torch.Tensor], sr: str,
                     if_f0: int, name: str, epoch, version: str, hp: HParams,
                     out_path: Optional[str] = None,
                     author: str = "") -> str:
    """Write an inference small model from a generator state_dict in the
    reference names (the training G's own)."""
    opt: Dict[str, Any] = {
        "weight": {k: v.detach().to("cpu", torch.float16)
                   for k, v in state_dict.items() if "enc_q" not in k},
        "config": config_list_from_hparams(hp), "info": f"{epoch}epoch",
        "name": name, "timestamp": int(time.time())}
    if author:
        opt["author"] = author
    opt.update(sr=sr, f0=int(if_f0), version=version)
    path = out_path or f"assets/weights/{name}.pth"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(opt, path)
    return path
