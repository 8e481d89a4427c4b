"""Small-model export, extract, merge and info editing (port of
tpu_rvc/ckpt/small_model.py; reference infer/lib/train/process_ckpt.py:15,
60, 197, 209).

A small model is RVC's interchange format: the generator's weights in
fp16 without enc_q (weight norm as (g, v), as a training checkpoint holds
it), the positional `config` list and metadata.  `models/loader.py` and
`tpu_rvc.models.loader` both read what this module writes.
`save_small_model` adds the model identity hash and its id (`ckpt/hash.py`)
when the conversion can run; otherwise `hash` is None and there is no
`id`, the JAX package's key set in both cases.
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


def _strip_and_half(sd) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).detach().to("cpu", torch.float16)
            for k, v in sd.items() if "enc_q" not in k}


def _write(opt: Dict[str, Any], name: str, out_path: Optional[str]) -> str:
    path = out_path or f"assets/weights/{name}.pth"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(opt, path)
    return path


def _small_model(weight, hp: HParams, info: str, name: str, author: str,
                 sr: str, if_f0: int, version: str) -> Dict[str, Any]:
    opt: Dict[str, Any] = {"weight": weight,
                           "config": config_list_from_hparams(hp),
                           "info": info, "name": name,
                           "timestamp": int(time.time())}
    if author:
        opt["author"] = author
    opt.update(sr=sr, f0=int(if_f0), version=version)
    return opt


def _load(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def save_small_model(state_dict: Dict[str, torch.Tensor], sr: str,
                     if_f0: int, name: str, epoch, version: str, hp: HParams,
                     out_path: Optional[str] = None,
                     author: str = "", hubert=None) -> str:
    """Write an inference small model from a generator state_dict in the
    reference names (the training G's own), with its hash and id
    (`ckpt/hash.py` `model_hash_ckpt`, through `hubert` when given)."""
    from .hash import hash_id, model_hash_ckpt

    opt = _small_model(_strip_and_half(state_dict), hp, f"{epoch}epoch",
                       name, author, sr, if_f0, version)
    opt["hash"] = model_hash_ckpt(opt, hubert=hubert)
    if opt["hash"] is not None:    # no hash, no id: the JAX file's keys
        opt["id"] = hash_id(opt["hash"])
    return _write(opt, name, out_path)


def extract_small_model(train_ckpt_path: str, name: str, sr: str,
                        if_f0: int, info: str, version: str, hp: HParams,
                        out_path: Optional[str] = None,
                        author: str = "") -> str:
    """A small model from a training checkpoint (a `G_*.pth`: its "model"
    dict, or the state_dict itself) (reference extract_small_model,
    process_ckpt.py:60)."""
    ckpt = _load(train_ckpt_path)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    opt = _small_model(_strip_and_half(sd), hp, info or "extracted", name,
                       author, sr, if_f0, version)
    return _write(opt, name, out_path)


def change_info(path: str, info: str, name: str, out_dir: str = ".") -> str:
    """Rewrite a small model's `info` into out_dir/name, the file's own
    name by default (reference change_info, process_ckpt.py:197)."""
    ckpt = _load(path)
    ckpt["info"] = info
    out = os.path.join(out_dir, name or os.path.basename(path))
    torch.save(ckpt, out)
    return out


def merge(path1: str, path2: str, alpha1: float, sr: str, f0: int,
          info: str, name: str, version: str,
          out_path: Optional[str] = None) -> str:
    """alpha1 * model 1 + (1 - alpha1) * model 2, summed in fp32 and
    rounded once to fp16 as the JAX package does (fp16 arithmetic would
    round each product); `emb_g` takes the smaller speaker table's rows
    (reference merge, process_ckpt.py:209).  The config is model 1's."""

    def weights(ckpt):
        sd = ckpt["model"] if "model" in ckpt else ckpt["weight"]
        return {k: torch.as_tensor(v).float() for k, v in sd.items()
                if "enc_q" not in k}

    ckpt1, ckpt2 = _load(path1), _load(path2)
    w1, w2 = weights(ckpt1), weights(ckpt2)
    if sorted(w1) != sorted(w2):
        raise ValueError("model architectures are not the same")
    merged = {}
    for k, a in w1.items():
        b = w2[k]
        if k == "emb_g.weight" and a.shape != b.shape:
            n = min(a.shape[0], b.shape[0])
            a, b = a[:n], b[:n]
        merged[k] = (alpha1 * a + (1 - alpha1) * b).half()
    a1, a2 = ckpt1.get("author", ""), ckpt2.get("author", "")
    author = a1 if a1 == a2 else f"{a1 or 'Unknown'} & {a2 or 'Unknown'}"
    opt: Dict[str, Any] = {
        "weight": merged, "config": ckpt1["config"], "name": name,
        "timestamp": int(time.time()), "sr": sr, "f0": int(f0),
        "version": version, "info": info}
    if author:
        opt["author"] = author
    return _write(opt, name, out_path)
