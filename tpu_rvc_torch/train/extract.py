"""f0 and HuBERT feature extraction (port of tpu_rvc/train/extract.py;
reference infer/modules/train/extract_f0_print.py and
extract_feature_print.py).

Outputs per utterance, the layout the trainer reads:
  2a_f0/<name>.npy              coarse pitch (int32), mel-quantised 1..255
  2b-f0nsf/<name>.npy           continuous f0 (Hz)
  3_feature{256,768}/<name>.npy HuBERT features (T, D)

f0 goes through the port's `f0/gen.py` (any of its six methods; harvest
median-filters with radius 3, as the reference does); the features through
the port's HuBERT on `device` (the card unless the caller asks for the
CPU), each utterance zero-padded to whole seconds with its padding mask,
as the JAX pass buckets its compiles (`:82-97`).  `part`/`n_parts` take
every n_parts-th file from the part-th of the sorted names, so n_parts
processes share one experiment's files (the reference's per-GPU
processes, extract_feature_print.py:122).
"""

from __future__ import annotations

import os
import traceback
from typing import List

import numpy as np
import torch

from tpu_rvc_torch.audio.io import load_audio
from tpu_rvc_torch.core.device import resolve_device
from tpu_rvc_torch.f0.gen import Generator as F0Generator


def extract_f0(exp_dir: str, f0_method: str = "rmvpe",
               rmvpe_root: str = "assets/rmvpe", device=None,
               part: int = 0, n_parts: int = 1) -> List[str]:
    """Coarse and continuous f0 for every 16 kHz wav of the experiment;
    returns the log lines of the files that failed."""
    inp = os.path.join(exp_dir, "1_16k_wavs")
    out_coarse = os.path.join(exp_dir, "2a_f0")
    out_cont = os.path.join(exp_dir, "2b-f0nsf")
    os.makedirs(out_coarse, exist_ok=True)
    os.makedirs(out_cont, exist_ok=True)
    gen = F0Generator(rmvpe_root, window=160, sr=16000, device=device)
    logs = []
    for name in sorted(os.listdir(inp))[part::n_parts]:
        try:
            c_path = os.path.join(out_coarse, name + ".npy")
            f_path = os.path.join(out_cont, name + ".npy")
            if os.path.exists(c_path) and os.path.exists(f_path):
                continue
            audio = load_audio(os.path.join(inp, name), 16000)
            coarse, cont = gen.calculate(audio, audio.shape[0] // 160, 0,
                                         f0_method, 3)
            if np.isnan(cont).any():
                logs.append(f"{name} -> NaN f0, skipped")
                continue
            np.save(c_path, coarse, allow_pickle=False)
            np.save(f_path, cont, allow_pickle=False)
        except Exception:
            logs.append(f"{name} -> {traceback.format_exc()}")
    return logs


def load_hubert(path: str, version: str, device=None):
    """HuBERT-base from a fairseq checkpoint, or drawn from seed 0 when
    `path` is "random"."""
    if path == "random":
        from tpu_rvc_torch.models.hubert import hubert_for_version
        return hubert_for_version(version, device, seed=0)
    from tpu_rvc_torch.ckpt.hubert_loader import load_hubert_base
    return load_hubert_base(path, version, device)


def extract_features(exp_dir: str, version: str = "v2",
                     hubert_path: str = "assets/hubert/hubert_base.pt",
                     hubert=None, device=None, part: int = 0,
                     n_parts: int = 1) -> List[str]:
    """HuBERT features for every 16 kHz wav (reference
    extract_feature_print.py:80-160); returns the failures' log lines."""
    dev = resolve_device(device)
    if hubert is None:
        hubert = load_hubert(hubert_path, version, dev)
    inp = os.path.join(exp_dir, "1_16k_wavs")
    out_dir = os.path.join(
        exp_dir, "3_feature256" if version == "v1" else "3_feature768")
    os.makedirs(out_dir, exist_ok=True)

    def run(wav: np.ndarray) -> np.ndarray:
        L = len(wav)
        bucket = ((L - 1) // 16000 + 1) * 16000
        pad = np.zeros((1, bucket), np.float32)
        pad[0, :L] = wav
        mask = torch.arange(bucket, device=dev)[None] >= L
        feats = hubert(torch.from_numpy(pad).to(dev), mask)[0]
        return feats[:(L - 400) // 320 + 1].float().cpu().numpy()

    logs = []
    for name in sorted(os.listdir(inp))[part::n_parts]:
        try:
            out_path = os.path.join(out_dir, name.replace("wav", "npy"))
            if os.path.exists(out_path):
                continue
            feats = run(load_audio(os.path.join(inp, name), 16000))
            if np.isnan(feats).any():
                logs.append(f"{name} -> NaN features, skipped")
                continue
            np.save(out_path, feats, allow_pickle=False)
        except Exception:
            logs.append(f"{name} -> {traceback.format_exc()}")
    return logs
