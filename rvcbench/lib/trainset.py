"""A training set made from the seed, in the layout the port's training
reads (`0_gt_wavs/*.wav`, `3_feature768/*.npy`, `2a_f0/*.wav.npy`,
`2b-f0nsf/*.wav.npy`, each wav's spectrogram cached beside it as
`.spec.npy`, and a filelist of "wav|feature|f0|f0nsf|sid" rows), and the
training weights of the synthesizer and the multi-period discriminator.

The voice: `recordings` takes of `recording_s` seconds, cut as RVC's
preprocessing cuts them: pieces of `piece_s` starting every `piece_s -
overlap_s`, and the shorter tail.  Each piece has its wave at the
model's rate, random features at HuBERT's width and frame rate (50 a
second), the voice's own f0 track every 10 ms and its coarse bins, and
its linear spectrogram, computed here with the reference's STFT."""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from rvcbench.ref import models
from rvcbench.ref.discriminators import MultiPeriodDiscriminator
from rvcbench.ref.mel import spectrogram
from . import voices, weights
from .inputs import small_model_config, subseeds


def coarse_f0(f0: np.ndarray, f0_min=50.0, f0_max=1100.0) -> np.ndarray:
    """Mel-scale bins 1..255 (RVC's extraction, rvc/f0/gen.py:33-40)."""
    mel_min = 1127.0 * np.log(1 + f0_min / 700.0)
    mel_max = 1127.0 * np.log(1 + f0_max / 700.0)
    mel = 1127.0 * np.log(1 + np.asarray(f0, np.float64) / 700.0)
    scaled = np.where(mel > 0,
                      (mel - mel_min) * 254.0 / (mel_max - mel_min) + 1.0,
                      mel)
    return np.rint(np.clip(scaled, 1.0, 255.0)).astype(np.int32)


def write(exp: str, cfg: Dict, cell: Dict, seed: int, device) -> str:
    """The training set under `exp` -> its filelist's path."""
    d = cfg["data"]
    sr, hop = d["sampling_rate"], d["hop_length"]
    dirs = {k: os.path.join(exp, k) for k in
            ("0_gt_wavs", "3_feature768", "2a_f0", "2b-f0nsf")}
    for p in dirs.values():
        os.makedirs(p, exist_ok=True)
    rng = np.random.default_rng(subseeds(seed, 9)[7])
    piece, step = cell["piece_s"], cell["piece_s"] - cell["overlap_s"]
    rows = []
    for r in range(cell["recordings"]):
        audio, f0 = voices.voice(cell["recording_s"],
                                 int(rng.integers(2 ** 62)), sr,
                                 with_f0=True, device=device)
        starts = np.arange(0.0, cell["recording_s"] - piece + 1e-9, step)
        cuts = [(s, s + piece) for s in starts]
        if cuts[-1][1] < cell["recording_s"] - 1e-9:
            cuts.append((cuts[-1][0] + step, cell["recording_s"]))
        for k, (a, b) in enumerate(cuts):
            name = f"{r}_{k}"
            wav = audio[int(a * sr): int(b * sr)]
            wav = (wav * (0.9 / max(np.abs(wav).max(), 1e-9))).astype(
                np.float32)
            wav_path = os.path.join(dirs["0_gt_wavs"], name + ".wav")
            voices.write_wav(wav_path, wav, sr)
            n16 = int(round((b - a) * 16000))
            n_feat = (n16 - 400) // 320 + 1
            feats = rng.standard_normal((n_feat, 768)).astype(np.float16)
            np.save(os.path.join(dirs["3_feature768"], name + ".npy"), feats)
            track = f0[int(round(a * 100)): int(round(a * 100)) + n16 // 160]
            np.save(os.path.join(dirs["2a_f0"], name + ".wav.npy"),
                    coarse_f0(track))
            np.save(os.path.join(dirs["2b-f0nsf"], name + ".wav.npy"),
                    track.astype(np.float32))
            pcm = voices.read_wav(wav_path)
            with torch.no_grad():
                spec = spectrogram(torch.as_tensor(pcm, device=device)[None],
                                   d["filter_length"], hop, d["win_length"])
            np.save(wav_path.replace(".wav", ".spec.npy"),
                    spec[0].T.cpu().numpy().astype(np.float16))
            rows.append("|".join([
                wav_path, os.path.join(dirs["3_feature768"], name + ".npy"),
                os.path.join(dirs["2a_f0"], name + ".wav.npy"),
                os.path.join(dirs["2b-f0nsf"], name + ".wav.npy"), "0"]))
    filelist = os.path.join(exp, "filelist.txt")
    with open(filelist, "w") as f:
        f.write("\n".join(rows) + "\n")
    return filelist


def _weight_norm_gains(state: Dict[str, torch.Tensor]) -> None:
    """Each weight norm's g at its v's norm, so the weight is v as drawn."""
    for k in state:
        if k.endswith("weight_g"):
            v = state[k[:-1] + "v"]
            dims = tuple(range(1, v.dim()))
            state[k].copy_(torch.linalg.vector_norm(v, dim=dims, keepdim=True)
                           .reshape(state[k].shape))


def weights_for_training(cfg: Dict, seed: int, device
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """The synthesizer's training layout (enc_q, weight norm) and the
    multi-period discriminator's, in fp32 on `device`."""
    s_g, s_d = subseeds(seed, 10)[8:10]
    config = small_model_config(cfg)
    with torch.device("meta"):
        g_shapes = models._shapes(models.synthesizer_from_config(
            config, cfg["version"], bool(cfg["f0"]), train=True))
        d_shapes = models._shapes(MultiPeriodDiscriminator(cfg["version"]))
    g = weights.random_state(
        g_shapes, s_g, device, lambda k, s: weights.synthesizer_rule(
            k.replace("weight_v", "weight"), s))
    d = weights.random_state(d_shapes, s_d, device)
    _weight_norm_gains(g)
    _weight_norm_gains(d)
    return g, d
