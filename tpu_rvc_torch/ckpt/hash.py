"""Model identity hashing (port of tpu_rvc/ckpt/hash.py; reference
infer/modules/vc/hash.py).

A model's hash is a 1024-byte perceptual fingerprint of its seeded
(114514) conversion of a bundled 3 s clip (`assets/lgdsng.npz`, the port's
own copy): the output is normalized, FFT'd, differenced against the
original clip's time and frequency fields, block-averaged into 512
big-endian int16s and base16384-encoded.  `hash_similarity` blends cosine
and exp-distance (hash.py:171); `hash_id` is a 9-byte digest of the hash
(hash.py:198).  `wave_hash`, `hash_similarity` and `hash_id` are numpy and
bit-equal to the JAX package's.

The hash is an identity, so it must not depend on the device: `model_hash`
draws the conversion's noise from a CPU generator and moves it to the
pipeline's device, where torch's CUDA generator would draw other numbers
from the same seed.  It cannot match the JAX hash, whose noise comes from
a JAX PRNG key.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import tempfile
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_rvc_torch.utils.base16384 import decode_from_string, encode_to_string

HALF_HASH_LEN = 512
EXPAND_FACTOR = 65536 * 8
NOISE_SEED = 114514
_ASSET = pathlib.Path(__file__).parent.parent / "assets" / "lgdsng.npz"


@lru_cache(None)
def _storage():
    return np.load(_ASSET)


def original_audio() -> np.ndarray:
    return _storage()["a"]


def original_rmvpe_f0() -> Tuple[np.ndarray, np.ndarray]:
    x = _storage()
    return x["pitch"], x["pitchf"]


def _cut_u16(n: float) -> float:
    if n > 16384:
        n = 16384 + 16384 * (1 - np.exp((16384 - n) / EXPAND_FACTOR))
    elif n < -16384:
        n = -16384 - 16384 * (1 - np.exp((n + 16384) / EXPAND_FACTOR))
    return n


def wave_hash(time_field: np.ndarray) -> str:
    """48000-sample wave -> base16384 fingerprint (reference wave_hash,
    hash.py:66).  Mutates its input like the reference does."""
    np.divide(time_field, np.abs(time_field).max(), time_field)
    if len(time_field) != 48000:
        raise ValueError("time not hashable")
    freq_field = np.fft.fft(time_field)
    np.add(time_field, _storage()["t"], out=time_field)
    freq_field = freq_field + _storage()["f"]
    h = np.zeros(HALF_HASH_LEN, dtype=">i2")
    d = 375 * 512 // HALF_HASH_LEN
    for i in range(HALF_HASH_LEN // 4):
        a, b = i * 2, i * 2 + 1
        x = a + HALF_HASH_LEN // 2
        y = x + 1
        s = np.average(freq_field[i * d:(i + 1) * d])
        h[a] = np.int16(_cut_u16(round(32768 * np.real(s))))
        h[b] = np.int16(_cut_u16(round(32768 * np.imag(s))))
        h[x] = np.int16(_cut_u16(round(
            32768 * np.sum(time_field[i * d: i * d + d // 2]))))
        h[y] = np.int16(_cut_u16(round(
            32768 * np.sum(time_field[i * d + d // 2:(i + 1) * d]))))
    return encode_to_string(h.tobytes())


def model_hash(pipeline, if_f0: int) -> str:
    """Hash a loaded model by converting the bundled clip with the noise
    seed 114514 (reference model_hash, hash.py:94).  `pipeline` is a
    tpu_rvc_torch Pipeline; with f0 the precomputed track is fed
    (if_f0 == 2), as the reference does.  The noise is drawn on the CPU
    whatever the pipeline's device."""
    audio = original_audio().copy()
    pitch, pitchf = original_rmvpe_f0()
    audio_opt = pipeline.pipeline(
        0, audio, [0.0, 0.0, 0.0], 6,
        (pitch, pitchf) if if_f0 else "pm", None, 0.0,
        2 if if_f0 else 0, 3, 16000, 0.25, 0.33, noise_seed=NOISE_SEED,
        noise_device=torch.device("cpu"))
    audio_opt = audio_opt.astype(np.float64)
    diff = 48000 - len(audio_opt)
    if diff > 0:
        audio_opt = np.pad(audio_opt, (diff, 0))
    elif diff < 0:
        n = -(diff // 2)
        audio_opt = audio_opt[n:-n]
    return wave_hash(audio_opt[:48000].astype(np.float64))


def model_hash_ckpt(cpt: dict, hubert=None) -> Optional[str]:
    """Hash a small-model dict through the port's `VC(x_pad=1.0)` (the
    reference hashes under its CPU geometry).  With `hubert` the hash runs
    on its device; without, VC's default HuBERT file on CUDA.  Returns None
    when that cannot run (no HuBERT file, no card), before anything is
    loaded: the hash is optional metadata, as in the JAX package.  Any
    other failure raises."""
    from tpu_rvc_torch.pipeline.vc import VC

    device = None if hubert is None else next(hubert.parameters()).device
    if device is None and not torch.cuda.is_available():
        return None
    vc = VC(x_pad=1.0, device=device)
    if hubert is None and not os.path.exists(vc.hubert_path):
        return None
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "m.pth")
        torch.save(cpt, path)
        meta = vc.get_vc(path, hubert=hubert)
        return model_hash(vc.pipeline, int(meta.get("f0", 1)))


def _extend_difference(n, a, b):
    n = min(max(n, a), b)
    return (n - a) / (b - a)


def hash_similarity(h1: str, h2: str) -> float:
    """Cosine + exp-distance blend in [0, 1] (reference hash.py:171)."""
    h1b, h2b = decode_from_string(h1), decode_from_string(h2)
    if len(h1b) != HALF_HASH_LEN * 2 or len(h2b) != HALF_HASH_LEN * 2:
        raise ValueError("invalid hash length")
    h1n = np.frombuffer(h1b, dtype=">i2")
    h2n = np.frombuffer(h2b, dtype=">i2")
    d = 0.0
    for i in range(HALF_HASH_LEN // 4):
        a, b = i * 2, i * 2 + 1
        ax = complex(h1n[a], h1n[b])
        bx = complex(h2n[a], h2n[b])
        if abs(ax) == 0 or abs(bx) == 0:
            continue
        d += np.abs(ax - bx)
    frac = np.linalg.norm(h1n) * np.linalg.norm(h2n)
    cosine = (np.dot(h1n.astype(np.float32), h2n.astype(np.float32)) / frac
              if frac != 0 else 1.0)
    distance = _extend_difference(np.exp(-d / EXPAND_FACTOR), 0.5, 1.0)
    return round((abs(cosine) + distance) / 2, 6)


def hash_id(h: str) -> str:
    """Short display id derived from a hash (reference hash.py:198)."""
    d = decode_from_string(h)
    if len(d) != HALF_HASH_LEN * 2:
        return "invalid hash length"
    return (encode_to_string(
        np.frombuffer(d, dtype=np.uint64).sum(keepdims=True).tobytes())[:-2]
        + encode_to_string(hashlib.md5(d).digest()[:7]))
