"""Song-like stereo test audio from the seed: a voice (`voices.voice`)
over an accompaniment of chords of harmonic tones and noise bursts on the
beat, each part panned to its own place between the channels."""

from __future__ import annotations

import math

import numpy as np
import torch

from . import voices


def _pan(rng) -> np.ndarray:
    """Constant-power gains (left, right) of a place drawn in [-0.8, 0.8]."""
    a = (rng.uniform(-0.8, 0.8) + 1.0) * math.pi / 4
    return np.array([math.cos(a), math.sin(a)])


def song(seconds: float, seed: int, sr: int = 44100, device="cpu"
         ) -> np.ndarray:
    """(T, 2) float32 in [-1, 1], `seconds` long at `sr`: the parts drawn
    with numpy a beat at a time, the samples synthesised with torch on
    `device` in float64."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * sr))
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    vox = torch.as_tensor(voices.voice(seconds, int(rng.integers(2 ** 62)),
                                       sr, device=dev), **f64)
    beat = int(sr * 60.0 / rng.uniform(80.0, 140.0))
    beats = -(-n // beat)
    t = torch.arange(n, **f64)
    k = (t // beat).long()                        # each sample's beat
    since = (t - k * beat) / sr                   # seconds since its onset
    # three chord tones a bar of four beats, from a minor pentatonic scale
    root = rng.uniform(98.0, 147.0)
    scale = root * 2.0 ** (np.array([0, 3, 5, 7, 10, 12, 15, 17]) / 12.0)
    bars = -(-beats // 4)
    notes = scale[rng.integers(len(scale), size=(bars, 3))]
    out = torch.zeros((2, n), **f64)
    h = torch.arange(1, 7, **f64)[:, None]        # six harmonics
    for j in range(3):
        f = torch.as_tensor(notes[:, j], **f64)[k // 4]
        phase = 2 * math.pi * torch.cumsum(f, 0) / sr
        tone = (torch.sin(h * phase) / h ** 1.5).sum(0)
        env = 0.35 + 0.65 * torch.exp(-since / rng.uniform(0.2, 0.6))
        out += torch.as_tensor(_pan(rng), **f64)[:, None] * 0.12 * tone * env
    # a noise burst on every beat, a longer one on the off-beats
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2 ** 62)))
    noise = torch.randn(n, generator=gen, **f64)
    tau = torch.as_tensor(np.where(np.arange(beats) % 2 == 1, 0.08, 0.025),
                          **f64)[k]
    burst = noise * torch.exp(-since / tau) * 0.15
    out += torch.as_tensor(_pan(rng), **f64)[:, None] * burst
    out += torch.as_tensor(_pan(rng) * 0.5 + 0.35, **f64)[:, None] * vox
    out = 0.8 * out / torch.clamp(out.abs().max(), min=1e-9)
    return out.T.float().cpu().numpy()


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """(T, 2) float32 as 16-bit PCM stereo."""
    import wave

    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
