"""Voice-like test audio from the seed: a gliding, vibrato-ed pitch over
syllables, harmonics under a few formants, breath noise and pauses."""

from __future__ import annotations

import numpy as np
import torch


def voice(seconds: float, seed: int, sr: int = 16000,
          with_f0: bool = False, device="cpu"):
    """float32 mono in [-1, 1], `seconds` long at `sr`; with `with_f0`
    also its f0 every 10 ms (Hz, 0 where it is silent).  The contours are
    drawn with numpy at 100 frames a second; the samples are synthesised
    with torch on `device`, in float64."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * sr))
    hop = sr // 100
    frames = n // hop + 2
    tf = np.arange(frames) / 100.0
    knots = max(2, int(seconds) + 2)
    drift = np.interp(tf, np.linspace(0, seconds, knots),
                      rng.uniform(-0.25, 0.25, knots))
    vib = 0.02 * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * tf)
    f0_frames = rng.uniform(95.0, 260.0) * np.exp(drift + vib)
    formants = rng.uniform((500, 1200, 2500), (900, 2000, 3300))
    h = np.arange(1, 13)[:, None]
    gains = 0.25 / h + 0.6 / h * sum(
        np.exp(-((h * f0_frames[None] - fm) / 250.0) ** 2) for fm in formants)
    # syllables of 0.15-0.45 s, with pauses between phrases
    env = np.zeros(n)
    pos = 0
    while pos < n:
        length = int(sr * rng.uniform(0.15, 0.45))
        env[pos: pos + length] = (np.sin(np.pi * np.linspace(0, 1, length))
                                  ** 0.6)[: n - pos]
        pos += length
        if rng.random() < 0.12:
            pos += int(sr * rng.uniform(0.2, 0.6))
    noise = rng.standard_normal(n)

    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    pos_f = torch.arange(n, **f64) / hop            # in frames
    i0 = pos_f.floor().long()
    frac = pos_f - i0

    def at_samples(rows):                           # linear, frame -> sample
        r = torch.as_tensor(rows, **f64)
        return r[..., i0] * (1 - frac) + r[..., i0 + 1] * frac

    f0 = at_samples(f0_frames)
    phase = 2 * np.pi * torch.cumsum(f0, 0) / sr
    x = (at_samples(gains) * torch.sin(torch.as_tensor(h, **f64) * phase)
         ).sum(0)
    e = torch.as_tensor(env, **f64)
    x = x * e + 0.004 * torch.as_tensor(noise, **f64) * (0.3 + e)
    x = 0.6 * x / torch.clamp(x.abs().max(), min=1e-9)
    audio = x.float().cpu().numpy()
    if not with_f0:
        return audio
    voiced = env[np.minimum(np.arange(frames - 1) * hop, n - 1)] > 0.05
    return audio, np.where(voiced, f0_frames[:-1], 0.0).astype(np.float32)


def write_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """16-bit PCM mono."""
    import wave

    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def read_wav(path: str) -> np.ndarray:
    """A 16-bit PCM mono file as float32 (x / 32768), at its own rate."""
    import wave

    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
