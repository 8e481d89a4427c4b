"""WAV I/O (port of tpu_rvc/audio/io.py): a RIFF reader for PCM 8/16/24/32
and IEEE-float WAV, a 16-bit PCM writer on the stdlib `wave` module, and
host resampling with scipy."""

from __future__ import annotations

import math
import os
import struct
import wave
from typing import Tuple

import numpy as np


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV as float32 (channels averaged) -> (audio, sr)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            payload = f.read(size + (size & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload[:size]
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 3:
        x = np.frombuffer(data, dtype=np.float32 if bits == 32
                          else np.float64).astype(np.float32)
    elif audio_format in (1, 0xFFFE):
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype="u1").astype(np.float32) - 128) / 128.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype="u1").reshape(-1, 3).astype(np.int32)
            x = raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
            x = (x - ((x & 0x800000) << 1)).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bits {bits}")
    else:
        raise ValueError(f"unsupported WAV format {audio_format}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


def save_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Write float32 in [-1, 1] or int16 audio as 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.dtype != np.int16:
        audio = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if audio.ndim == 1 else audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(audio.tobytes())


def load_audio(path: str, sr: int) -> np.ndarray:
    """Decode a WAV file to mono float32 at `sr`."""
    path = str(path).strip().strip('"').strip("\n")
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    x, file_sr = load_wav(path)
    if file_sr == sr:
        return x
    from scipy.signal import resample_poly
    g = math.gcd(file_sr, sr)
    return resample_poly(x, sr // g, file_sr // g).astype(np.float32)
