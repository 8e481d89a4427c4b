"""Voice conversion through ONNX graphs (port of
tpu_rvc/pipeline/onnx_infer.py; reference rvc/onnx/infer.py).

The reference runs an exported synthesizer and a ContentVec encoder
through onnxruntime (infer.py:11-25, 49-62).  Here both graphs run on the
port's executor (`models/onnx_exec.py`) on one device, CUDA unless the
caller names another.  The graphs that `ckpt/torch2onnx.py` and
`tpu_rvc.ckpt.jax2onnx` write are static: the features are padded to the
graph's frame count and the output is trimmed, as the JAX package does.
The prior noise `rnd` comes from `np.random.default_rng(seed)`, as in the
JAX package, so both packages convert with the same noise.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.core.device import resolve_device
from tpu_rvc_torch.models.onnx_exec import OnnxModule


def _static(dim, what: str) -> int:
    if not isinstance(dim, int):
        raise ValueError(f"{what}: the graph declares a dynamic axis "
                         f"({dim!r}); export it with static shapes")
    return dim


class ContentVec:
    """HuBERT/ContentVec features from an ONNX graph (reference
    rvc/onnx/infer.py:28-46): 16 kHz mono -> (1, frames, C) on the
    device."""

    def __init__(self, vec_path: str, device=None):
        self.device = resolve_device(device)
        self.model = OnnxModule.from_file(vec_path, self.device)
        info = self.model.graph.input_info.get(self.model.graph.inputs[0])
        self.shape = info[1] if info else None

    def __call__(self, wav: np.ndarray) -> torch.Tensor:
        if wav.ndim == 2:  # stereo -> mono (reference infer.py:40)
            wav = wav.mean(-1)
        n = len(wav)
        t_model = (self.shape[-1] if self.shape is not None
                   and isinstance(self.shape[-1], int) else None)
        if t_model is not None and n < t_model:
            wav = np.pad(wav, (0, t_model - n))
        elif t_model is not None:
            wav = wav[:t_model]
        feats = self.model(wav.reshape(1, -1).astype(np.float32))
        return feats[None] if feats.dim() == 2 else feats


class OnnxRVC:
    """End-to-end conversion through exported ONNX graphs (reference
    rvc/onnx/infer.py:49 `RVC`)."""

    def __init__(self, model_path: str, hop_len: int = 512,
                 model_sr: int = 40000, vec_path: Optional[str] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = OnnxModule.from_file(model_path, self.device)
        self.hop_len = hop_len
        self.model_sr = model_sr
        self.vec = (ContentVec(vec_path, self.device)
                    if vec_path and os.path.exists(vec_path) else None)
        info = self.model.graph.input_info
        self.t_model = (_static(info["phone"][1][1], "phone")
                        if "phone" in info else None)
        self.inter = (_static(info["rnd"][1][-1], "rnd") if "rnd" in info
                      else 192)
        # speaker-mix graphs declare ds float (1, T, n_speakers)
        ds_info = info.get("ds")
        self.spk_mix = bool(ds_info and len(ds_info[1]) == 3)
        self.n_speakers = int(ds_info[1][-1]) if self.spk_mix else None
        self.use_f0 = "pitch" in self.model.graph.inputs

    def _tensor(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=dtype, device=self.device)

    def forward(self, hubert, hubert_length, pitch, pitchf, ds, rnd):
        """The graph itself -> int16 audio, numpy (reference
        infer.py:97-118 scales by 32767)."""
        args = [self._tensor(hubert, torch.float32),
                self._tensor([int(hubert_length)], torch.int64)]
        if self.use_f0:
            args += [self._tensor(pitch, torch.int64),
                     self._tensor(pitchf, torch.float32)]
        args += [self._tensor(ds, torch.float32 if self.spk_mix
                              else torch.int64),
                 self._tensor(rnd, torch.float32)]
        out = self.model(*args)
        return (out.reshape(-1) * 32767).to(torch.int16).cpu().numpy()

    def infer(self, wav: np.ndarray, wav_sr: int, sid=0,
              f0_method: str = "dio", f0_up_key: int = 0,
              seed: int = 0) -> np.ndarray:
        """Convert `wav` (reference infer.py:63-95): resample to 16 kHz,
        ContentVec features repeated 2x in time, f0 at the model's hop,
        `rnd` from `seed`, the graph -> int16 at the model's rate."""
        from scipy.signal import resample_poly

        from tpu_rvc_torch.f0.gen import Generator

        org_length = len(wav)
        if org_length / wav_sr > 50.0:
            raise RuntimeError("wav max length exceeded")
        if self.vec is None:
            raise RuntimeError("no ContentVec ONNX model configured")
        wav16 = wav.astype(np.float32)
        if wav_sr != 16000:
            g = math.gcd(wav_sr, 16000)
            wav16 = resample_poly(wav16, 16000 // g, wav_sr // g).astype(
                np.float32)
        feats = torch.repeat_interleave(self.vec(wav16), 2, dim=1)
        t = feats.shape[1]
        if self.t_model is not None:
            if t < self.t_model:
                feats = F.pad(feats, (0, 0, 0, self.t_model - t))
            else:
                feats = feats[:, :self.t_model]
                t = self.t_model
        hubert_length = feats.shape[1]

        pitch = pitchf = None
        if self.use_f0:
            gen = Generator(window=self.hop_len, sr=self.model_sr,
                            device=self.device)
            pitch, pitchf = gen.calculate(wav.astype(np.float32),
                                          hubert_length, f0_up_key,
                                          f0_method, None)
            pitch = pitch.reshape(1, -1)[:, :hubert_length]
            pitchf = pitchf.reshape(1, -1)[:, :hubert_length].astype(
                np.float32)
            if pitch.shape[1] < hubert_length:
                pad = hubert_length - pitch.shape[1]
                pitch = np.pad(pitch, ((0, 0), (0, pad)))
                pitchf = np.pad(pitchf, ((0, 0), (0, pad)))

        rnd = np.random.default_rng(seed).standard_normal(
            (1, hubert_length, self.inter)).astype(np.float32)
        if self.spk_mix:
            # an int (one speaker), a (n_speakers,) static mix, or a
            # (T, n_speakers) trajectory
            if np.isscalar(sid) or np.ndim(sid) == 0:
                ds = np.zeros((1, hubert_length, self.n_speakers), np.float32)
                ds[:, :, int(sid)] = 1.0
            else:
                sid = np.asarray(sid, np.float32)
                if sid.ndim == 1:
                    ds = np.broadcast_to(
                        sid, (1, hubert_length, self.n_speakers)).copy()
                else:
                    ds = sid[None, :hubert_length]
                    if ds.shape[1] < hubert_length:
                        ds = np.pad(ds, ((0, 0), (0, hubert_length
                                                  - ds.shape[1]), (0, 0)),
                                    mode="edge")
        else:
            ds = np.asarray([sid], np.int64)

        out = self.forward(feats, hubert_length, pitch, pitchf, ds, rnd)
        out = np.pad(out, (0, 2 * self.hop_len))
        n_out = int(round(org_length / wav_sr * self.model_sr))
        # valid samples: the true (unpadded) frames times samples a frame
        valid = t * (out.shape[0] // max(hubert_length, 1))
        return out[:min(n_out, valid)]
