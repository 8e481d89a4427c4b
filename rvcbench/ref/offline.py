"""The offline conversion written out again: `VC.vc_single` for a file
that fits one chunk (no silence split), with the defaults the WebUI
passes: RMVPE, the retrieval blend, protect, the RMS mix and the int16
peak scaling.  The steps are those of the port's single-chunk path
(tpu_rvc_torch/pipeline/vc.py `pipeline` and `_full_rows`): the 48 Hz
high-pass on the host, 3 s reflect padding, a 1 s bucket, f0 over the
padded signal, HuBERT, the blend, the 2x repeat, the synthesizer, the pad
trim, the RMS envelope mix and the peak scaling."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .dsp import highpass_filter
from .f0_device import rmvpe_f0_device
from .resample import linear_interp_1d
from .search import knn_blend

SR = 16000
WINDOW = 160


def bucket(n: int) -> int:
    return int(math.ceil(n / SR)) * SR


def feat_frames(n16: int) -> int:
    return 2 * ((n16 - 400) // 320 + 1)


def change_rms(source, sr1: int, target, sr2: int, rate: float):
    """target *= rms(source)^(1-rate) * rms(target)^(rate-1), half-second
    centred frames (reference pipeline.py:26)."""
    if rate >= 1.0:
        return target

    def frame_rms(y, sr):
        frame, hop = sr // 2 * 2, sr // 2
        yp = F.pad(y, (frame // 2, frame // 2))
        return torch.sqrt(torch.mean(yp.unfold(0, frame, hop) ** 2, dim=1))

    n = target.shape[0]
    rms1 = linear_interp_1d(frame_rms(source, sr1), n)
    rms2 = torch.clamp(linear_interp_1d(frame_rms(target, sr2), n), min=1e-6)
    return target * torch.pow(rms1, 1.0 - rate) * torch.pow(rms2, rate - 1.0)


def to_int16(out):
    audio_max = out.abs().max() / 0.99
    scale = torch.where(audio_max > 1, 32768.0 / audio_max,
                        torch.full_like(audio_max, 32768.0))
    return torch.clamp(out * scale, -32768, 32767).to(torch.int16)


class Offline:
    """hubert, synth, rmvpe: the reference's networks (`models.py`);
    index: (vectors, squared norms) on the device, or None."""

    def __init__(self, hubert, synth, rmvpe, index, device, x_pad=3.0,
                 noise_scale=0.66666):
        self.hubert, self.synth, self.rmvpe = hubert, synth, rmvpe
        self.index = index
        self.device = torch.device(device)
        self.tgt_sr = synth.sr
        self.hop = synth.hop
        self.t_pad = int(SR * x_pad)
        self.t_pad_tgt = int(self.tgt_sr * x_pad)
        self.noise_scale = noise_scale

    def pad(self, audio: np.ndarray):
        """The input as read -> (the bucketed padded signal, its true
        length, the high-passed audio)."""
        audio = np.asarray(audio, np.float32)
        audio_max = np.abs(audio).max() / 0.95
        if audio_max > 1:
            audio = audio / audio_max
        audio = highpass_filter(audio)
        audio_pad = np.pad(audio, (self.t_pad, self.t_pad), mode="reflect")
        L_true = audio_pad.shape[0]
        L = bucket(L_true)
        if L != L_true:
            extra = L - L_true
            audio_pad = np.pad(audio_pad, (0, extra), mode=(
                "reflect" if extra < L_true else "constant"))
        return audio_pad, L_true

    @torch.no_grad()
    def f0(self, audio, f0_up_key=0.0, f0_net: bool = True):
        """(coarse pitch, f0) of the padded signal (n, L), cut or padded
        to the synthesizer's frames; `f0_net=False` gives a constant track
        (the count of a path whose f0 has no products, pm)."""
        n, L = audio.shape
        p_len = L // WINDOW
        p_len_static = min(L // WINDOW, feat_frames(L))
        m = min(p_len, p_len_static)
        if f0_net:
            pitch, pitchf = rmvpe_f0_device(audio, p_len, f0_up_key,
                                            self.rmvpe)
        else:
            pitch = torch.ones((n, p_len), dtype=torch.int32,
                               device=audio.device)
            pitchf = torch.ones((n, p_len), device=audio.device)
        return (F.pad(pitch[:, :m], (0, p_len_static - m)),
                F.pad(pitchf[:, :m], (0, p_len_static - m)))

    @torch.no_grad()
    def rows(self, audio, f0=None, f0_up_key=0.0, index_rate=0.75,
             protect=0.33, rms_mix_rate=0.25, generator=None,
             use_f0_net=True):
        """The device graph over (1, L) -> int16 (samples,).  `f0`: the
        (pitch, pitchf) track to follow, else this reference's own."""
        n, L = audio.shape
        p_len = L // WINDOW
        p_len_static = min(L // WINDOW, feat_frames(L))
        true_frames = min(p_len, p_len_static)
        pitch, pitchf = (self.f0(audio, f0_up_key, use_f0_net) if f0 is None
                         else f0)
        mask = torch.zeros((n, L), dtype=torch.bool, device=audio.device)
        feats = self.hubert(audio, mask)
        feats0 = feats
        if self.index is not None and index_rate > 0:
            feats = knn_blend(feats, *self.index, index_rate)
        feats = torch.repeat_interleave(feats, 2, dim=1)[:, :p_len_static]
        if protect < 0.5:
            feats0 = torch.repeat_interleave(feats0, 2,
                                             dim=1)[:, :p_len_static]
            pitchff = torch.where(pitchf > 0, 1.0, protect)[:, :, None]
            feats = feats * pitchff + feats0 * (1 - pitchff)
        lengths = torch.full((n,), true_frames, dtype=torch.int64,
                             device=audio.device)
        out = self.synth.infer(
            feats, lengths, torch.zeros(n, dtype=torch.int64,
                                        device=audio.device),
            pitch, pitchf, noise_scale=self.noise_scale,
            generator=generator)[:, :, 0]
        out = out[:, : true_frames * self.hop]
        out = out[:, self.t_pad_tgt: out.shape[1] - self.t_pad_tgt]
        src16 = audio[:, self.t_pad: L - self.t_pad]
        return to_int16(change_rms(src16[0], SR, out[0], self.tgt_sr,
                                   rms_mix_rate))

    @torch.no_grad()
    def convert(self, audio: np.ndarray, noise_seed: int = 0, f0=None,
                **kw):
        """A file's samples as read at 16 kHz -> (int16 at the model's
        rate, the f0 track it followed): the noise from a generator seeded
        with `noise_seed` on the device, as `vc_single` draws it; `f0`
        (pitch, pitchf), if given, in place of this reference's own."""
        audio_pad, L_true = self.pad(audio)
        L = audio_pad.shape[0]
        x = torch.as_tensor(audio_pad, device=self.device)[None]
        if f0 is None:
            f0 = self.f0(x, kw.get("f0_up_key", 0.0))
        gen = [torch.Generator(device=self.device).manual_seed(noise_seed)]
        out = self.rows(x, f0=tuple(t.to(self.device) for t in f0),
                        generator=gen, **kw)
        if L != L_true:
            p_len_static = min(L // WINDOW, feat_frames(L))
            n_true = (min(L_true // WINDOW, p_len_static) * self.hop
                      - 2 * self.t_pad_tgt)
            out = out[:n_true]
        return out.cpu().numpy(), f0
