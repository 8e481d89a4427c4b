"""Offline voice-conversion pipeline (port of tpu_rvc/pipeline/vc.py;
reference infer/modules/vc/pipeline.py).

Per utterance:
  1. 48 Hz Butterworth high-pass (host, zero phase)
  2. audio longer than x_max s is split at the quietest sample near every
     x_center-second boundary (searched within +-x_query s)
  3. f0 over the whole reflect-padded signal: pm, RMVPE and FCPE on the
     device; dio, harvest and crepe (salience on the device) decoded on
     the host; or a precomputed track, or a manual curve spliced in
  4. per chunk: HuBERT -> retrieval blend -> 2x time repeat -> protect
     mask -> Synthesizer.infer; the x_pad reflect padding is trimmed
  5. RMS envelope mix and int16 peak scaling (on the device for the single
     chunk path)

Chunk lengths are bucketed to whole seconds, with true lengths driving
the masks, exactly as the JAX graphs are; that keeps the port's output
sample-aligned with the reference package.  The single-chunk path
(`_full`, the JAX `_full_graph`) runs f0, conversion, trimming, RMS mix
and int16 scaling on the device and fetches once; it takes the utterance
only where the JAX package does (`tpu_rvc/pipeline/vc.py:342-344`): no
silence split, no manual curve, and pm, rmvpe or fcpe, or no f0.
`_convert_rows` and `_full_rows` are the two graphs over rows of one
bucket, each row with its own true length, speaker and noise generator:
`parallel/chunks.py` and `parallel/batch.py` run them over a device mesh,
and `VC.vc_single(chunk_parallel=True)` takes the first.  `times`
accumulates [npy, f0, infer] seconds like the reference.  `rmvpe_root`
names the directory of `rmvpe.pt`, which must exist once f0_method="rmvpe"
is asked for; fcpe needs its checkpoint (`f0/fcpe.py`), crepe an
estimator given in `f0_gen._estimators`.
"""

from __future__ import annotations

import functools
import math
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_rvc_torch.audio.dsp import change_rms, highpass_filter
from tpu_rvc_torch.core.device import fp32_math, resolve_device
from tpu_rvc_torch.f0.device import DEVICE_F0, device_f0, pm_f0_device
from tpu_rvc_torch.f0.gen import Generator as F0Generator
from tpu_rvc_torch.ops.resample import linear_interp_1d, resample_poly
from tpu_rvc_torch.retrieval.index import FeatureIndex
from tpu_rvc_torch.retrieval.search import knn_blend
from tpu_rvc_torch.utils.timing import span

SR = 16000
WINDOW = 160  # f0 / feature frame hop at 16 kHz


def _bucket(n: int, step: int = SR) -> int:
    return int(math.ceil(n / step)) * step


def _feat_frames(n16: int) -> int:
    """Feature frames after HuBERT's 320x extractor, doubled by the 2x
    time repeat."""
    return 2 * ((n16 - 400) // 320 + 1)


def silence_chunk_bounds(audio: np.ndarray, t_center: int, t_query: int,
                         t_max: int) -> List[int]:
    """Quietest-sample split points for long audio (reference
    pipeline.py:224-236).  Empty if the audio fits one chunk."""
    opt_ts: List[int] = []
    audio_pad_w = np.pad(audio, (WINDOW // 2, WINDOW // 2), mode="reflect")
    if audio_pad_w.shape[0] > t_max:
        audio_sum = np.zeros_like(audio)
        for i in range(WINDOW):
            audio_sum += np.abs(audio_pad_w[i: i - WINDOW])
        for t in range(t_center, audio.shape[0], t_center):
            win = audio_sum[t - t_query: t + t_query]
            opt_ts.append(t - t_query + int(np.argmin(win)))
    return opt_ts


def chunk_spans(n_pad: int, opt_ts: List[int], t_pad2: int
                ) -> List[Tuple[int, int, slice]]:
    """The chunks of a reflect-padded signal of n_pad samples split at
    `opt_ts` (`silence_chunk_bounds`), as the sequential loop cuts them
    (reference pipeline.py:241-267): (start, length, f0 frame slice) each.
    A chunk reaches t_pad2 + WINDOW past its split point; the last runs to
    the end."""
    spans = []
    s = 0
    for t in opt_ts:
        t = t // WINDOW * WINDOW
        spans.append((s, t + t_pad2 + WINDOW - s,
                      slice(s // WINDOW, (t + t_pad2) // WINDOW)))
        s = t
    spans.append((s, n_pad - s, slice(s // WINDOW, None)))
    return spans


def _device_change_rms(source, sr1: int, target, sr2: int, rate: float):
    """target *= rms(source)^(1-rate) * rms(target)^(rate-1), half-second
    centred frames (reference change_rms, pipeline.py:26)."""
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


def _to_int16(out):
    """Peak scaling to int16 (reference pipeline.py:356-360)."""
    audio_max = out.abs().max() / 0.99
    scale = torch.where(audio_max > 1, 32768.0 / audio_max,
                        torch.full_like(audio_max, 32768.0))
    return torch.clamp(out * scale, -32768, 32767).to(torch.int16)


class Pipeline:
    def __init__(self, tgt_sr: int, *, hubert, synth, version: str = "v2",
                 x_pad: float = 3.0, x_query: float = 10.0,
                 x_center: float = 60.0, x_max: float = 65.0,
                 rmvpe_root: str = "assets/rmvpe",
                 noise_scale: float = 0.66666, deterministic: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.tgt_sr = tgt_sr
        self.version = version
        self.hubert = hubert.to(self.device).eval()
        self.synth = synth.to(self.device).eval()
        # prior noise scale; 0 with deterministic=True (sine noise zeroed
        # too) makes a conversion reproducible for parity checks
        self.noise_scale = float(noise_scale)
        self.deterministic = bool(deterministic)
        self.t_pad = int(SR * x_pad)
        self.t_pad_tgt = int(tgt_sr * x_pad)
        self.t_pad2 = self.t_pad * 2
        self.t_query = int(SR * x_query)
        self.t_center = int(SR * x_center)
        self.t_max = int(SR * x_max)
        self.f0_gen = F0Generator(rmvpe_root, x_pad, window=WINDOW, sr=SR,
                                  device=self.device)
        # the shapes and settings of the last `_full_rows` call, for
        # `last_graph_flops` (no tensor of the call is kept)
        self._last_full_call: Optional[dict] = None

    def last_graph_flops(self) -> Optional[float]:
        """FLOPs of one call of the most recent `_full_rows` graph at that
        call's shapes and settings (rows, length, f0 method, index on or
        off, protect, RMS mix; `utils/roofline.py`), or None before any
        call: the MFU numerator.  It runs the graph once more on zero
        inputs on the pipeline's device, with the kernels counted and not
        launched, drawing its noise from generators of its own."""
        if self._last_full_call is None:
            return None
        from tpu_rvc_torch.utils.roofline import graph_flops

        c = dict(self._last_full_call)
        n, L = c.pop("shape")
        index = c.pop("index")
        zeros = functools.partial(torch.zeros, device=self.device)
        return graph_flops(functools.partial(
            self._full_rows, zeros((n, L)), sids=[0] * n,
            index_arrays=None if index is None else tuple(
                zeros(s) for s in index),
            generators=[self._generator(0) for _ in range(n)], **c))

    # ------------------------------------------------------------------
    def _index_arrays(self, index: Optional[FeatureIndex], index_rate: float):
        if index is None or index_rate <= 0:
            return None
        return index.device_arrays(self.device)

    @torch.no_grad()
    @fp32_math()
    def _convert_rows(self, audio_b, true_len, sids, pitch, pitchf,
                      index_arrays, index_rate: float, protect: float,
                      generators):
        """n bucketed rows -> target-sr float audio (n, frames * hop): the
        JAX `_chunk_graph`, vmapped.  audio_b: (n, bucket) at 16 kHz;
        true_len: (n,) samples; sids: (n,); pitch/pitchf: (n, p_len_static)
        or None; generators: one a row (`Synthesizer.infer`)."""
        n, bucket = audio_b.shape
        use_f0 = pitch is not None
        true_len = torch.as_tensor(true_len, dtype=torch.int64,
                                   device=self.device)
        padding_mask = (torch.arange(bucket, device=self.device)[None]
                        >= true_len[:, None])
        with span("hubert", self.device):
            feats = self.hubert(audio_b, padding_mask)        # (n, F, D)
        feats0 = feats
        if index_arrays is not None:
            with span("retrieval", self.device):
                feats = knn_blend(feats, *index_arrays, index_rate)
        feats = torch.repeat_interleave(feats, 2, dim=1)
        p_len_static = min(bucket // WINDOW, feats.shape[1])
        feats = feats[:, :p_len_static]
        if use_f0 and protect < 0.5:
            feats0 = torch.repeat_interleave(feats0, 2,
                                             dim=1)[:, :p_len_static]
            pitchff = torch.where(pitchf > 0, 1.0, protect)[:, :, None]
            feats = feats * pitchff + feats0 * (1 - pitchff)
        true_frames = torch.clamp(true_len // WINDOW, max=p_len_static)
        out = self.synth.infer(
            feats, true_frames, torch.as_tensor(sids, device=self.device),
            pitch if use_f0 else None, pitchf if use_f0 else None,
            noise_scale=self.noise_scale, deterministic=self.deterministic,
            generator=list(generators))
        return out[:, :, 0]

    @torch.no_grad()
    def _convert(self, audio_b, true_len: int, sid: int, pitch, pitchf,
                 index_arrays, index_rate: float, protect: float,
                 generator: torch.Generator):
        """One bucketed chunk -> target-sr float audio (the JAX
        `_chunk_graph`).  audio_b: (bucket,) at 16 kHz; pitch/pitchf:
        (p_len_static,) or None."""
        use_f0 = pitch is not None
        return self._convert_rows(
            audio_b[None], [true_len], [sid],
            pitch[None] if use_f0 else None,
            pitchf[None] if use_f0 else None, index_arrays, index_rate,
            protect, [generator])[0]

    def _generator(self, seed: int, device=None) -> torch.Generator:
        return torch.Generator(
            device=self.device if device is None else device).manual_seed(
                int(seed))

    @torch.no_grad()
    @fp32_math()
    def _full_rows(self, audio, f0_up_key: float, sids, use_f0: bool,
                   index_arrays, index_rate: float, protect: float,
                   rms_mix_rate: float, generators, f0_method: str):
        """Single-chunk conversion of n padded utterances of one length L
        (the JAX `_full_graph`, vmapped by `parallel/batch.py`): f0 +
        conversion + pad trim + RMS mix + int16, all on the device.
        audio: (n, L), padded up to the 1 s bucket inside -> int16
        (n, samples), each row peak-scaled on its own."""
        n, L = audio.shape
        self._last_full_call = dict(
            shape=(n, L), f0_up_key=f0_up_key, use_f0=use_f0,
            index=None if index_arrays is None else tuple(
                tuple(t.shape) for t in index_arrays),
            index_rate=index_rate, protect=protect,
            rms_mix_rate=rms_mix_rate, f0_method=f0_method)
        bucket = _bucket(L)
        p_len = L // WINDOW
        p_len_static = min(bucket // WINDOW, _feat_frames(bucket))
        true_frames = min(p_len, p_len_static)
        pit = pitf = None
        if use_f0:
            with span("f0", self.device):
                model = (self.f0_gen._get(f0_method).model
                         if f0_method in ("rmvpe", "fcpe") else None)
                pitch, pitchf = device_f0(f0_method, audio, p_len, f0_up_key,
                                          model)
            m = min(p_len, p_len_static)
            pit = F.pad(pitch[:, :m], (0, p_len_static - m))
            pitf = F.pad(pitchf[:, :m], (0, p_len_static - m))
        audio_b = F.pad(audio, (0, bucket - L))
        out = self._convert_rows(audio_b, [L] * n, sids, pit, pitf,
                                 index_arrays, index_rate, protect,
                                 generators)
        out = out[:, : true_frames * self.synth.hop]
        out = out[:, self.t_pad_tgt: out.shape[1] - self.t_pad_tgt]
        src16 = audio[:, self.t_pad: L - self.t_pad]
        return torch.stack([
            _to_int16(_device_change_rms(src16[i], SR, out[i], self.tgt_sr,
                                         rms_mix_rate)) for i in range(n)])

    @torch.no_grad()
    def _full(self, audio, f0_up_key: float, sid: int, use_f0: bool,
              index_arrays, index_rate: float, protect: float,
              rms_mix_rate: float, generator: torch.Generator,
              f0_method: str):
        """`_full_rows` for one utterance: audio (L,) -> int16."""
        return self._full_rows(audio[None], f0_up_key, [sid], use_f0,
                               index_arrays, index_rate, protect,
                               rms_mix_rate, [generator], f0_method)[0]

    # ------------------------------------------------------------------
    @torch.no_grad()
    @fp32_math()
    def vc_chunk(self, audio_chunk, sid: int, pitch, pitchf,
                 index: Optional[FeatureIndex], index_rate: float,
                 protect: float, times: List[float], noise_seed: int = 0,
                 noise_device=None):
        """Convert one 16 kHz chunk (tensor on the device) -> target-sr
        float audio on the device, trimmed to its true frame count."""
        L = int(audio_chunk.shape[0])
        bucket = _bucket(L)
        audio_b = F.pad(audio_chunk, (0, bucket - L))
        p_len_static = min(bucket // WINDOW, _feat_frames(bucket))
        pit = pitf = None
        if pitch is not None:
            n = min(p_len_static, int(pitch.shape[0]))
            pit = torch.zeros(p_len_static, dtype=torch.int32,
                              device=self.device)
            pitf = torch.zeros(p_len_static, dtype=torch.float32,
                               device=self.device)
            pit[:n], pitf[:n] = pitch[:n], pitchf[:n]
        t0 = time.time()
        out = self._convert(audio_b, L, sid, pit, pitf,
                            self._index_arrays(index, index_rate),
                            index_rate, protect,
                            self._generator(noise_seed, noise_device))
        times[2] += time.time() - t0
        true_frames = min(L // WINDOW, p_len_static)
        return out[: true_frames * self.synth.hop]

    # ------------------------------------------------------------------
    @torch.no_grad()
    @fp32_math()
    def pipeline(self, sid: int, audio: np.ndarray, times: List[float],
                 f0_up_key: float, f0_method: str,
                 index: Optional[FeatureIndex], index_rate: float,
                 if_f0: int, filter_radius, resample_sr: int,
                 rms_mix_rate: float, protect: float, f0_file=None,
                 noise_seed: int = 0, noise_device=None) -> np.ndarray:
        """Full conversion (reference pipeline, pipeline.py:186) -> int16.
        if_f0 == 2 takes a precomputed track: `f0_method` is then the
        (coarse pitch, f0) pair, trimmed to the padded input's frames.
        f0_file: a manual curve, (n, 2) rows of (seconds, Hz).
        noise_device: where the seeded noise is drawn (default the
        pipeline's device); the draws move to the device, so a CPU
        generator gives one conversion on any card (ckpt/hash.py)."""
        use_f0 = bool(if_f0)
        with span("split"):
            audio = highpass_filter(np.asarray(audio, np.float32))
            opt_ts = silence_chunk_bounds(audio, self.t_center, self.t_query,
                                          self.t_max)
            audio_pad = np.pad(audio, (self.t_pad, self.t_pad),
                               mode="reflect")
        index_arrays = self._index_arrays(index, index_rate)

        if not opt_ts and f0_file is None and (
                if_f0 == 0 or (if_f0 == 1 and f0_method in DEVICE_F0)):
            # bucket to the 1 s grid; the tail is reflect-extended so the
            # RMS envelope and int16 peak see audio-like samples, and the
            # output is trimmed back to the true length
            L_true = audio_pad.shape[0]
            L = _bucket(L_true)
            if L != L_true:
                extra = L - L_true
                with span("split"):
                    audio_pad = np.pad(audio_pad, (0, extra), mode=(
                        "reflect" if extra < L_true else "constant"))
            t0 = time.time()
            with span("upload"):
                audio_dev = torch.as_tensor(audio_pad, device=self.device)
            out = self._full(audio_dev, float(f0_up_key), sid, use_f0,
                             index_arrays, index_rate, protect, rms_mix_rate,
                             self._generator(noise_seed, noise_device),
                             f0_method)
            if L != L_true:
                p_len_static = min(L // WINDOW, _feat_frames(L))
                n_true = (min(L_true // WINDOW, p_len_static) * self.synth.hop
                          - 2 * self.t_pad_tgt)
                out = out[:n_true]
            if self.tgt_sr != resample_sr and resample_sr >= SR:
                out = resample_poly(out.float()[None] / 32768.0,
                                    self.tgt_sr, resample_sr)[0]
                out = torch.clamp(out * 32768.0, -32768, 32767).to(torch.int16)
            with span("fetch"):
                result = out.cpu().numpy()  # the one device->host fetch
            times[2] += time.time() - t0
            return result

        with span("upload"):
            audio_pad_dev = torch.as_tensor(audio_pad, device=self.device)
        p_len = audio_pad.shape[0] // WINDOW
        pitch = pitchf = None
        if use_f0:
            t0 = time.time()
            with span("f0", self.device):
                if if_f0 == 2:   # the track itself (reference :268)
                    c, f = f0_method
                elif f0_method == "pm" and f0_file is None:
                    Lb = _bucket(audio_pad.shape[0])
                    pitch, pitchf = pm_f0_device(
                        F.pad(audio_pad_dev, (0, Lb - audio_pad.shape[0])),
                        Lb // WINDOW, float(f0_up_key))
                else:  # the estimator, its decode and the splice in numpy
                    c, f = self.f0_gen.calculate(
                        audio_pad, p_len, f0_up_key, f0_method, filter_radius,
                        f0_file)
                if pitch is None:
                    pitch = torch.as_tensor(np.asarray(c, np.int32),
                                            device=self.device)
                    pitchf = torch.as_tensor(np.asarray(f, np.float32),
                                             device=self.device)
            pitch, pitchf = pitch[:p_len], pitchf[:p_len]
            times[1] += time.time() - t0

        audio_opt = []
        for start, n, sl in chunk_spans(audio_pad.shape[0], opt_ts,
                                        self.t_pad2):
            out = self.vc_chunk(audio_pad_dev[start: start + n], sid,
                                pitch[sl] if use_f0 else None,
                                pitchf[sl] if use_f0 else None, index,
                                index_rate, protect, times, noise_seed,
                                noise_device)
            audio_opt.append(out[self.t_pad_tgt: out.shape[0]
                                 - self.t_pad_tgt])
        with span("fetch"):
            result = torch.cat(audio_opt).cpu().numpy()
        with span("assemble"):
            return self.finish(result, audio, rms_mix_rate, resample_sr)

    def finish(self, result: np.ndarray, audio16: np.ndarray,
               rms_mix_rate: float, resample_sr: int) -> np.ndarray:
        """The joined chunks' last steps, as the sequential path and
        `parallel/chunks.py` take them (reference pipeline.py:295-300,
        356-360): the RMS envelope of the high-passed 16 kHz input
        `audio16` mixed in on the host, resampling on the device, peak
        scaling to int16."""
        if rms_mix_rate != 1:
            result = change_rms(audio16, SR, result, self.tgt_sr,
                                rms_mix_rate)
        if self.tgt_sr != resample_sr and resample_sr >= SR:
            result = resample_poly(
                torch.as_tensor(result[None], device=self.device),
                self.tgt_sr, resample_sr)[0]
            with span("fetch"):
                result = result.cpu().numpy()
        audio_max = np.abs(result).max() / 0.99
        max_int16 = 32768.0
        if audio_max > 1:
            max_int16 /= audio_max
        return (result * max_int16).astype(np.int16)


class VC:
    """Model-lifecycle facade (reference infer/modules/vc/modules.py:18).
    hubert_path="random" builds a random-weight HuBERT-base (no assets)."""

    def __init__(self, rmvpe_root: str = "assets/rmvpe",
                 hubert_path: str = "assets/hubert/hubert_base.pt",
                 x_pad: float = 3.0, device=None):
        self.device = resolve_device(device)
        self.rmvpe_root = rmvpe_root
        self.hubert_path = hubert_path
        self.x_pad = x_pad
        self.pipeline: Optional[Pipeline] = None
        self.tgt_sr: Optional[int] = None
        self.version: Optional[str] = None
        self.if_f0 = 1
        self.n_spk: Optional[int] = None
        self._hubert = None

    def get_vc(self, model_path: str, hubert=None):
        """Load a small model and (once) HuBERT; build the pipeline
        (reference VC.get_vc, modules.py:32)."""
        from tpu_rvc_torch.models.loader import load_synthesizer

        synth, meta = load_synthesizer(model_path, self.device)
        self.tgt_sr = synth.sr
        self.version = meta.get("version", "v1")
        self.if_f0 = int(meta.get("f0", 1))
        self.n_spk = synth.spk_embed_dim
        if hubert is None:
            if self._hubert is None:
                if self.hubert_path == "random":
                    from tpu_rvc_torch.models.hubert import hubert_for_version
                    self._hubert = hubert_for_version(self.version,
                                                      self.device)
                else:
                    from tpu_rvc_torch.ckpt.hubert_loader import \
                        load_hubert_base
                    self._hubert = load_hubert_base(self.hubert_path,
                                                    self.version, self.device)
            hubert = self._hubert
        self.pipeline = Pipeline(self.tgt_sr, hubert=hubert, synth=synth,
                                 version=self.version, x_pad=self.x_pad,
                                 rmvpe_root=self.rmvpe_root,
                                 device=self.device)
        return meta

    def vc_single(self, sid: int, input_audio_path: str, f0_up_key: int = 0,
                  f0_method: str = "rmvpe",
                  index: Optional[FeatureIndex] = None,
                  index_rate: float = 0.75, filter_radius: int = 3,
                  resample_sr: int = 0, rms_mix_rate: float = 0.25,
                  protect: float = 0.33, f0_file=None,
                  chunk_parallel: bool = False):
        """Convert one file (reference vc_single, modules.py:117) ->
        (info, (sr, int16 audio)).  chunk_parallel=True converts a long
        file's silence-split chunks as rows of one batch, split over every
        visible card (`parallel/chunks.py` `convert_long`; on a CPU
        pipeline one CPU shard); with an `f0_file` the sequential path
        runs, as in the JAX package."""
        from tpu_rvc_torch.audio.io import load_audio

        if self.pipeline is None:
            raise RuntimeError("call get_vc first")
        with span("call", root=True):
            with span("load"):
                audio = load_audio(input_audio_path, SR)
                if len(audio) == 0:
                    raise ValueError(f"{input_audio_path}: empty audio")
                audio_max = np.abs(audio).max() / 0.95
                if audio_max > 1:
                    audio = audio / audio_max
            times = [0.0, 0.0, 0.0]
            if chunk_parallel and f0_file is None:
                from tpu_rvc_torch.core.mesh import make_mesh
                from tpu_rvc_torch.parallel.chunks import convert_long
                mesh = (make_mesh() if self.device.type == "cuda"
                        else make_mesh(devices=[self.device]))
                t0 = time.time()
                out = convert_long(
                    self.pipeline, sid, audio, mesh, f0_up_key=f0_up_key,
                    f0_method=f0_method, index=index, index_rate=index_rate,
                    if_f0=self.if_f0, filter_radius=filter_radius,
                    resample_sr=resample_sr, rms_mix_rate=rms_mix_rate,
                    protect=protect)
                times[2] += time.time() - t0
            else:
                out = self.pipeline.pipeline(
                    sid, audio, times, f0_up_key, f0_method, index, index_rate,
                    self.if_f0, filter_radius, resample_sr, rms_mix_rate,
                    protect, f0_file)
        tgt = (resample_sr if self.tgt_sr != resample_sr and
               resample_sr >= SR else self.tgt_sr)
        info = (f"npy: {times[0]:.2f}s, f0: {times[1]:.2f}s, "
                f"infer: {times[2]:.2f}s")
        return info, (tgt, out)

    def vc_multi(self, sid: int, paths: List[str], out_dir: str, **kwargs):
        """Convert several files into out_dir/<name>.wav (reference
        vc_multi, modules.py:201); one result line per input, in order.
        `kwargs` go to `vc_single`, `chunk_parallel` among them."""
        from tpu_rvc_torch.audio.io import save_wav

        os.makedirs(out_dir, exist_ok=True)
        infos = []
        for path in paths:
            base = os.path.basename(path)
            try:
                info, (sr, audio) = self.vc_single(sid, path, **kwargs)
                save_wav(os.path.join(out_dir, f"{base}.wav"), audio, sr)
                infos.append(f"{base} -> Success ({info})")
            except Exception as e:  # attribute the failure to its input
                infos.append(f"{path} -> {e}")
        return "\n".join(infos)
