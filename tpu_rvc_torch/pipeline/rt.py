"""Realtime voice conversion, one stream (port of tpu_rvc/pipeline/rt.py;
reference infer/lib/rtrvc.py:19 `RVC` and the gui.py stream loop math).

RealtimeVC: the per-block model engine (rtrvc.RVC role).
  - persistent HuBERT and synthesizer on the device, 1024-frame pitch
    caches shifted by one block per call (rtrvc.py:209-217)
  - f0 on the tail only (for RMVPE on the reference's 5120-sample grid)
  - retrieval applied to the tail only (rtrvc.py:168-185)
  - formant shift through return_length2 and a polyphase resample of the
    output (rtrvc.py:190, 249-259)
  - per block: HuBERT on the whole window, enc_p on the whole window, the
    flow on the tail plus a 24-frame pre-roll, the decoder on the tail.

StreamSession: the block loop (gui.py:934-1126 math, no audio device):
  rolling input windows, 16 kHz resample, the engine, RMS mix, SOLA
  alignment (normalised cross-correlation, gui.py:1058-1073) and crossfade
  or phase-vocoder merge (gui.py:27-48).  Blocks in, aligned blocks out.

FusedStreamGraph: the same block with its rolling state (16 kHz window,
pitch caches) on the device: one upload of the fresh segment, every stage
queued without waiting for the device, one fetch.

Spectral-gate noise reduction, the multi-stream engine and the per-stream
`fed` mask are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from tpu_rvc_torch.audio.dsp import _interp_to, rms_envelope
from tpu_rvc_torch.core.device import fp32_math, resolve_device
from tpu_rvc_torch.f0.device import pm_f0_device, rmvpe_f0_device
from tpu_rvc_torch.f0.gen import Generator as F0Generator
from tpu_rvc_torch.ops.resample import resample_poly
from tpu_rvc_torch.retrieval.index import FeatureIndex
from tpu_rvc_torch.retrieval.search import knn_blend
from tpu_rvc_torch.utils.timing import span

SR = 16000
WINDOW = 160
CACHE_FRAMES = 1024
RMVPE_GRID = 5120  # the reference pads the rmvpe tail to this grid


def f0_tail_samples(block_frame_16k: int, f0method: str) -> int:
    """16 kHz samples at the window's end that f0 runs on: the block plus
    800 of context, for RMVPE raised to the 5120-sample grid less one hop
    (rtrvc.py:199-204)."""
    n = block_frame_16k + 800
    if f0method == "rmvpe":
        n = RMVPE_GRID * ((n - 1) // RMVPE_GRID + 1) - WINDOW
    return n


class RealtimeVC:
    def __init__(self, *, hubert, synth, version: str = "v2", if_f0: int = 1,
                 index: Optional[FeatureIndex] = None,
                 index_rate: float = 0.0, f0_up_key: float = 0.0,
                 formant_shift: float = 0.0,
                 rmvpe_root: str = "assets/rmvpe",
                 noise_scale: float = 0.66666, deterministic: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.hubert = hubert.to(self.device).eval()
        self.synth = synth.to(self.device).eval()
        self.version = version
        self.if_f0 = if_f0
        self.index = index
        self.index_rate = index_rate
        self.f0_up_key = f0_up_key
        self.formant_shift = formant_shift
        self.tgt_sr = synth.sr
        # prior noise scale; 0 with deterministic=True (sine noise zeroed
        # too) makes a stream reproducible for parity checks
        self.noise_scale = float(noise_scale)
        self.deterministic = bool(deterministic)
        self.cache_pitch = np.zeros(CACHE_FRAMES, np.int32)
        self.cache_pitchf = np.zeros(CACHE_FRAMES, np.float32)
        self.f0_gen = F0Generator(rmvpe_root, x_pad=0, window=WINDOW, sr=SR,
                                  device=self.device)
        self._sid = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._lengths: Dict[int, torch.Tensor] = {}
        self._step = 0

    def set_key(self, key):          # reference rtrvc.py:122
        self.f0_up_key = key

    def set_formant(self, formant):  # reference rtrvc.py:125
        self.formant_shift = formant

    def set_index_rate(self, rate):  # reference rtrvc.py:128
        self.index_rate = rate

    def index_arrays(self):
        """The index on the device, or None when retrieval is off."""
        if self.index is None or self.index_rate <= 0:
            return None
        return self.index.device_arrays(self.device)

    def _length_tensor(self, p_len: int) -> torch.Tensor:
        # made once per window length: a fresh host-to-device copy in every
        # block would make the host wait for the device mid-block
        if p_len not in self._lengths:
            self._lengths[p_len] = torch.full(
                (1,), p_len, dtype=torch.int64, device=self.device)
        return self._lengths[p_len]

    def convert_window(self, wav16: torch.Tensor, pitch, pitchf,
                       skip_head: int, return_length: int,
                       return_length2: int, protect: float,
                       step: int) -> torch.Tensor:
        """One rolling window on the device -> the tail's audio at the
        model's rate, (return_length2 * hop,).  wav16: (L16,); pitch /
        pitchf: (L16 // 160,) or None.  The prior and source noise come
        from a generator seeded with `step`.  Queues work only: nothing
        here waits for the device."""
        p_len = wav16.shape[0] // WINDOW
        use_f0 = pitch is not None
        with span("hubert", self.device):
            feats = self.hubert(wav16[None])
        feats = torch.cat([feats, feats[:, -1:]], dim=1)
        feats0 = feats
        index_arrays = self.index_arrays()
        if index_arrays is not None:
            with span("retrieval", self.device):
                head = skip_head // 2
                blended = knn_blend(feats[0, head:], *index_arrays,
                                    self.index_rate)
                feats = torch.cat([feats[:, :head], blended[None]], dim=1)
        feats = torch.repeat_interleave(feats, 2, dim=1)[:, :p_len]
        if use_f0 and protect < 0.5:
            feats0 = torch.repeat_interleave(feats0, 2, dim=1)[:, :p_len]
            pitchff = torch.where(pitchf > 0, 1.0, protect)[None, :, None]
            feats = feats * pitchff + feats0 * (1 - pitchff)
        generator = torch.Generator(device=self.device).manual_seed(int(step))
        audio = self.synth.infer(
            feats, self._length_tensor(p_len), self._sid,
            pitch[None] if use_f0 else None,
            pitchf[None] if use_f0 else None,
            skip_head=skip_head, return_length=return_length,
            return_length2=return_length2, noise_scale=self.noise_scale,
            deterministic=self.deterministic, generator=generator)
        return audio[0, :, 0]

    @torch.no_grad()
    @fp32_math()
    def infer(self, input_wav: np.ndarray, block_frame_16k: int,
              skip_head: int, return_length: int,
              f0method: Union[tuple, str] = "rmvpe",
              protect: float = 1.0) -> np.ndarray:
        """Convert one rolling window; returns target-rate audio of
        return_length frames (reference rtrvc.RVC.infer, rtrvc.py:134)."""
        input_wav = np.asarray(input_wav, np.float32)
        p_len = len(input_wav) // WINDOW
        factor = 2.0 ** (self.formant_shift / 12)
        return_length2 = int(np.ceil(return_length * factor))
        use_f0 = self.if_f0 == 1

        pitch = np.zeros(p_len, np.int32)
        pitchf = np.zeros(p_len, np.float32)
        if isinstance(f0method, tuple):
            pitch_t, pitchf_t = f0method
            pitch[:len(pitch_t)] = pitch_t[:p_len]
            pitchf[:len(pitchf_t)] = pitchf_t[:p_len]
        elif use_f0:
            # f0 on the tail only, rolled into the 1024-frame caches
            tail = f0_tail_samples(block_frame_16k, f0method)
            with span("f0", self.device):
                c, f = self.f0_gen.calculate(
                    input_wav[-tail:], None,
                    self.f0_up_key - self.formant_shift, f0method)
            shift = block_frame_16k // WINDOW
            self.cache_pitch[:-shift] = self.cache_pitch[shift:]
            self.cache_pitchf[:-shift] = self.cache_pitchf[shift:]
            n_new = len(c) - 4  # drop 3 head + 1 tail frames (rtrvc.py:212)
            self.cache_pitch[-n_new:] = c[3:-1]
            self.cache_pitchf[-n_new:] = f[3:-1]
            pitch = self.cache_pitch[-p_len:].astype(np.int32)
            pitchf = (self.cache_pitchf[-p_len:] *
                      (return_length2 / return_length)).astype(np.float32)

        self._step += 1
        dev = self.device
        out = self.convert_window(
            torch.from_numpy(input_wav).to(dev),
            torch.from_numpy(pitch).to(dev) if use_f0 else None,
            torch.from_numpy(pitchf).to(dev) if use_f0 else None,
            skip_head, return_length, return_length2, protect, self._step)
        # formant-shift output resample (rtrvc.py:249-259)
        upp_res = int(np.floor(factor * self.tgt_sr // 100))
        if upp_res != self.tgt_sr // 100:
            out = resample_poly(out[None, : return_length * upp_res],
                                upp_res * 100, self.tgt_sr)[0]
        return out.cpu().numpy()


def phase_vocoder(a: np.ndarray, b: np.ndarray, fade_out: np.ndarray,
                  fade_in: np.ndarray) -> np.ndarray:
    """Phase-vocoder crossfade (reference gui.py:27-48)."""
    window = np.sqrt(fade_out * fade_in)
    fa = np.fft.rfft(a * window)
    fb = np.fft.rfft(b * window)
    absab = np.abs(fa) + np.abs(fb)
    n = a.shape[0]
    if n % 2 == 0:
        absab[1:-1] *= 2
    else:
        absab[1:] *= 2
    phia = np.angle(fa)
    phib = np.angle(fb)
    deltaphase = phib - phia
    deltaphase = deltaphase - 2 * np.pi * np.floor(
        deltaphase / 2 / np.pi + 0.5)
    w = 2 * np.pi * np.arange(n // 2 + 1) + deltaphase
    t = np.arange(n)[:, None] / n
    return (a * (fade_out ** 2) + b * (fade_in ** 2)
            + np.sum(absab * np.cos(w * t + phia), -1) * window / n)


class BlockGeometry:
    """Frame geometry of the streaming loop (reference gui.py:838-876
    window math), in samples at the stream rate unless named otherwise;
    `skip_head` and `return_length` are 10 ms frames."""

    def __init__(self, samplerate: int, block_time: float,
                 crossfade_time: float, extra_time: float):
        zc = samplerate // 100
        self.sr = samplerate
        self.zc = zc
        self.block_frame = int(round(block_time * samplerate / zc)) * zc
        self.crossfade_frame = int(
            round(crossfade_time * samplerate / zc)) * zc
        self.sola_buffer_frame = min(self.crossfade_frame, 4 * zc)
        self.sola_search_frame = zc
        self.extra_frame = int(round(extra_time * samplerate / zc)) * zc
        self.total = (self.extra_frame + self.crossfade_frame +
                      self.sola_search_frame + self.block_frame)
        self.skip_head = self.extra_frame // zc
        self.return_length = (self.block_frame + self.sola_buffer_frame +
                              self.sola_search_frame) // zc
        fade = np.sin(0.5 * np.pi * np.linspace(
            0.0, 1.0, self.sola_buffer_frame)) ** 2
        self.fade_in = fade.astype(np.float32)
        self.fade_out = (1.0 - fade).astype(np.float32)


class StreamSession:
    """Block-by-block streaming loop (gui.py audio_infer math, no audio
    device).  feed(block) -> aligned output block of the same length, at
    `samplerate`.  `fused=True` takes the FusedStreamGraph path while the
    configuration allows it (no formant shift, no RMS mix) and raises if
    that path cannot be built; `fused=False` asks for the host block
    path."""

    def __init__(self, engine: RealtimeVC, samplerate: int = 48000,
                 block_time: float = 0.25, crossfade_time: float = 0.05,
                 extra_time: float = 2.5, f0method: str = "rmvpe",
                 rms_mix_rate: float = 1.0, protect: float = 1.0,
                 use_phase_vocoder: bool = False,
                 input_noise_reduce: bool = False,
                 output_noise_reduce: bool = False,
                 fused: bool = True):
        if input_noise_reduce or output_noise_reduce:
            raise NotImplementedError(
                "spectral-gate noise reduction is not ported to "
                "tpu_rvc_torch yet (ROADMAP.md queue A: 'Serving slice', "
                "audio/torchgate.py)")
        self.engine = engine
        geo = BlockGeometry(samplerate, block_time, crossfade_time,
                            extra_time)
        self.geometry = geo
        self.sr = samplerate
        self.zc = geo.zc
        self.block_frame = geo.block_frame
        self.block_frame_16k = 160 * geo.block_frame // geo.zc
        self.crossfade_frame = geo.crossfade_frame
        self.sola_buffer_frame = geo.sola_buffer_frame
        self.sola_search_frame = geo.sola_search_frame
        self.extra_frame = geo.extra_frame
        self.f0method = f0method
        self.rms_mix_rate = rms_mix_rate
        self.protect = protect
        self.use_pv = use_phase_vocoder

        self.input_wav = np.zeros(geo.total, np.float32)
        self.input_wav_res = np.zeros(160 * geo.total // self.zc, np.float32)
        self.sola_buffer = np.zeros(self.sola_buffer_frame, np.float32)
        self.fade_in_window = geo.fade_in
        self.fade_out_window = geo.fade_out
        self.skip_head = geo.skip_head
        self.return_length = geo.return_length
        # the engine's rate must be brought to the stream's (gui resampler2)
        self._out_resample = (self.engine.tgt_sr != samplerate)
        self._fused = None
        self._fused_saved = None  # parked while a slider rules it out
        self._fused_state = None
        if fused and engine.if_f0 in (0, 1):
            self._fused_saved = FusedStreamGraph(
                engine, stream_sr=samplerate, block_frame=self.block_frame,
                ctx_frame=2 * self.zc, total_len=geo.total,
                skip_head=self.skip_head, return_length=self.return_length,
                f0method=f0method, protect=protect)
            self._update_fused_eligibility()

    # ---- mid-stream control (reference gui.py:518-592 slider events
    # calling rtrvc set_* while the stream runs) ----
    def set_key(self, key: float) -> None:
        self.engine.set_key(key)  # both paths read it in every block

    def set_formant(self, formant: float) -> None:
        # a formant shift changes return_length2, which the fused path
        # fixes, so the host block path takes over while it is non-zero
        self.engine.set_formant(formant)
        self._update_fused_eligibility()

    def set_index_rate(self, rate: float) -> None:
        self.engine.set_index_rate(rate)

    def set_rms_mix_rate(self, rate: float) -> None:
        self.rms_mix_rate = float(rate)  # the RMS mix is the host path's
        self._update_fused_eligibility()

    def _resample(self, wav: np.ndarray, orig_sr: int, new_sr: int
                  ) -> torch.Tensor:
        """Host audio resampled on the engine's device, as the fused path
        resamples: both paths then see the same samples."""
        return resample_poly(
            torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(
                self.engine.device)[None], orig_sr, new_sr)[0]

    def _resampled_window(self) -> torch.Tensor:
        """The stream-rate rolling buffer (fresh on both paths) at 16 kHz
        on the device, right-aligned in the 16 kHz window's length."""
        dev = self.engine.device
        res = self._resample(self.input_wav, self.sr, SR)
        L = len(self.input_wav_res)
        n = min(L, res.shape[0])
        out = torch.zeros(L, dtype=torch.float32, device=dev)
        out[L - n:] = res[res.shape[0] - n:]
        return out

    @torch.no_grad()
    def _update_fused_eligibility(self) -> None:
        """Park the fused path when a slider leaves the configuration it
        covers, and restore it when the slider returns: the session must
        not stay on the host path for good.  Either way the path that
        takes over starts from the 16 kHz resample of the stream-rate
        buffer; the pitch caches refill over the next p_len frames, as in
        a fresh session."""
        eligible = (self.engine.formant_shift == 0
                    and self.rms_mix_rate >= 1.0)
        if not eligible:
            if self._fused is not None:
                self._fused_saved, self._fused = self._fused, None
                self.input_wav_res[:] = self._resampled_window().cpu().numpy()
        elif self._fused is None and self._fused_saved is not None:
            restored = self._fused_saved
            state = restored.init_state()
            state["wav16"] = self._resampled_window()
            # the state is published before the graph: a feed() that sees
            # the graph must never pair it with the state from before
            self._fused_state = state
            self._fused_saved = None
            self._fused = restored

    def feed(self, block: np.ndarray) -> np.ndarray:
        """Process one block (len == block_frame at the stream rate)."""
        if len(block) != self.block_frame:
            raise ValueError(f"block must be {self.block_frame} samples, "
                             f"got {len(block)}")
        self.input_wav[:-self.block_frame] = self.input_wav[self.block_frame:]
        self.input_wav[-self.block_frame:] = block
        # the freshest audio with one extra zc of context (gui.py:997)
        seg = self.input_wav[-self.block_frame - 2 * self.zc:]
        if self._fused is not None:
            infer_wav, self._fused_state = self._fused(self._fused_state, seg)
            return self._merge_block(infer_wav)
        self.input_wav_res[:-self.block_frame_16k] = \
            self.input_wav_res[self.block_frame_16k:]
        res = self._resample(seg, self.sr, SR).cpu().numpy()
        self.input_wav_res[-self.block_frame_16k - 160:] = \
            res[160: 160 + self.block_frame_16k + 160]

        infer_wav = self.engine.infer(
            self.input_wav_res, self.block_frame_16k, self.skip_head,
            self.return_length, self.f0method, self.protect)
        if self._out_resample:
            infer_wav = self._resample(infer_wav, self.engine.tgt_sr,
                                       self.sr).cpu().numpy()
        need = (self.block_frame + self.sola_buffer_frame +
                self.sola_search_frame)
        if len(infer_wav) < need:
            infer_wav = np.pad(infer_wav, (0, need - len(infer_wav)))

        # RMS envelope mix (gui.py:1027-1056)
        if self.rms_mix_rate < 1:
            src = self.input_wav[self.extra_frame:]
            rms1 = _interp_to(rms_envelope(src[:len(infer_wav)], 4 * self.zc,
                                           self.zc), len(infer_wav))
            rms2 = np.maximum(_interp_to(
                rms_envelope(infer_wav, 4 * self.zc, self.zc),
                len(infer_wav)), 1e-3)
            infer_wav = infer_wav * np.power(
                rms1 / rms2, 1 - self.rms_mix_rate)

        return self._merge_block(infer_wav)

    def _merge_block(self, infer_wav: np.ndarray) -> np.ndarray:
        out, self.sola_buffer = sola_merge(
            infer_wav, self.sola_buffer, self.fade_in_window,
            self.fade_out_window, self.block_frame, self.sola_buffer_frame,
            self.sola_search_frame, use_pv=self.use_pv)
        return out


def sola_merge(infer_wav: np.ndarray, sola_buffer: np.ndarray,
               fade_in: np.ndarray, fade_out: np.ndarray,
               block_frame: int, sola_buffer_frame: int,
               sola_search_frame: int, use_pv: bool = False
               ) -> Tuple[np.ndarray, np.ndarray]:
    """SOLA alignment and crossfade merge of one converted block
    (gui.py:1058-1090): find the offset in the search window that best
    matches the previous block's tail, crossfade (or phase-vocoder) the
    seam, and return (aligned block, next sola_buffer).  A pure function
    of its inputs."""
    need = block_frame + sola_buffer_frame + sola_search_frame
    if len(infer_wav) < need:
        infer_wav = np.pad(infer_wav, (0, need - len(infer_wav)))
    # the search window is exactly buffer + search samples
    # (gui.py:1058-1060): valid-mode correlation gives search + 1 offsets,
    # so infer_wav[sola_offset:] always keeps block + buffer samples
    conv_input = infer_wav[:sola_buffer_frame + sola_search_frame]
    cor_nom = np.correlate(conv_input, sola_buffer, mode="valid")
    sq = np.convolve(conv_input ** 2,
                     np.ones(sola_buffer_frame), mode="valid")
    cor_den = np.sqrt(sq + 1e-8)
    k = min(len(cor_nom), len(cor_den))
    sola_offset = int(np.argmax(cor_nom[:k] / cor_den[:k]))
    infer_wav = np.array(infer_wav[sola_offset:])  # own writable copy
    if not use_pv:
        infer_wav[:sola_buffer_frame] = (
            infer_wav[:sola_buffer_frame] * fade_in +
            sola_buffer * fade_out)
    else:
        infer_wav[:sola_buffer_frame] = phase_vocoder(
            sola_buffer, infer_wav[:sola_buffer_frame], fade_out, fade_in)
    new_buffer = infer_wav[
        block_frame: block_frame + sola_buffer_frame].copy()
    return infer_wav[:block_frame].copy(), new_buffer


class FusedStreamGraph:
    """One streaming block with its state on the device (the
    latency-critical path), single stream.

    Per block: upload the fresh stream-rate segment; on the device
    resample it to 16 kHz, roll the 16 kHz window, f0 on the tail, roll
    the 1024-frame pitch caches (rtrvc.py:209-217), HuBERT on the window,
    tail retrieval, the synthesizer's streaming infer, resample to the
    stream rate; fetch block + crossfade + search samples.  Between the
    upload and the fetch the host only queues work.  The state dict is
    taken and returned; the returned one shares no memory with the
    argument.  SOLA stays on the host, which has the fetched audio anyway.
    """

    def __init__(self, engine: RealtimeVC, *, stream_sr: int,
                 block_frame: int, ctx_frame: int, total_len: int,
                 skip_head: int, return_length: int, f0method: str = "pm",
                 protect: float = 1.0):
        self.engine = engine
        self.stream_sr = stream_sr
        self.block_frame = block_frame          # stream-rate samples
        self.ctx_frame = ctx_frame              # extra context uploaded
        self.total_len = total_len              # stream-rate window length
        self.block_16k = 160 * block_frame // (stream_sr // 100)
        self.total_16k = 160 * total_len // (stream_sr // 100)
        self.skip_head = skip_head
        self.return_length = return_length
        self.f0method = f0method
        self.protect = protect
        self.use_f0 = engine.if_f0 == 1
        # built here, so that a missing checkpoint or an estimator that is
        # not ported raises now and not in the first block
        self._f0_model = None
        if self.use_f0:
            est = engine.f0_gen._get(f0method)
            if f0method == "rmvpe":
                self._f0_model = est.model
        self._step = 0

    def init_state(self) -> Dict[str, torch.Tensor]:
        dev = self.engine.device
        return {
            "wav16": torch.zeros(self.total_16k, dtype=torch.float32,
                                 device=dev),
            "cache_pitch": torch.zeros(CACHE_FRAMES, dtype=torch.int32,
                                       device=dev),
            "cache_pitchf": torch.zeros(CACHE_FRAMES, dtype=torch.float32,
                                        device=dev),
        }

    def _block(self, state, seg: torch.Tensor, step: int):
        """The device side of one block; queues work only."""
        eng = self.engine
        # 1. the fresh segment at 16 kHz, appended to the rolled window
        seg16 = resample_poly(seg[None], self.stream_sr, SR)[0]
        n_new = self.block_16k + 160
        wav16 = torch.cat([
            state["wav16"][self.block_16k: self.total_16k - 160],
            seg16[160: 160 + n_new]])

        # 2. f0 on the tail, rolled into the pitch caches
        if self.use_f0:
            tail = min(f0_tail_samples(self.block_16k, self.f0method),
                       self.total_16k)
            with span("f0", eng.device):
                if self.f0method == "rmvpe":
                    c, f = rmvpe_f0_device(wav16[-tail:], tail // WINDOW,
                                           eng.f0_up_key, self._f0_model)
                else:
                    c, f = pm_f0_device(wav16[-tail:], tail // WINDOW,
                                        eng.f0_up_key)
            shift = self.block_16k // WINDOW
            n_keep = c.shape[0] - 4   # drop 3 head + 1 tail frames
            cache_pitch = torch.cat([
                state["cache_pitch"][shift: CACHE_FRAMES - n_keep + shift],
                c[3:-1]])
            cache_pitchf = torch.cat([
                state["cache_pitchf"][shift: CACHE_FRAMES - n_keep + shift],
                f[3:-1]])
        else:
            cache_pitch = state["cache_pitch"].clone()
            cache_pitchf = state["cache_pitchf"].clone()
        p_len = self.total_16k // WINDOW

        # 3. HuBERT on the window, tail retrieval, the synthesizer
        out = eng.convert_window(
            wav16, cache_pitch[-p_len:] if self.use_f0 else None,
            cache_pitchf[-p_len:] if self.use_f0 else None,
            self.skip_head, self.return_length, self.return_length,
            self.protect, step)
        # 4. to the stream rate
        if eng.tgt_sr != self.stream_sr:
            out = resample_poly(out[None], eng.tgt_sr, self.stream_sr)[0]
        return out, {"wav16": wav16, "cache_pitch": cache_pitch,
                     "cache_pitchf": cache_pitchf}

    @torch.no_grad()
    @fp32_math()
    def __call__(self, state, seg: np.ndarray, fetch: bool = True):
        """state, fresh segment (block_frame + ctx_frame stream-rate
        samples) -> (audio, new state).  fetch=False leaves the audio on
        the device, for a caller that overlaps the fetch with the next
        block."""
        self._step += 1
        seg_dev = torch.from_numpy(
            np.ascontiguousarray(seg, np.float32)).to(self.engine.device)
        out, new_state = self._block(state, seg_dev, self._step)
        return (out.cpu().numpy() if fetch else out), new_state
