"""Realtime voice conversion, one stream or a batch of streams (port of
tpu_rvc/pipeline/rt.py; reference infer/lib/rtrvc.py:19 `RVC` and the
gui.py stream loop math).

RealtimeVC: the per-block model engine (rtrvc.RVC role).
  - persistent HuBERT and synthesizer on the device, 1024-frame pitch
    caches shifted by one block per call (rtrvc.py:209-217)
  - f0 on the tail only (for RMVPE on the reference's 5120-sample grid)
  - retrieval applied to the tail only (rtrvc.py:168-185)
  - formant shift through return_length2 and a polyphase resample of the
    output (rtrvc.py:190, 249-259)
  - per block: HuBERT on the whole window, enc_p on the whole window, the
    flow on the tail plus a 24-frame pre-roll, the decoder on the tail.

BatchedRealtimeVC: the same engine for N streams at once: per-stream
  pitch caches, one batched `convert_window` (where the JAX package has
  `vmap` the port has a batch axis: HuBERT, retrieval, the synthesizer and
  both kernels take the N streams in one call each).

StreamSession: the block loop (gui.py:934-1126 math, no audio device):
  rolling input windows, spectral-gate noise reduction of the input and
  the output (audio/torchgate.py), 16 kHz resample, the engine, RMS mix,
  SOLA alignment (normalised cross-correlation, gui.py:1058-1073) and
  crossfade or phase-vocoder merge (gui.py:27-48).  Blocks in, aligned
  blocks out.

FusedStreamGraph: the same block with its rolling state (16 kHz window,
pitch caches) on the device: one upload of the fresh segment, every stage
queued without waiting for the device, one fetch.  With `n_streams=N` the
state, the segment and the output carry a leading stream axis, and a
per-stream `fed` mask freezes the state of streams that got no block
(pipeline/serve.py `SlotScheduler` drives it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from tpu_rvc_torch.audio.dsp import _interp_to, rms_envelope
from tpu_rvc_torch.audio.torchgate import TorchGate
from tpu_rvc_torch.core.device import fp32_math, resolve_device
from tpu_rvc_torch.f0.device import DEVICE_F0, device_f0
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
        self._batch: Dict[Tuple[int, int], Tuple[torch.Tensor,
                                                 torch.Tensor]] = {}
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

    def _lengths_and_sid(self, n: int, p_len: int):
        # made once per batch size and window length: a fresh host-to-device
        # copy in every block would make the host wait for the device
        # mid-block
        if (n, p_len) not in self._batch:
            self._batch[n, p_len] = (
                torch.full((n,), p_len, dtype=torch.int64,
                           device=self.device),
                torch.zeros(n, dtype=torch.int64, device=self.device))
        return self._batch[n, p_len]

    def convert_window(self, wav16: torch.Tensor, pitch, pitchf,
                       skip_head: int, return_length: int,
                       return_length2: int, protect: float,
                       step: int) -> torch.Tensor:
        """One rolling window of one stream or of N on the device -> the
        tail's audio at the model's rate.  wav16: (L16,) or (N, L16);
        pitch / pitchf: (L16 // 160,) or (N, L16 // 160), or None; returns
        (return_length2 * hop,) or (N, return_length2 * hop).  The N
        streams share the weights, the index and the settings and go
        through every stage as one batch.  The prior and source noise are
        one draw of the batch's shape from a generator seeded with `step`,
        so streams differ.  Queues work only: nothing here waits for the
        device."""
        single = wav16.dim() == 1
        use_f0 = pitch is not None
        if single:
            wav16 = wav16[None]
            pitch, pitchf = (pitch[None], pitchf[None]) if use_f0 else (
                None, None)
        n, p_len = wav16.shape[0], wav16.shape[1] // WINDOW
        with span("hubert", self.device):
            feats = self.hubert(wav16)
        feats = torch.cat([feats, feats[:, -1:]], dim=1)
        feats0 = feats
        index_arrays = self.index_arrays()
        if index_arrays is not None:
            with span("retrieval", self.device):
                head = skip_head // 2
                blended = knn_blend(feats[:, head:], *index_arrays,
                                    self.index_rate)
                feats = torch.cat([feats[:, :head], blended], dim=1)
        feats = torch.repeat_interleave(feats, 2, dim=1)[:, :p_len]
        if use_f0 and protect < 0.5:
            feats0 = torch.repeat_interleave(feats0, 2, dim=1)[:, :p_len]
            pitchff = torch.where(pitchf > 0, 1.0, protect)[:, :, None]
            feats = feats * pitchff + feats0 * (1 - pitchff)
        generator = torch.Generator(device=self.device).manual_seed(int(step))
        lengths, sid = self._lengths_and_sid(n, p_len)
        audio = self.synth.infer(
            feats, lengths, sid, pitch, pitchf,
            skip_head=skip_head, return_length=return_length,
            return_length2=return_length2, noise_scale=self.noise_scale,
            deterministic=self.deterministic, generator=generator)
        return audio[0, :, 0] if single else audio[:, :, 0]

    @torch.no_grad()
    @fp32_math()
    def infer(self, input_wav: np.ndarray, block_frame_16k: int,
              skip_head: int, return_length: int,
              f0method: Union[tuple, str] = "rmvpe",
              protect: float = 1.0) -> np.ndarray:
        """Convert one rolling window; returns target-rate audio of
        return_length frames (reference rtrvc.RVC.infer, rtrvc.py:134)."""
        return self._infer(np.asarray(input_wav, np.float32)[None],
                           block_frame_16k, skip_head, return_length,
                           f0method, protect)[0]

    def _infer(self, wavs: np.ndarray, block_frame_16k: int, skip_head: int,
               return_length: int, f0method: Union[tuple, str],
               protect: float) -> np.ndarray:
        """The host block path for a batch: wavs (N, L16) -> (N, samples).
        f0 comes stream by stream from the host estimator into the
        streams' own pitch caches (rows of `cache_pitch`/`cache_pitchf`);
        everything after it is one batched call."""
        n, p_len = wavs.shape[0], wavs.shape[1] // WINDOW
        factor = 2.0 ** (self.formant_shift / 12)
        return_length2 = int(np.ceil(return_length * factor))
        use_f0 = self.if_f0 == 1
        cache_pitch = self.cache_pitch.reshape(n, CACHE_FRAMES)    # views
        cache_pitchf = self.cache_pitchf.reshape(n, CACHE_FRAMES)

        pitch = np.zeros((n, p_len), np.int32)
        pitchf = np.zeros((n, p_len), np.float32)
        if isinstance(f0method, tuple):
            pitch_t, pitchf_t = (np.asarray(a) for a in f0method)
            pitch[:, :pitch_t.shape[-1]] = pitch_t[..., :p_len]
            pitchf[:, :pitchf_t.shape[-1]] = pitchf_t[..., :p_len]
        elif use_f0:
            # f0 on the tail only, rolled into the 1024-frame caches
            tail = f0_tail_samples(block_frame_16k, f0method)
            shift = block_frame_16k // WINDOW
            with span("f0", self.device):
                for b in range(n):
                    c, f = self.f0_gen.calculate(
                        wavs[b, -tail:], None,
                        self.f0_up_key - self.formant_shift, f0method)
                    cache_pitch[b, :-shift] = cache_pitch[b, shift:]
                    cache_pitchf[b, :-shift] = cache_pitchf[b, shift:]
                    n_new = len(c) - 4  # drop 3 head + 1 tail (rtrvc.py:212)
                    cache_pitch[b, -n_new:] = c[3:-1]
                    cache_pitchf[b, -n_new:] = f[3:-1]
            pitch = cache_pitch[:, -p_len:].astype(np.int32)
            pitchf = (cache_pitchf[:, -p_len:] *
                      (return_length2 / return_length)).astype(np.float32)

        self._step += 1
        dev = self.device
        out = self.convert_window(
            torch.from_numpy(wavs).to(dev),
            torch.from_numpy(pitch).to(dev) if use_f0 else None,
            torch.from_numpy(pitchf).to(dev) if use_f0 else None,
            skip_head, return_length, return_length2, protect, self._step)
        # formant-shift output resample (rtrvc.py:249-259)
        upp_res = int(np.floor(factor * self.tgt_sr // 100))
        if upp_res != self.tgt_sr // 100:
            out = resample_poly(out[:, : return_length * upp_res],
                                upp_res * 100, self.tgt_sr)
        return out.cpu().numpy()


class BatchedRealtimeVC(RealtimeVC):
    """N concurrent streaming sessions served by one engine (port of
    tpu_rvc/pipeline/rt.py:200-303): every stage of the block runs once on
    a batch of N windows.  A serving extension beyond the reference, whose
    realtime engine is single-stream (rtrvc.py:19).  Pitch caches and noise
    are per stream; the weights, the retrieval index and the conversion
    settings are shared."""

    def __init__(self, n_streams: int, **kw):
        super().__init__(**kw)
        self.n_streams = int(n_streams)
        self.cache_pitch = np.zeros((self.n_streams, CACHE_FRAMES), np.int32)
        self.cache_pitchf = np.zeros((self.n_streams, CACHE_FRAMES),
                                     np.float32)

    @torch.no_grad()
    @fp32_math()
    def infer(self, input_wavs: np.ndarray, block_frame_16k: int,
              skip_head: int, return_length: int,
              f0method: Union[tuple, str] = "pm",
              protect: float = 1.0) -> np.ndarray:
        """Convert one rolling window for every stream.
        input_wavs: (n_streams, L16) -> (n_streams, samples).  A
        (pitch, pitchf) tuple as `f0method` may be one track for all
        streams or (n_streams, frames)."""
        input_wavs = np.asarray(input_wavs, np.float32)
        if input_wavs.ndim != 2 or input_wavs.shape[0] != self.n_streams:
            raise ValueError(f"input_wavs must be ({self.n_streams}, L16), "
                             f"got {input_wavs.shape}")
        return self._infer(input_wavs, block_frame_16k, skip_head,
                           return_length, f0method, protect)


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
    path.  Noise reduction (`input_noise_reduce`, `output_noise_reduce`)
    and the f0 methods the device does not compute (dio, harvest, crepe)
    are the host path's: the session runs there, as the JAX session does
    (`tpu_rvc/pipeline/rt.py:412-414`)."""

    def __init__(self, engine: RealtimeVC, samplerate: int = 48000,
                 block_time: float = 0.25, crossfade_time: float = 0.05,
                 extra_time: float = 2.5, f0method: str = "rmvpe",
                 rms_mix_rate: float = 1.0, protect: float = 1.0,
                 use_phase_vocoder: bool = False,
                 input_noise_reduce: bool = False,
                 output_noise_reduce: bool = False,
                 fused: bool = True):
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
        # spectral-gate denoisers (gui.py I/O_noise_reduce paths)
        self.input_noise_reduce = bool(input_noise_reduce)
        self.output_noise_reduce = bool(output_noise_reduce)
        noise_reduce = self.input_noise_reduce or self.output_noise_reduce
        if noise_reduce:
            self._tg = TorchGate(sr=samplerate, n_fft=4 * self.zc,
                                 prop_decrease=0.9, device=engine.device)
            self.input_wav_denoise = self.input_wav.copy()
            self.nr_buffer = np.zeros(self.sola_buffer_frame, np.float32)
            self.output_buffer = np.zeros(geo.total, np.float32)
        self._fused = None
        self._fused_saved = None  # parked while a slider rules it out
        self._fused_state = None
        if (fused and engine.if_f0 in (0, 1) and f0method in DEVICE_F0
                and not noise_reduce):
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
        n_seg = self.block_frame + 2 * self.zc
        if self._fused is not None:
            infer_wav, self._fused_state = self._fused(
                self._fused_state, self.input_wav[-n_seg:])
            return self._merge_block(infer_wav)
        self.input_wav_res[:-self.block_frame_16k] = \
            self.input_wav_res[self.block_frame_16k:]
        source_wav = self.input_wav
        if self.input_noise_reduce:
            # denoise the fresh block against the whole window's noise
            # profile, crossfaded with the previous tail (gui.py:978-992)
            self.input_wav_denoise[:-self.block_frame] = \
                self.input_wav_denoise[self.block_frame:]
            den = self._tg(self.input_wav[-self.sola_buffer_frame -
                                          self.block_frame:].copy(),
                           self.input_wav).astype(np.float32)
            den[: self.sola_buffer_frame] *= self.fade_in_window
            den[: self.sola_buffer_frame] += (self.nr_buffer *
                                              self.fade_out_window)
            self.input_wav_denoise[-self.block_frame:] = \
                den[: self.block_frame]
            self.nr_buffer[:] = den[self.block_frame:
                                    self.block_frame + self.sola_buffer_frame]
            source_wav = self.input_wav_denoise
        res = self._resample(source_wav[-n_seg:], self.sr, SR).cpu().numpy()
        self.input_wav_res[-self.block_frame_16k - 160:] = \
            res[160: 160 + self.block_frame_16k + 160]

        infer_wav = self.engine.infer(
            self.input_wav_res, self.block_frame_16k, self.skip_head,
            self.return_length, self.f0method, self.protect)
        if self._out_resample:
            infer_wav = self._resample(infer_wav, self.engine.tgt_sr,
                                       self.sr).cpu().numpy()
        if self.output_noise_reduce:
            # the rolling output buffer is the noise profile
            # (gui.py:1017-1026)
            self.output_buffer[:-self.block_frame] = \
                self.output_buffer[self.block_frame:]
            n_new = min(self.block_frame, len(infer_wav))
            self.output_buffer[-n_new:] = infer_wav[-n_new:]
            infer_wav = self._tg(infer_wav.astype(np.float32),
                                 self.output_buffer).astype(np.float32)
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
    latency-critical path), for one stream or for `n_streams`.

    Per block: upload the fresh stream-rate segment; on the device
    resample it to 16 kHz, roll the 16 kHz window, f0 on the tail, roll
    the 1024-frame pitch caches (rtrvc.py:209-217), HuBERT on the window,
    tail retrieval, the synthesizer's streaming infer, resample to the
    stream rate; fetch block + crossfade + search samples.  Between the
    upload and the fetch the host only queues work.  The state dict is
    taken and returned; the returned one shares no memory with the
    argument.  SOLA stays on the host, which has the fetched audio anyway.

    With `n_streams = N > 1` (multi-stream serving: one call advances every
    session) the state tensors, the segment and the output carry a leading
    stream axis; the weights, the index and the settings are shared.  A
    `fed` mask (N,) says which streams got a block: a stream with `fed`
    false keeps its state exactly, and its output row is whatever falls
    out of the batch (the caller discards it).  Where the JAX class folds
    the stream index into the step's noise key, the port draws one
    (N, ...) tensor from the step's generator: streams differ from each
    other, and stream 0 of a batch does not repeat the single-stream
    draw.  With N = 1 the state and the call are unbatched.
    """

    def __init__(self, engine: RealtimeVC, *, stream_sr: int,
                 block_frame: int, ctx_frame: int, total_len: int,
                 skip_head: int, return_length: int, f0method: str = "pm",
                 protect: float = 1.0, n_streams: int = 1):
        self.engine = engine
        self.n_streams = int(n_streams)
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
        # checked and built here, so that a host-only method or a missing
        # checkpoint raises now and not in the first block; where the JAX
        # graph computes pm for a method it does not know, this one raises
        if f0method not in DEVICE_F0:
            raise ValueError(f"f0 method {f0method!r} is not computed on the "
                             f"device (those are {', '.join(DEVICE_F0)})")
        self._f0_model = None
        if self.use_f0 and f0method != "pm":
            self._f0_model = engine.f0_gen._get(f0method).model
        self._step = 0
        self._staging: Dict[str, Tuple[torch.Tensor, object]] = {}
        # (segment shape, fed mask given) of the last call, for
        # `last_graph_flops`
        self._last_call: Optional[Tuple[Tuple[int, ...], bool]] = None

    @torch.no_grad()
    @fp32_math()
    def last_graph_flops(self) -> Optional[float]:
        """FLOPs of one `_block` at the last call's segment shape and
        stream count (`utils/roofline.py`), or None before any call: the
        MFU numerator of a block or a serving tick.  It runs the block once
        more from a fresh state and a zero segment at the current step,
        with the kernels counted and not launched; the streams' state and
        the step counter stay as they were."""
        if self._last_call is None:
            return None
        from tpu_rvc_torch.utils.roofline import graph_flops

        seg_shape, with_fed = self._last_call
        dev = self.engine.device
        fed = (torch.ones(self.n_streams, dtype=torch.bool, device=dev)
               if with_fed else None)
        return graph_flops(self._block, self.init_state(),
                           torch.zeros(seg_shape, device=dev), fed,
                           self._step)

    def init_state(self) -> Dict[str, torch.Tensor]:
        dev = self.engine.device
        lead = () if self.n_streams == 1 else (self.n_streams,)
        return {
            "wav16": torch.zeros(lead + (self.total_16k,),
                                 dtype=torch.float32, device=dev),
            "cache_pitch": torch.zeros(lead + (CACHE_FRAMES,),
                                       dtype=torch.int32, device=dev),
            "cache_pitchf": torch.zeros(lead + (CACHE_FRAMES,),
                                        dtype=torch.float32, device=dev),
        }

    def _block(self, state, seg: torch.Tensor, fed, step: int):
        """The device side of one block; queues work only.  Written for a
        batch: a single stream is a batch of one here."""
        eng = self.engine
        single = self.n_streams == 1
        if single:
            state = {k: v[None] for k, v in state.items()}
            seg = seg[None]
        # 1. the fresh segment at 16 kHz, appended to the rolled window
        seg16 = resample_poly(seg, self.stream_sr, SR)
        n_new = self.block_16k + 160
        wav16 = torch.cat([
            state["wav16"][:, self.block_16k: self.total_16k - 160],
            seg16[:, 160: 160 + n_new]], dim=1)

        # 2. f0 on the tail, rolled into the pitch caches
        if self.use_f0:
            tail = min(f0_tail_samples(self.block_16k, self.f0method),
                       self.total_16k)
            with span("f0", eng.device):
                c, f = device_f0(self.f0method, wav16[:, -tail:],
                                 tail // WINDOW, eng.f0_up_key, self._f0_model)
            shift = self.block_16k // WINDOW
            n_keep = c.shape[1] - 4   # drop 3 head + 1 tail frames
            keep = slice(shift, CACHE_FRAMES - n_keep + shift)
            cache_pitch = torch.cat([state["cache_pitch"][:, keep],
                                     c[:, 3:-1]], dim=1)
            cache_pitchf = torch.cat([state["cache_pitchf"][:, keep],
                                      f[:, 3:-1]], dim=1)
        else:
            cache_pitch = state["cache_pitch"].clone()
            cache_pitchf = state["cache_pitchf"].clone()
        p_len = self.total_16k // WINDOW

        # 3. HuBERT on the window, tail retrieval, the synthesizer
        out = eng.convert_window(
            wav16, cache_pitch[:, -p_len:] if self.use_f0 else None,
            cache_pitchf[:, -p_len:] if self.use_f0 else None,
            self.skip_head, self.return_length, self.return_length,
            self.protect, step)
        # 4. to the stream rate
        if eng.tgt_sr != self.stream_sr:
            out = resample_poly(out, eng.tgt_sr, self.stream_sr)
        new_state = {"wav16": wav16, "cache_pitch": cache_pitch,
                     "cache_pitchf": cache_pitchf}
        if fed is not None:
            # a stream that got no block keeps its state exactly
            new_state = {k: torch.where(fed[:, None], v, state[k])
                         for k, v in new_state.items()}
        if single:
            out, new_state = out[0], {k: v[0] for k, v in new_state.items()}
        return out, new_state

    def _upload(self, name: str, host: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor.  On a card the copy goes through a
        pinned staging buffer kept per `name` and does not wait for the
        work already queued (a copy from pageable memory would), so a
        caller that left the last block's output on the device can prepare
        and queue the next block while that one still runs."""
        with span("upload"):
            dev = self.engine.device
            src = torch.from_numpy(host)
            if dev.type != "cuda":
                return src.to(dev)
            slot = self._staging.get(name)
            if slot is None or slot[0].shape != src.shape \
                    or slot[0].dtype != src.dtype:
                slot = (torch.empty(src.shape, dtype=src.dtype,
                                    pin_memory=True), torch.cuda.Event())
                self._staging[name] = slot
            buf, copied = slot
            copied.synchronize()   # the buffer's last copy has left it
            buf.copy_(src)
            out = buf.to(dev, non_blocking=True)
            copied.record()
            return out

    @torch.no_grad()
    @fp32_math()
    def __call__(self, state, seg: np.ndarray, fed=None, fetch: bool = True):
        """state, fresh segment -> (audio, new state).  seg: block_frame +
        ctx_frame stream-rate samples, (n_streams, ...) for a batch; fed:
        None (every stream got a block), or a bool per stream (one bool
        for a single stream).  The segment and the mask are the call's
        only host-to-device copies.  fetch=False leaves the audio on the
        device, for a caller that overlaps the fetch with the next block."""
        self._step += 1
        seg_dev = self._upload("seg", np.ascontiguousarray(seg, np.float32))
        fed_dev = None
        if self.n_streams > 1 and fed is not None:
            fed_dev = self._upload("fed", np.ascontiguousarray(fed, bool))
        self._last_call = (tuple(seg_dev.shape), fed_dev is not None)
        out, new_state = self._block(state, seg_dev, fed_dev, self._step)
        if self.n_streams == 1 and fed is not None and not fed:
            new_state = {k: v.clone() for k, v in state.items()}
        if fetch:
            with span("fetch"):
                out = out.cpu().numpy()
        return out, new_state
