"""One served stream written out again: the block math of the port's
serving tick (tpu_rvc_torch/pipeline/serve.py `SlotScheduler` and
pipeline/rt.py `FusedStreamGraph._block`, `RealtimeVC.convert_window`,
`sola_merge`) for one client, from a fresh slot: the rolling 48 kHz input,
the 16 kHz window, RMVPE on the tail rolled into 1024-frame pitch
caches, HuBERT over the window, the tail's retrieval blend, the
synthesizer's streamed infer, the resample to the stream's rate and the
SOLA merge on the host.  A served stream draws its noise as row `row` of
the batch's draw from a generator seeded with the tick's step; `Stream`
takes that row (`device.RowOf`).  `block` is written for a batch: the
FLOP count runs it over all the tick's streams."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from .device import RowOf
from .f0_device import rmvpe_f0_device
from .resample import resample_poly
from .search import knn_blend

SR = 16000
WINDOW = 160
CACHE_FRAMES = 1024
RMVPE_GRID = 5120


class Geometry:
    """Frames of the streaming loop (gui.py:838-876), in stream-rate
    samples; `skip_head` and `return_length` in 10 ms frames."""

    def __init__(self, samplerate, block_time, crossfade_time, extra_time):
        zc = samplerate // 100
        self.sr, self.zc = samplerate, zc
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
        self.block_16k = 160 * self.block_frame // zc
        self.total_16k = 160 * self.total // zc


def f0_tail_samples(block_16k: int) -> int:
    n = block_16k + 800
    return RMVPE_GRID * ((n - 1) // RMVPE_GRID + 1) - WINDOW


def sola_scores(infer_wav, sola_buffer, block_frame, sola_buffer_frame,
                sola_search_frame):
    """gui.py:1058-1066: each offset's correlation with the previous
    block's tail over the norm of the samples it meets -> (the block
    padded to its length, the scores)."""
    need = block_frame + sola_buffer_frame + sola_search_frame
    if len(infer_wav) < need:
        infer_wav = np.pad(infer_wav, (0, need - len(infer_wav)))
    conv_input = infer_wav[:sola_buffer_frame + sola_search_frame]
    cor_nom = np.correlate(conv_input, sola_buffer, mode="valid")
    sq = np.convolve(conv_input ** 2, np.ones(sola_buffer_frame),
                     mode="valid")
    cor_den = np.sqrt(sq + 1e-8)
    k = min(len(cor_nom), len(cor_den))
    return infer_wav, cor_nom[:k] / cor_den[:k]


def sola_at(infer_wav, offset, sola_buffer, fade_in, fade_out, block_frame,
            sola_buffer_frame):
    """The block from `offset`, crossfaded into the previous block's tail
    (gui.py:1080-1090) -> (block, next tail)."""
    infer_wav = np.array(infer_wav[offset:])
    infer_wav[:sola_buffer_frame] = (infer_wav[:sola_buffer_frame] * fade_in
                                     + sola_buffer * fade_out)
    return (infer_wav[:block_frame].copy(),
            infer_wav[block_frame: block_frame + sola_buffer_frame].copy())


def sola_merge(infer_wav, sola_buffer, fade_in, fade_out, block_frame,
               sola_buffer_frame, sola_search_frame):
    """The best-correlating offset in the search window, crossfaded into
    the previous block's tail (gui.py:1058-1090) -> (block, next tail)."""
    infer_wav, scores = sola_scores(infer_wav, sola_buffer, block_frame,
                                    sola_buffer_frame, sola_search_frame)
    return sola_at(infer_wav, int(np.argmax(scores)), sola_buffer, fade_in,
                   fade_out, block_frame, sola_buffer_frame)


def sola_follow(infer_wav, sola_buffer, delivered, fade_in, fade_out,
                block_frame, sola_buffer_frame, sola_search_frame, tie):
    """SOLA's merge where its best offsets tie: of the offsets whose score
    lies within `tie` (a share of the largest score's size) of the best,
    the one whose merged block lies nearest the block `delivered`.  Two
    offsets a pitch period apart can score alike to rounding, and the
    card then takes either; the stream after it stays that far out of
    line with the same sound.  An offset outside the tie is never taken,
    so a merge at a wrong offset, or without its fade, still differs.
    -> (block, next tail, the share by which the offset nearest the
    delivered block, of all of them, scores below the best)."""
    infer_wav, scores = sola_scores(infer_wav, sola_buffer, block_frame,
                                    sola_buffer_frame, sola_search_frame)
    best = float(scores.max())
    size = max(float(np.abs(scores).max()), 1e-12)
    # each offset's squared distance to the delivered block: the faded
    # head directly, the rest as sums of squares less the correlation
    n, sb = len(scores), sola_buffer_frame
    x, d = infer_wav.astype(np.float64), delivered.astype(np.float64)
    head = np.lib.stride_tricks.sliding_window_view(x[:n - 1 + sb], sb)
    gaps = ((head * fade_in + (sola_buffer * fade_out - d[:sb])) ** 2
            ).sum(axis=1)
    rest, want = x[sb: n - 1 + block_frame], d[sb:block_frame]
    sums = np.concatenate([[0.0], np.cumsum(rest ** 2)])
    gaps += (sums[len(want):] - sums[:n] - 2.0 * np.correlate(rest, want)
             + float(want @ want))
    nearest = int(np.argmin(gaps))
    shortfall = (best - float(scores[nearest])) / size
    allowed = np.flatnonzero(scores >= best - tie * size)
    offset = int(allowed[np.argmin(gaps[allowed])])
    block, nxt = sola_at(infer_wav, offset, sola_buffer, fade_in, fade_out,
                         block_frame, sola_buffer_frame)
    return block, nxt, shortfall


class Stream:
    """hubert, synth, rmvpe: the reference's networks; index: (vectors,
    squared norms) on the device."""

    def __init__(self, hubert, synth, rmvpe, index, device, geo: Geometry,
                 index_rate=0.75, protect=1.0, f0_up_key=0.0,
                 noise_scale=0.66666):
        self.hubert, self.synth, self.rmvpe = hubert, synth, rmvpe
        self.index, self.device, self.geo = index, torch.device(device), geo
        self.index_rate, self.protect = index_rate, protect
        self.f0_up_key, self.noise_scale = f0_up_key, noise_scale

    def init_state(self, n: int = 1):
        z = dict(device=self.device)
        return {"wav16": torch.zeros((n, self.geo.total_16k), **z),
                "cache_pitch": torch.zeros((n, CACHE_FRAMES),
                                           dtype=torch.int32, **z),
                "cache_pitchf": torch.zeros((n, CACHE_FRAMES), **z)}

    @torch.no_grad()
    def block(self, state, seg, generator):
        """seg (n, block + 2 zc) at the stream rate -> (audio (n, samples)
        at the stream rate, new state)."""
        geo = self.geo
        seg16 = resample_poly(seg, geo.sr, SR)
        n_new = geo.block_16k + 160
        wav16 = torch.cat([
            state["wav16"][:, geo.block_16k: geo.total_16k - 160],
            seg16[:, 160: 160 + n_new]], dim=1)
        tail = min(f0_tail_samples(geo.block_16k), geo.total_16k)
        c, f = rmvpe_f0_device(wav16[:, -tail:], tail // WINDOW,
                               self.f0_up_key, self.rmvpe)
        shift = geo.block_16k // WINDOW
        n_keep = c.shape[1] - 4
        keep = slice(shift, CACHE_FRAMES - n_keep + shift)
        cache_pitch = torch.cat([state["cache_pitch"][:, keep], c[:, 3:-1]], 1)
        cache_pitchf = torch.cat([state["cache_pitchf"][:, keep],
                                  f[:, 3:-1]], 1)
        p_len = geo.total_16k // WINDOW
        pitch, pitchf = cache_pitch[:, -p_len:], cache_pitchf[:, -p_len:]
        n = wav16.shape[0]
        feats = self.hubert(wav16)
        feats = torch.cat([feats, feats[:, -1:]], dim=1)
        feats0 = feats
        if self.index is not None and self.index_rate > 0:
            head = geo.skip_head // 2
            feats = torch.cat([feats[:, :head], knn_blend(
                feats[:, head:], *self.index, self.index_rate)], dim=1)
        feats = torch.repeat_interleave(feats, 2, dim=1)[:, :p_len]
        if self.protect < 0.5:
            feats0 = torch.repeat_interleave(feats0, 2, dim=1)[:, :p_len]
            pitchff = torch.where(pitchf > 0, 1.0, self.protect)[:, :, None]
            feats = feats * pitchff + feats0 * (1 - pitchff)
        lengths = torch.full((n,), p_len, dtype=torch.int64,
                             device=wav16.device)
        sid = torch.zeros(n, dtype=torch.int64, device=wav16.device)
        out = self.synth.infer(
            feats, lengths, sid, pitch, pitchf, skip_head=geo.skip_head,
            return_length=geo.return_length,
            return_length2=geo.return_length, noise_scale=self.noise_scale,
            generator=generator)[:, :, 0]
        if self.synth.sr != geo.sr:
            out = resample_poly(out, self.synth.sr, geo.sr)
        return out, {"wav16": wav16, "cache_pitch": cache_pitch,
                     "cache_pitchf": cache_pitchf}

    def run(self, blocks: Sequence[np.ndarray], steps: Sequence[int],
            n_streams: int, row: int, follow: Sequence[np.ndarray] = None,
            tie: float = 0.0) -> List[np.ndarray]:
        """A client's blocks from a fresh slot -> its delivered blocks.
        steps: the tick's step for each block; the stream is row `row` of
        `n_streams`.  With `follow` (the blocks another side delivered),
        SOLA takes, where offsets tie to within `tie`, the one that side
        took (`sola_follow`), and `self.shortfalls` keeps each block's."""
        geo = self.geo
        bf, ctx = geo.block_frame, 2 * geo.zc
        input_wav = np.zeros(geo.total, np.float32)
        sola_buffer = np.zeros(geo.sola_buffer_frame, np.float32)
        state = self.init_state()
        outs, self.shortfalls = [], []
        for k, (blk, step) in enumerate(zip(blocks, steps)):
            input_wav[:-bf] = input_wav[bf:]
            input_wav[-bf:] = blk
            seg = torch.as_tensor(input_wav[-bf - ctx:].copy(),
                                  device=self.device)[None]
            gen = RowOf(torch.Generator(device=self.device).manual_seed(
                int(step)), n_streams, row)
            out, state = self.block(state, seg, gen)
            wav = out[0].cpu().numpy()
            if follow is None:
                merged, sola_buffer = sola_merge(
                    wav, sola_buffer, geo.fade_in, geo.fade_out, bf,
                    geo.sola_buffer_frame, geo.sola_search_frame)
            else:
                merged, sola_buffer, short = sola_follow(
                    wav, sola_buffer, follow[k], geo.fade_in, geo.fade_out,
                    bf, geo.sola_buffer_frame, geo.sola_search_frame, tie)
                self.shortfalls.append(short)
            outs.append(merged)
        return outs
