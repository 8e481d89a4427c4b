"""Chunk-parallel conversion of one long utterance over a device mesh
(port of tpu_rvc/parallel/chunks.py:73-208).

The sequential path (`Pipeline.pipeline`) converts a long file's
silence-split chunks one after another, each in a bucket of its own
length.  Here every chunk is padded to one common bucket and the chunks
become rows of one batch, split over the mesh's `data` axis: each shard
converts its rows with `Pipeline._convert_rows` on its replica of the
pipeline, at most `ROWS_PER_CALL` rows a call.  f0 is computed once over
the whole padded signal and sliced per chunk with the sequential loop's
boundary arithmetic (`pipeline/vc.py` `chunk_spans`), so the chunks are
independent.

Noise: every row draws what the sequential path draws for a chunk of the
common bucket, from a fresh generator seeded `noise_seed` (the JAX graph
takes one unbatched key, `in_axes` None), so the chunks whose own bucket
is the common one agree with the sequential path, and the grouping of
rows into calls changes no sample.

Each row comes back as int16 at a fixed scale (the decoder's output is
tanh-bounded); the host trims and joins the pieces, and
`Pipeline.finish` mixes the RMS envelope on the host, resamples on the
device and scales the peak, in the JAX package's order.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from tpu_rvc_torch.audio.dsp import highpass_filter
from tpu_rvc_torch.core.device import fp32_math
from tpu_rvc_torch.core.mesh import Mesh, replicas, shard_bounds
from tpu_rvc_torch.f0.device import DEVICE_F0, device_f0
from tpu_rvc_torch.pipeline.vc import (WINDOW, _bucket, _feat_frames,
                                       chunk_spans, silence_chunk_bounds)
from tpu_rvc_torch.utils.timing import span

# Chunk rows a device call converts: a memory budget, not a speed
# setting.  A row of a 79 s bucket (K1 at (2, 7898, 96), K2 at
# (32, 3.8 M) at the last level) needs about 3 GB of activations, so a
# 20-minute file in one call would hold about 60 GB of the card; 4 rows
# keep a conversion near 12 GB whatever the file's length and leave the
# rest of the card to other work on it (a server's sessions, another
# conversion).  chip_smoke.py D1 reads the peak (H100 80GB HBM3 at 700 W:
# 8.3 GB for 3 rows, 11.9 GB for a 20-minute file at 4 rows a call); it
# times no other value, so what the grouping costs in wall time is not
# measured.
ROWS_PER_CALL = 4


def _global_f0(pipeline, audio_pad: np.ndarray, p_len: int, f0_up_key,
               f0_method: str, filter_radius):
    """(coarse, f0) numpy of p_len frames over the whole padded signal: on
    the device for pm, rmvpe and fcpe, through `f0_gen.calculate` for the
    host methods (tpu_rvc/parallel/chunks.py:101-121)."""
    with span("f0", pipeline.device):
        if f0_method in DEVICE_F0:
            model = (pipeline.f0_gen._get(f0_method).model
                     if f0_method in ("rmvpe", "fcpe") else None)
            pit, pf = device_f0(
                f0_method, torch.as_tensor(audio_pad, device=pipeline.device),
                p_len, float(f0_up_key), model)
            return (pit.cpu().numpy()[:p_len],
                    pf.float().cpu().numpy()[:p_len])
        c, f = pipeline.f0_gen.calculate(audio_pad, p_len, f0_up_key,
                                         f0_method, filter_radius, None)
        return (np.asarray(c, np.int32)[:p_len],
                np.asarray(f, np.float32)[:p_len])


def _rows_int16(rep, audio_rows, true_len, sid, pit_rows, pitf_rows, index,
                index_rate, protect, noise_seed):
    """One call: rows -> int16 (rows, samples) at the fixed scale, on the
    replica's device."""
    n = audio_rows.shape[0]
    dev = rep.device
    arrays = rep._index_arrays(index, index_rate)
    out = rep._convert_rows(
        torch.as_tensor(audio_rows, device=dev), true_len, [sid] * n,
        None if pit_rows is None else torch.as_tensor(pit_rows, device=dev),
        None if pitf_rows is None else torch.as_tensor(pitf_rows,
                                                       device=dev),
        arrays, index_rate, protect,
        [rep._generator(noise_seed) for _ in range(n)])
    return torch.clamp(out * 32767.0, -32768, 32767).to(torch.int16)


@torch.no_grad()
@fp32_math()
def convert_long(pipeline, sid: int, audio: np.ndarray, mesh: Mesh, *,
                 f0_up_key: float = 0, f0_method: str = "rmvpe",
                 index=None, index_rate: float = 0.0, if_f0: int = 1,
                 filter_radius: Optional[float] = 3, resample_sr: int = 0,
                 rms_mix_rate: float = 1.0, protect: float = 0.33,
                 noise_seed: int = 0) -> np.ndarray:
    """Convert one long 16 kHz utterance with its chunks as rows over the
    mesh.  Same arguments and output contract as `Pipeline.pipeline`;
    audio that fits one chunk takes the sequential path."""
    audio_raw = np.asarray(audio, np.float32)
    with span("split"):   # host work, on the host clock
        audio = highpass_filter(audio_raw)
        opt_ts = silence_chunk_bounds(audio, pipeline.t_center,
                                      pipeline.t_query, pipeline.t_max)
    if not opt_ts:
        # the UNfiltered audio: the sequential path applies the high-pass
        # itself
        return pipeline.pipeline(
            sid, audio_raw, [0.0, 0.0, 0.0], f0_up_key, f0_method, index,
            index_rate, if_f0, filter_radius, resample_sr, rms_mix_rate,
            protect, noise_seed=noise_seed)

    audio_pad = np.pad(audio, (pipeline.t_pad, pipeline.t_pad),
                       mode="reflect")
    p_len = audio_pad.shape[0] // WINDOW
    if if_f0:
        pitch_np, pitchf_np = _global_f0(pipeline, audio_pad, p_len,
                                         f0_up_key, f0_method, filter_radius)

    # the chunk table, with the sequential loop's boundary arithmetic
    spans = chunk_spans(audio_pad.shape[0], opt_ts, pipeline.t_pad2)
    lens = [length for _, length, _ in spans]
    n = len(spans)
    bucket = _bucket(max(lens))
    p_len_static = min(bucket // WINDOW, _feat_frames(bucket))
    n_data = mesh.shape["data"]
    n_pad = -(-n // n_data) * n_data
    audio_rows = np.zeros((n_pad, bucket), np.float32)
    true_len = np.full(n_pad, WINDOW, np.int64)   # filler rows: one frame
    pit_rows = np.zeros((n_pad, p_len_static), np.int32) if if_f0 else None
    pitf_rows = np.zeros((n_pad, p_len_static), np.float32) if if_f0 else None
    for i, (start, length, sl) in enumerate(spans):
        audio_rows[i, :length] = audio_pad[start: start + length]
        true_len[i] = length
        if if_f0:
            c, f = pitch_np[sl], pitchf_np[sl]
            m = min(p_len_static, c.shape[0])
            pit_rows[i, :m], pitf_rows[i, :m] = c[:m], f[:m]

    parts = []
    for rows, rep in zip(shard_bounds(n_pad, mesh),
                         replicas(pipeline, mesh)):
        for g0 in range(rows.start, rows.stop, ROWS_PER_CALL):
            grp = slice(g0, min(g0 + ROWS_PER_CALL, rows.stop))
            parts.append(_rows_int16(
                rep, audio_rows[grp], true_len[grp], sid,
                None if pit_rows is None else pit_rows[grp],
                None if pitf_rows is None else pitf_rows[grp], index,
                index_rate, protect, noise_seed))
    with span("fetch"):
        out = np.concatenate([p.cpu().numpy() for p in parts])

    # host assembly: trim each chunk's pads, join (reference :241, :295),
    # then the sequential path's last steps
    with span("assemble"):
        out = out.astype(np.float32) / 32767.0
        hop = math.prod(pipeline.synth.upsample_rates)
        t_pad_tgt = pipeline.t_pad_tgt
        pieces = []
        for i in range(n):
            y = out[i, : min(lens[i] // WINDOW, p_len_static) * hop]
            pieces.append(y[t_pad_tgt: y.shape[0] - t_pad_tgt])
        return pipeline.finish(np.concatenate(pieces), audio, rms_mix_rate,
                               resample_sr)
