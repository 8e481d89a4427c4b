"""Silence-based dataset slicer (this package's copy of
tpu_rvc/audio/slicer.py; reference infer/lib/slicer2.py:38).

Same segmentation semantics, reorganized: silent runs are found by
run-length encoding the thresholded RMS track, then each run is mapped to a
(cut_start, cut_end) pair at RMS minima.  Host-side numpy — this is dataset
prep, not a hot path.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def get_rms(y: np.ndarray, frame_length: int = 2048,
            hop_length: int = 512) -> np.ndarray:
    """librosa-style centered RMS track, (n_frames,)."""
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad))
    n = 1 + (len(yp) - frame_length) // hop_length
    idx = (np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :])
    frames = yp[idx]
    return np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1)).astype(
        np.float32)


class Slicer:
    """Split audio at long-enough silences, keeping <= max_sil_kept frames of
    silence on each side of a cut (parameters in ms as in the reference)."""

    def __init__(self, sr: int, threshold: float = -40.0,
                 min_length: int = 5000, min_interval: int = 300,
                 hop_size: int = 20, max_sil_kept: int = 5000):
        if not min_length >= min_interval >= hop_size:
            raise ValueError("need min_length >= min_interval >= hop_size")
        if not max_sil_kept >= hop_size:
            raise ValueError("need max_sil_kept >= hop_size")
        min_interval_samples = sr * min_interval / 1000
        self.threshold = 10 ** (threshold / 20.0)
        self.hop_size = round(sr * hop_size / 1000)
        self.win_size = min(round(min_interval_samples), 4 * self.hop_size)
        self.min_length = round(sr * min_length / 1000 / self.hop_size)
        self.min_interval = round(min_interval_samples / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept / 1000 / self.hop_size)

    def _cut(self, wav: np.ndarray, begin: int, end: int) -> np.ndarray:
        if wav.ndim > 1:
            return wav[:, begin * self.hop_size:
                       min(wav.shape[1], end * self.hop_size)]
        return wav[begin * self.hop_size: min(wav.shape[0], end * self.hop_size)]

    def _silent_runs(self, silent: np.ndarray):
        """Yield (start, end) for each maximal run of True, end exclusive."""
        padded = np.concatenate([[False], silent, [False]])
        d = np.diff(padded.astype(np.int8))
        starts = np.flatnonzero(d == 1)
        ends = np.flatnonzero(d == -1)
        return list(zip(starts, ends))

    def slice(self, waveform: np.ndarray) -> List[np.ndarray]:
        samples = waveform.mean(axis=0) if waveform.ndim > 1 else waveform
        if samples.shape[0] <= self.min_length:
            return [waveform]
        rms = get_rms(samples, self.win_size, self.hop_size)
        total = rms.shape[0]
        silent = rms < self.threshold
        msk = self.max_sil_kept

        def argmin_in(a: int, b: int) -> int:
            return int(rms[a:b + 1].argmin()) + a

        tags: List[Tuple[int, int]] = []
        clip_start = 0
        for s, e in self._silent_runs(silent):
            if e >= total:
                # trailing silence: cut and drop the tail
                if total - s >= self.min_interval:
                    pos = argmin_in(s, min(total - 1, s + msk))
                    tags.append((pos, total + 1))
                continue
            # e is the first non-silent frame after the run (the reference's i)
            leading = (s == 0 and e > msk)
            middle = (e - s >= self.min_interval and
                      e - clip_start >= self.min_length)
            if not leading and not middle:
                continue
            run = e - s
            if run <= msk:
                pos = argmin_in(s, e)
                if s == 0:
                    tags.append((0, pos))
                else:
                    tags.append((pos, pos))
                clip_start = pos
            elif run <= msk * 2:
                pos = argmin_in(e - msk, s + msk)
                pos_l = argmin_in(s, s + msk)
                pos_r = argmin_in(e - msk, e)
                if s == 0:
                    tags.append((0, pos_r))
                    clip_start = pos_r
                else:
                    tags.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_l = argmin_in(s, s + msk)
                pos_r = argmin_in(e - msk, e)
                if s == 0:
                    tags.append((0, pos_r))
                else:
                    tags.append((pos_l, pos_r))
                clip_start = pos_r
        if not tags:
            return [waveform]
        chunks = []
        if tags[0][0] > 0:
            chunks.append(self._cut(waveform, 0, tags[0][0]))
        for i in range(len(tags) - 1):
            chunks.append(self._cut(waveform, tags[i][1], tags[i + 1][0]))
        if tags[-1][1] < total:
            chunks.append(self._cut(waveform, tags[-1][1], total))
        return chunks
