"""The training batches worked out again from the dataset's files (frozen
from tpu_rvc_torch/train/data.py `RVCDataset` and `BucketBatcher`): a
filelist of "wav|feature.npy|f0.npy|f0nsf.npy|sid" rows, phone features
repeated 2x in time and capped at 900 frames, the cached spectrogram
beside each wav, batches of one bucket's rows padded to the bucket's
frames, the epoch's plan shuffled by numpy's generator seeded with
seed + epoch."""

from __future__ import annotations

import wave
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

BUCKETS = (100, 200, 300, 400, 500, 600, 700, 800, 900)


def _read_wav(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0


def _frames(path: str, hop: int) -> int:
    with wave.open(path, "rb") as w:
        return -(-w.getnframes() // hop)


class Batches:
    def __init__(self, filelist: str, hop: int, batch_size: int, seed: int,
                 buckets: Sequence[int] = BUCKETS):
        self.rows = [line.strip().split("|") for line in open(filelist)
                     if len(line.strip().split("|")) == 5]
        self.hop, self.batch_size, self.seed = hop, batch_size, seed
        self.buckets = tuple(buckets)
        self.n_frames = [_frames(r[0], hop) for r in self.rows]

    def _bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def plan(self, epoch: int) -> List[Tuple[int, List[int]]]:
        rng = np.random.default_rng(self.seed + epoch)
        order = rng.permutation(len(self.rows))
        by_bucket: Dict[int, List[int]] = {}
        for i in order:
            by_bucket.setdefault(self._bucket_of(
                min(self.n_frames[int(i)], 900)), []).append(int(i))
        plans = []
        for bucket, idxs in by_bucket.items():
            for s in range(0, len(idxs), self.batch_size):
                group = idxs[s:s + self.batch_size]
                while len(group) < self.batch_size:
                    group = group + group[: self.batch_size - len(group)]
                plans.append((bucket, group))
        return [plans[int(k)] for k in rng.permutation(len(plans))]

    def load(self, i: int) -> Dict:
        wav, feat, f0, f0nsf, sid = self.rows[i]
        phone = np.repeat(np.load(feat), 2, axis=0)
        n = min(phone.shape[0], 900)
        phone, pitch, pitchf = phone[:n], np.load(f0)[:n], np.load(f0nsf)[:n]
        audio = _read_wav(wav)
        spec = np.load(wav.replace(".wav", ".spec.npy"))
        m = min(phone.shape[0], spec.shape[0])
        return {"phone": phone[:m].astype(np.float32),
                "spec": spec[:m].astype(np.float32),
                "wave": audio[: m * self.hop].astype(np.float32),
                "sid": np.int32(sid), "n_frames": m,
                "pitch": pitch[:m].astype(np.int32),
                "pitchf": pitchf[:m].astype(np.float32)}

    def batch(self, bucket: int, group: List[int]) -> Dict[str, np.ndarray]:
        items = [self.load(i) for i in group]
        B, hop = len(items), self.hop
        D, F = items[0]["phone"].shape[1], items[0]["spec"].shape[1]
        out = {"phone": np.zeros((B, bucket, D), np.float32),
               "phone_lengths": np.zeros((B,), np.int32),
               "spec": np.zeros((B, bucket, F), np.float32),
               "spec_lengths": np.zeros((B,), np.int32),
               "wave": np.zeros((B, bucket * hop, 1), np.float32),
               "sid": np.zeros((B,), np.int32),
               "pitch": np.zeros((B, bucket), np.int32),
               "pitchf": np.zeros((B, bucket), np.float32)}
        for j, it in enumerate(items):
            n = min(it["n_frames"], bucket)
            out["phone"][j, :n] = it["phone"][:n]
            out["spec"][j, :n] = it["spec"][:n]
            out["wave"][j, :n * hop, 0] = it["wave"][:n * hop]
            out["phone_lengths"][j] = out["spec_lengths"][j] = n
            out["sid"][j] = it["sid"]
            out["pitch"][j, :n] = it["pitch"][:n]
            out["pitchf"][j, :n] = it["pitchf"][:n]
        return out

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        for bucket, group in self.plan(epoch):
            yield self.batch(bucket, group)
