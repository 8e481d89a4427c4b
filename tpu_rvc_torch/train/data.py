"""Training data pipeline (port of tpu_rvc/train/data.py:36-292;
reference infer/lib/train/data_utils.py and the filelist writer
web.py:383-449).  Host side, numpy.

Reference behaviours kept:
  - filelist rows "wav|feature.npy|f0.npy|f0nsf.npy|sid" (f0-less:
    "wav|feature.npy|sid"), +2 mute rows so tiny datasets always batch
    (web.py:434-445; the fixtures are this package's own copy,
    tpu_rvc_torch/assets/mute)
  - phone features repeated 2x in time, everything capped at 900 frames
  - linear spectrograms computed once (`ops/mel.py` `spectrogram`) and
    cached beside the wav (`.spec.npy`, as the JAX package names it)

As in the JAX package every batch is padded to its bucket's fixed upper
boundary (100..900 frames), rows of one process taken rank::world.  The
JAX package's `epoch_local_slice` (one slice of each global batch per
host) is not ported: it serves multi-process training (ROADMAP.md).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_rvc_torch.audio.io import load_wav
from tpu_rvc_torch.core.config import HParams
from tpu_rvc_torch.ops.mel import spectrogram
from tpu_rvc_torch.utils.timing import span

BUCKETS = (100, 200, 300, 400, 500, 600, 700, 800, 900)
MUTE_DIR = Path(__file__).parent.parent / "assets" / "mute"


def write_filelist(exp_dir: str, version: str, if_f0: bool, spk_id: int,
                   sr: str, out_name: str = "filelist.txt",
                   seed: int = 1234) -> str:
    """Compose the training filelist (reference web.py:383-449)."""
    exp = Path(exp_dir)
    gt = exp / "0_gt_wavs"
    feat_dir = exp / ("3_feature256" if version == "v1" else "3_feature768")
    f0_dir, f0nsf_dir = exp / "2a_f0", exp / "2b-f0nsf"
    names = (
        {p.stem for p in gt.glob("*.wav")} &
        {p.stem for p in feat_dir.glob("*.npy")}
    )
    if if_f0:
        names &= {p.name[:-8] for p in f0_dir.glob("*.wav.npy")} | \
                 {p.stem[:-4] if p.stem.endswith(".wav") else p.stem
                  for p in f0_dir.glob("*.npy")}
    rows = []
    for n in sorted(names):
        f0_name = f"{n}.wav.npy"
        if not (f0_dir / f0_name).exists():
            f0_name = f"{n}.npy"
        if if_f0:
            # BOTH f0 files must exist (reference web.py:395-400
            # intersects all four dirs) — a partially completed extract
            # run must drop the row here, not FileNotFoundError mid-epoch
            if not ((f0_dir / f0_name).exists()
                    and (f0nsf_dir / f0_name).exists()):
                continue
            rows.append(f"{gt / (n + '.wav')}|{feat_dir / (n + '.npy')}|"
                        f"{f0_dir / f0_name}|{f0nsf_dir / f0_name}|{spk_id}")
        else:
            rows.append(f"{gt / (n + '.wav')}|{feat_dir / (n + '.npy')}|{spk_id}")
    # 2 mute filler rows (web.py:434-445)
    fd = "3_feature256" if version == "v1" else "3_feature768"
    sr_tag = {32000: "32k", 40000: "40k", 48000: "48k"}.get(sr, sr)
    mute_wav = MUTE_DIR / "0_gt_wavs" / f"mute{sr_tag}.wav"
    mute_feat = MUTE_DIR / fd / "mute.npy"
    for _ in range(2):
        if if_f0:
            rows.append(f"{mute_wav}|{mute_feat}|"
                        f"{MUTE_DIR / '2a_f0' / 'mute.wav.npy'}|"
                        f"{MUTE_DIR / '2b-f0nsf' / 'mute.wav.npy'}|{spk_id}")
        else:
            rows.append(f"{mute_wav}|{mute_feat}|{spk_id}")
    rng = np.random.default_rng(seed)
    rng.shuffle(rows)
    out = exp / out_name
    out.write_text("\n".join(rows) + "\n")
    return str(out)


def _wav_frames(path: str, hop: int) -> int:
    """Exact spectrogram-frame count from the WAV header (sample count //
    hop, rounded up).  Header-only read — no audio decode.  A slight
    over-estimate is harmless (the item lands in a larger bucket and is
    zero-padded + masked); an UNDER-estimate silently truncates training
    audio at collate time, so file-size guessing is not acceptable."""
    import wave as _wave
    try:
        with _wave.open(path, "rb") as w:
            return -(-w.getnframes() // hop)
    except Exception:
        # non-PCM container: assume 16-bit mono and round up
        return -(-os.path.getsize(path) // (2 * hop))


@dataclass
class Item:
    wav_path: str
    feat_path: str
    f0_path: Optional[str]
    f0nsf_path: Optional[str]
    sid: int
    n_frames: int  # exact, from the wav header (see _wav_frames)


class RVCDataset:
    """Lazy per-utterance loader with spec caching."""

    def __init__(self, filelist: str, hp: HParams, if_f0: bool = True):
        self.hp = hp
        self.if_f0 = if_f0
        self.items: List[Item] = []
        for line in open(filelist):
            parts = line.strip().split("|")
            if len(parts) < 3:
                continue
            if if_f0:
                wav, feat, f0, f0nsf, sid = parts
            else:
                wav, feat, sid = parts
                f0 = f0nsf = None
            n_frames = _wav_frames(wav, hp.data.hop_length)
            self.items.append(Item(wav, feat, f0, f0nsf, int(sid), n_frames))

    def __len__(self):
        return len(self.items)

    def load(self, i: int) -> Dict[str, np.ndarray]:
        # host-side item cache (reference if_cache_data_in_gpu role,
        # train.py:425-501): fine-tune datasets are ~10 min of audio, so
        # whole-dataset caching is cheap and removes disk + spectrogram work
        # from every epoch after the first
        if not hasattr(self, "_cache"):
            self._cache = {}
        if i in self._cache:
            return self._cache[i]
        out = self._load(i)
        if len(self._cache) < 2048:
            self._cache[i] = out
        return out

    def _load(self, i: int) -> Dict[str, np.ndarray]:
        it = self.items[i]
        d = self.hp.data
        phone = np.load(it.feat_path)
        phone = np.repeat(phone, 2, axis=0)
        if self.if_f0:
            pitch = np.load(it.f0_path)
            pitchf = np.load(it.f0nsf_path)
        else:
            pitch = pitchf = None
        n = min(phone.shape[0], 900)
        phone = phone[:n]
        if self.if_f0:
            pitch, pitchf = pitch[:n], pitchf[:n]

        audio, sr = load_wav(it.wav_path)
        if sr != d.sampling_rate:
            raise ValueError(f"{it.wav_path}: {sr} != {d.sampling_rate}")
        spec_path = it.wav_path.replace(".wav", ".spec.npy")
        spec = None
        if os.path.exists(spec_path):
            try:
                spec = np.load(spec_path)
                # reject caches written under a different STFT config
                if spec.ndim != 2 or spec.shape[1] != d.filter_length // 2 + 1:
                    spec = None
            except Exception:
                spec = None
        if spec is None:
            with torch.no_grad():
                s = spectrogram(torch.from_numpy(audio[None]),
                                d.filter_length, d.hop_length, d.win_length)
            spec = s[0].T.numpy()  # (T, F) channel-last
            try:
                np.save(spec_path, spec, allow_pickle=False)
            except OSError:
                pass
        n_min = min(phone.shape[0], spec.shape[0])
        out = {
            "phone": phone[:n_min].astype(np.float32),
            "spec": spec[:n_min].astype(np.float32),
            "wave": audio[: n_min * d.hop_length].astype(np.float32),
            "sid": np.int32(it.sid),
            "n_frames": n_min,
        }
        if self.if_f0:
            out["pitch"] = pitch[:n_min].astype(np.int32)
            out["pitchf"] = pitchf[:n_min].astype(np.float32)
        return out


class BucketBatcher:
    """Fixed-shape bucketed batches (reference DistributedBucketSampler,
    data_utils.py:401): a bounded set of shapes, so the caching allocator
    and cuDNN's plans see the same few shapes every epoch."""

    def __init__(self, dataset: RVCDataset, batch_size: int,
                 buckets: Sequence[int] = BUCKETS, rank: int = 0,
                 world: int = 1, seed: int = 1234,
                 min_frames: Optional[int] = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.buckets = tuple(buckets)
        self.rank, self.world, self.seed = rank, world, seed
        self.min_frames = min_frames or 0

    def _bucket_of(self, n_frames: int) -> int:
        for b in self.buckets:
            if n_frames <= b:
                return b
        return self.buckets[-1]

    def _plans(self, epoch_idx: int, rank: int,
               world: int) -> List[Tuple[int, List[int]]]:
        """Shuffled (bucket, row-ids) batch plan for one epoch."""
        rng = np.random.default_rng(self.seed + epoch_idx)
        order = rng.permutation(len(self.ds))[rank::world]
        by_bucket: Dict[int, List[int]] = {}
        for i in order:
            n = self.ds.items[int(i)].n_frames
            if n < self.min_frames:
                continue  # too short to slice a training segment from
            by_bucket.setdefault(self._bucket_of(min(n, 900)), []).append(int(i))
        # plan all batches first, then shuffle ACROSS buckets so an epoch
        # is not sorted short-to-long (reference DistributedBucketSampler
        # permutes its final batch list, data_utils.py:449)
        plans: List[Tuple[int, List[int]]] = []
        for bucket, idxs in by_bucket.items():
            for s in range(0, len(idxs), self.batch_size):
                group = idxs[s:s + self.batch_size]
                while len(group) < self.batch_size:  # cycle-pad small tails
                    group = group + group[: self.batch_size - len(group)]
                plans.append((bucket, group))
        return [plans[int(k)] for k in rng.permutation(len(plans))]

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        for bucket, group in self._plans(epoch_idx, self.rank, self.world):
            yield self._collate(self._load(group), bucket)

    def epoch_local_slice(self, epoch_idx: int, rank: int,
                          world: int) -> Iterator[Dict[str, np.ndarray]]:
        """One process's part of a data-parallel epoch
        (tpu_rvc/train/data.py:246-263): every process derives the same
        global plan (same seed, same dataset on every host, as the
        reference's DistributedBucketSampler requires) and yields its rows
        `rank::world` of each global batch, so all step through the same
        number of batches of the same shapes, and each loads 1/world of
        the rows."""
        if self.batch_size % world != 0:
            raise ValueError(
                f"global batch_size {self.batch_size} not divisible by "
                f"process count {world}")
        for bucket, group in self._plans(epoch_idx, 0, 1):
            yield self._collate(self._load(group[rank::world]), bucket)

    def _load(self, group: List[int]) -> List[Dict]:
        with span("load"):
            return [self.ds.load(i) for i in group]

    def _collate(self, items: List[Dict], bucket: int) -> Dict[str, np.ndarray]:
        with span("collate"):
            B = len(items)
            d = self.ds.hp.data
            D = items[0]["phone"].shape[1]
            F = items[0]["spec"].shape[1]
            batch = {
                "phone": np.zeros((B, bucket, D), np.float32),
                "phone_lengths": np.zeros((B,), np.int32),
                "spec": np.zeros((B, bucket, F), np.float32),
                "spec_lengths": np.zeros((B,), np.int32),
                "wave": np.zeros((B, bucket * d.hop_length, 1), np.float32),
                "sid": np.zeros((B,), np.int32),
            }
            if self.ds.if_f0:
                batch["pitch"] = np.zeros((B, bucket), np.int32)
                batch["pitchf"] = np.zeros((B, bucket), np.float32)
            for j, it in enumerate(items):
                n = min(it["n_frames"], bucket)
                batch["phone"][j, :n] = it["phone"][:n]
                batch["spec"][j, :n] = it["spec"][:n]
                w = n * d.hop_length
                batch["wave"][j, :w, 0] = it["wave"][:w]
                batch["phone_lengths"][j] = n
                batch["spec_lengths"][j] = n
                batch["sid"][j] = it["sid"]
                if self.ds.if_f0:
                    batch["pitch"][j, :n] = it["pitch"][:n]
                    batch["pitchf"][j, :n] = it["pitchf"][:n]
            return batch
