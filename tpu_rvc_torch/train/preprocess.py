"""Dataset preprocessing (port of tpu_rvc/train/preprocess.py; reference
infer/modules/train/preprocess.py).  Host side, numpy and scipy.

Per input file: decode at the experiment SR, 48 Hz high-pass (lfilter — the
reference deliberately avoids filtfilt's pre-ringing, preprocess.py:93),
silence-slice, window into `per`-second segments with 0.3 s overlap,
peak/alpha normalize (max 0.9, alpha 0.75 blend, preprocess.py:62-66), and
write the gt-SR wav plus a 16 kHz copy.

Parallelism: a thread pool over files (decode + slicing are
numpy/host-bound; no fork needed — the reference spawns processes because
of the GIL-heavy PyAV decode, preprocess.py:110-135).
"""

from __future__ import annotations

import math
import os
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy import signal as sps
from scipy.signal import resample_poly

from tpu_rvc_torch.audio.io import load_audio, save_wav
from tpu_rvc_torch.audio.slicer import Slicer


class PreProcess:
    def __init__(self, sr: int, exp_dir: str, per: float = 3.7):
        self.slicer = Slicer(sr=sr, threshold=-42, min_length=1500,
                             min_interval=400, hop_size=15, max_sil_kept=500)
        self.sr = sr
        self.bh, self.ah = sps.butter(N=5, Wn=48, btype="high", fs=sr)
        self.per = per
        self.overlap = 0.3
        self.tail = self.per + self.overlap
        self.max = 0.9
        self.alpha = 0.75
        self.exp_dir = exp_dir
        self.gt_wavs_dir = os.path.join(exp_dir, "0_gt_wavs")
        self.wavs16k_dir = os.path.join(exp_dir, "1_16k_wavs")
        os.makedirs(self.gt_wavs_dir, exist_ok=True)
        os.makedirs(self.wavs16k_dir, exist_ok=True)
        self.log_path = os.path.join(exp_dir, "preprocess.log")

    def _log(self, msg: str):
        with open(self.log_path, "a") as f:
            f.write(msg + "\n")

    def norm_write(self, seg: np.ndarray, idx0, idx1) -> None:
        tmp_max = np.abs(seg).max()
        if tmp_max > 2.5:
            self._log(f"{idx0}-{idx1}-{tmp_max}-filtered")
            return
        seg = (seg / tmp_max * (self.max * self.alpha) +
               (1 - self.alpha) * seg)
        save_wav(os.path.join(self.gt_wavs_dir, f"{idx0}_{idx1}.wav"),
                 seg.astype(np.float32), self.sr)
        g = math.gcd(self.sr, 16000)
        seg16 = resample_poly(seg, 16000 // g, self.sr // g).astype(np.float32)
        save_wav(os.path.join(self.wavs16k_dir, f"{idx0}_{idx1}.wav"),
                 seg16, 16000)

    def process_file(self, path: str, idx0) -> None:
        try:
            audio = load_audio(path, self.sr)
            audio = sps.lfilter(self.bh, self.ah, audio).astype(np.float32)
            idx1 = 0
            for sliced in self.slicer.slice(audio):
                i = 0
                while True:
                    start = int(self.sr * (self.per - self.overlap) * i)
                    i += 1
                    if len(sliced[start:]) > self.tail * self.sr:
                        seg = sliced[start: start + int(self.per * self.sr)]
                        self.norm_write(seg, idx0, idx1)
                        idx1 += 1
                    else:
                        seg = sliced[start:]
                        idx1 += 1
                        break
                self.norm_write(seg, idx0, idx1)
            self._log(f"{path}\t-> Success")
        except Exception:
            self._log(f"{path}\t-> {traceback.format_exc()}")

    def run(self, inp_root: str, n_workers: int = 8) -> None:
        files = sorted(os.listdir(inp_root))
        jobs = [(os.path.join(inp_root, name), idx)
                for idx, name in enumerate(files)]
        if n_workers <= 1:
            for path, idx in jobs:
                self.process_file(path, idx)
        else:
            with ThreadPoolExecutor(n_workers) as ex:
                list(ex.map(lambda j: self.process_file(*j), jobs))


def preprocess_dataset(inp_root: str, sr: int, n_p: int, exp_dir: str,
                       per: float = 3.7) -> None:
    """CLI-compatible entry (reference argv protocol preprocess.py:10-15)."""
    PreProcess(sr, exp_dir, per).run(inp_root, n_p)
