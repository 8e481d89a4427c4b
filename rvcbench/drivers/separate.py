"""Whole-song separation through the web app's path
(`tpu_rvc_torch/apps/web.py` `uvr_convert`): `uvr5.load_separator(
<dir>/HP5_only_main_vocal.pth, agg)`, wrapped in `uvr5.DeviceSeparator`,
`separate(file)` a file with both int16 stems fetched to the host; one
client in a closed loop.

Set-up writes the checkpoint from the seed (`lib/uvr5_weights.py`) and
the songs (`lib/songs.py`): one 44.1 kHz stereo WAV for each length of
`classes_s` less each of `trims_s`, so every seed separates the same
lengths; it counts the yardstick's FLOPs of each bucket once and
separates one file of each class, which warms every bucket shape the
window uses.  The window runs rounds over every file, in orders drawn
from the seed, until `--seconds` have passed; the file in progress then
finishes, and the window ends with it.  `correct` compares, once the
window has closed, one answer of each class drawn from the seed with the
reference's separation of the same file (`ref/separate.py`), both stems."""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from rvcbench.drivers.common import Clock, nothing, phase, sync
from rvcbench.lib import inputs, songs
from rvcbench.lib.compare import frame_errors, rel_l2
from rvcbench.lib.uvr5_weights import hp5_state
from rvcbench.ref.count import counted
from rvcbench.ref.separate import Separator
from rvcbench.ref.uvr5 import CascadedASPPNet


class Driver:
    def __init__(self, cell: Dict, cfg: Dict, seed: int, device, tmp: str):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.device = torch.device(device)
        self.tmp = tmp
        self.sr = int(cell["sr"])

    # ---------------------------------------------------------------
    def _program(self, path: str):
        """What the web app builds for a VR checkpoint on a card."""
        from tpu_rvc_torch.pipeline import uvr5

        sep = uvr5.load_separator(path, agg=self.cfg["agg"],
                                  device=self.device)
        cfg = self.cfg
        mp = {**cfg["modelparams"],
              "band": {int(k): v for k, v in
                       cfg["modelparams"]["band"].items()}}
        stated = {"window_size": cfg["window_size"], "offset": cfg["offset"],
                  "tta": cfg["tta"], "swapped": False,
                  "high_end_process": cfg["high_end_process"]}
        loaded = {"window_size": sep.window_size, "offset": sep.model.offset,
                  "tta": sep.tta, "swapped": sep.is_reverse,
                  "high_end_process": sep.high_end_process}
        if loaded != stated or any(sep.mp.param[k] != v
                                   for k, v in mp.items()):
            raise ValueError(f"the program runs {loaded}, not the "
                             f"configuration's {stated} and pyramid")
        dev = uvr5.DeviceSeparator(sep)
        if dev.bucket_s != cfg["bucket_s"]:
            raise ValueError(f"bucket {dev.bucket_s} s, not "
                             f"{cfg['bucket_s']} s")
        return dev

    def _files(self) -> None:
        """`self.files[c][v]` = (path, samples), class c less trim v."""
        rng = np.random.default_rng(inputs.subseeds(self.seed, 16)[14])
        os.makedirs(os.path.join(self.tmp, "in"), exist_ok=True)
        self.files: List[List] = []
        for c, length in enumerate(self.cell["classes_s"]):
            row = []
            for v, trim in enumerate(self.cell["trims_s"]):
                mix = songs.song(length - trim, int(rng.integers(2 ** 62)),
                                 self.sr, self.device)
                path = os.path.join(self.tmp, "in", f"c{c}_v{v}.wav")
                songs.write_wav(path, mix, self.sr)
                row.append((path, mix.shape[0]))
            self.files.append(row)
        self.order_rng = np.random.default_rng(
            inputs.subseeds(self.seed, 16)[15])

    def bucket(self, samples: int) -> int:
        b = int(self.cfg["bucket_s"] * self.sr)
        return max(-(-samples // b), 1) * b

    def setup(self) -> None:
        clock = Clock()
        self.weights = os.path.join(self.tmp, "uvr5_weights",
                                    self.cfg["model_file"])
        os.makedirs(os.path.dirname(self.weights), exist_ok=True)
        torch.save(hp5_state(self.cfg, self.seed, self.device), self.weights)
        clock.lap("weights")
        self.sep = self._program(self.weights)
        clock.lap("load")
        self._files()
        clock.lap("inputs")
        self.flops = {}
        for row in self.files:
            for _, n in row:
                self.flops.setdefault(self.bucket(n), None)
        for L in self.flops:
            self.flops[L] = separation_flops(self.cfg, L)
        clock.lap("count")
        for row in self.files:           # every bucket the window uses
            self.sep.separate(row[0][0])
        sync(self.device)
        clock.lap("warm")
        self.setup_laps = clock.laps

    # ---------------------------------------------------------------
    def window(self, seconds: float, tracer) -> Dict:
        from tpu_rvc_torch.utils import timing

        traced = tracer is not None
        calls, outs, errors = [], [], []
        pairs = [(c, v) for c in range(len(self.files))
                 for v in range(len(self.files[c]))]
        if traced:
            timing.enable()
        ctx = tracer if traced else nothing()
        with ctx:
            start = time.perf_counter()
            deadline = start + seconds
            while time.perf_counter() < deadline:
                for k in self.order_rng.permutation(len(pairs)):
                    if time.perf_counter() >= deadline:
                        break
                    c, v = pairs[k]
                    path, n = self.files[c][v]
                    t0 = time.perf_counter()
                    with phase(traced, f"rvcbench.separate.c{c}"):
                        try:
                            ins, voc, _ = self.sep.separate(path)
                            out = (ins, voc)
                        except Exception as e:  # counted, and not correct
                            out = None
                            errors.append(f"{type(e).__name__}: {e}")
                    calls.append({"class": int(c), "variant": int(v),
                                  "t0": t0, "t1": time.perf_counter(),
                                  "samples": n})
                    outs.append(out)
            end = time.perf_counter()
        spans = timing.read() if traced else {}
        timing.disable()
        done = [k for k, o in zip(calls, outs) if o is not None]
        return {"window_s": end - start, "attempted": len(calls),
                "failed": len(calls) - len(done), "errors": errors[:3],
                "audio_s": sum(k["samples"] for k in done) / self.sr,
                "calls": calls, "outs": outs, "spans": spans}

    def release(self) -> None:
        del self.sep
        self.sep = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------
    def sample(self, rec: Dict) -> List[int]:
        """One finished call of each class, drawn from the seed."""
        rng = np.random.default_rng(inputs.subseeds(self.seed, 17)[16])
        picks = []
        for c in range(len(self.files)):
            done = [i for i, k in enumerate(rec["calls"])
                    if k["class"] == c and rec["outs"][i] is not None]
            if done:
                picks.append(done[int(rng.integers(len(done)))])
        return picks

    def _reference(self, tf32: bool = False) -> Separator:
        cfg = self.cfg
        net = CascadedASPPNet(cfg["modelparams"]["bins"] * 2, cfg["offset"])
        net.load_state_dict(torch.load(self.weights, map_location="cpu",
                                       weights_only=True))
        return Separator(net.to(self.device), cfg["modelparams"],
                         self.device, agg=cfg["agg"],
                         window_size=cfg["window_size"],
                         high_end_process=cfg["high_end_process"],
                         bucket_s=cfg["bucket_s"], tf32=tf32)

    def _separate(self, rec: Dict, picks: List[int], ref: Separator
                  ) -> Dict[int, tuple]:
        out = {}
        for i in picks:
            k = rec["calls"][i]
            ins, voc, _ = ref.separate(self.files[k["class"]][k["variant"]][0])
            out[i] = (ins, voc)
        return out

    def check(self, rec: Dict) -> List[Dict]:
        picks = self.sample(rec)
        want = self._separate(rec, picks, self._reference())
        return compare(rec["outs"], picks, want, self.cell["check"],
                       len(self.files))

    def control(self, rec: Dict) -> List[Dict]:
        """The same comparison with the reference in TF32 in the
        program's place."""
        picks = self.sample(rec)
        got = self._separate(rec, picks, self._reference(tf32=True))
        want = self._separate(rec, picks, self._reference())
        outs = [got.get(i) for i in range(len(rec["outs"]))]
        return compare(outs, picks, want, self.cell["check"],
                       len(self.files))

    # ---------------------------------------------------------------
    def count(self, rec: Dict) -> Dict:
        """The yardstick's FLOPs of every finished call of the window."""
        flops = sum(self.flops[self.bucket(k["samples"])]
                    for k, o in zip(rec["calls"], rec["outs"])
                    if o is not None)
        return {"flops": flops}


class _Windows(torch.nn.Module):
    """The net's stand-in for a count: its windows' output shape, no
    products, and the number of windows it was given."""

    def __init__(self, offset: int):
        super().__init__()
        self.offset, self.calls = offset, 0

    def predict(self, x, aggressiveness=None):
        self.calls += 1
        return x[:, :, :, self.offset:-self.offset]


def separation_flops(cfg: Dict, bucket_samples: int) -> int:
    """The products of the reference's separation of one file that fills
    a bucket of `bucket_samples` at the top band's rate, counted on the
    meta device: `Separator.flow` with the net's windows stood in for
    (the resample pyramid's convolutions both ways; the FFTs are not
    products), plus the windows it slid times one window's products
    through the net."""
    mp, window = cfg["modelparams"], cfg["window_size"]
    with torch.device("meta"):
        net = CascadedASPPNet(mp["bins"] * 2, cfg["offset"]).eval()
    stand_in = _Windows(cfg["offset"])
    ref = Separator(stand_in, mp, "meta", agg=cfg["agg"],
                    window_size=window,
                    high_end_process=cfg["high_end_process"],
                    bucket_s=cfg["bucket_s"])
    with torch.no_grad():
        rest = counted(ref.flow, torch.zeros(bucket_samples, device="meta"))
        one = counted(net.predict, torch.zeros(
            (1, 2, mp["bins"] + 1, window), device="meta"),
            {"value": cfg["agg"] / 100,
             "split_bin": mp["band"]["1"]["crop_stop"]})
    return rest + stand_in.calls * one


def compare(outs: List, picks: List[int], want: Dict[int, tuple],
            limits: Dict, n_classes: int) -> List[Dict]:
    """`frame_p50`: the largest, over the picks, their two stems and each
    stem's two channels, of the median frame gap of STFT magnitudes to
    the reference's (`lib/compare.py` `frame_errors`); `rel_l2`: the
    widest gap of samples, a stem's two channels together; answers of
    the wrong shape or missing count."""
    worst_frames, worst_l2, bad = 0.0, 0.0, 0
    for i in picks:
        got = outs[i]
        if got is None or any(g.shape != w.shape
                              for g, w in zip(got, want[i])):
            bad += 1
            continue
        for g, w in zip(got, want[i]):
            worst_l2 = max(worst_l2, rel_l2(g, w))
            for ch in range(w.shape[1]):
                worst_frames = max(worst_frames, float(np.median(
                    frame_errors(g[:, ch], w[:, ch]))))
    return [
        {"name": "frame_p50", "value": worst_frames,
         "limit": limits["frame_p50"]},
        {"name": "rel_l2", "value": worst_l2, "limit": limits["rel_l2"]},
        {"name": "answers_missing", "value": n_classes - len(picks) + bad,
         "limit": 0},
    ]
