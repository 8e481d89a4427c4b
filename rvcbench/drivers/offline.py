"""Offline conversion through `VC.vc_single`: one client in a closed loop,
converting one WAV file at a time.

The files are written in set-up from the seed at 16 kHz: `files_per_class`
voices of each length class, each shortened by one of `trims_s`, so every
seed converts the same lengths.  The window runs rounds of one file of
each class, in an order drawn from the seed, until `--seconds` have
passed; the file in progress then finishes, and the window ends with it.
`correct` compares, once the window has closed, one answer of each class
drawn from the seed with the reference's conversion of the same file.

RMVPE on the card is not bit-repeatable (its f0 moves by some 4e-7 from
one run to the next, the program's and the reference's alike), and its
track is quantised: a frame on a bin's edge, or a salience peak tied to
1e-7, takes either side, and the NSF source integrates the difference
into a phase that moves the rest of the file.  So the reference follows
the conversion from the f0 track the program's own call used (kept as
it passes to the synthesizer), and the f0 stage is checked by itself:
the reference's RMVPE on the same input against that track, by a high
percentile of the frames' gaps, and the coarse pitch against the
reference's quantisation of that track."""

from __future__ import annotations

import os
import time
from typing import Dict, List

import numpy as np
import torch

from rvcbench.lib import inputs, voices
from rvcbench.lib.compare import frame_errors, rel_l2, worst_median
from rvcbench.drivers.common import (Clock, nothing, phase, program_hubert,
                                     sync, write_files)
from rvcbench.ref.f0_device import post_process
from rvcbench.ref.offline import Offline, bucket, feat_frames
from rvcbench.ref.precision import precision

SR = 16000


class Driver:
    def __init__(self, cell: Dict, cfg: Dict, seed: int, device, tmp: str):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.device = torch.device(device)
        self.tmp = tmp
        self.x_pad = float(cell.get("x_pad", 3.0))
        self.kw = dict(f0_method=cell["f0_method"],
                       index_rate=cell["index_rate"],
                       filter_radius=cell["filter_radius"],
                       rms_mix_rate=cell["rms_mix_rate"],
                       protect=cell["protect"], f0_up_key=cell["f0_up_key"])

    # ---------------------------------------------------------------
    def _files(self) -> None:
        """The input files, `self.files[c][v]` = (path, samples)."""
        rng = np.random.default_rng(inputs.subseeds(self.seed, 6)[4])
        classes, trims = self.cell["classes_s"], self.cell["trims_s"]
        n_var = self.cell["files_per_class"]
        os.makedirs(os.path.join(self.tmp, "in"), exist_ok=True)
        self.files: List[List] = []
        for c, length in enumerate(classes):
            row = []
            order = rng.permutation(len(trims))
            for v in range(n_var):
                seconds = length - trims[order[v % len(trims)]]
                audio = voices.voice(seconds, int(rng.integers(2 ** 62)), SR,
                                     device=self.device)
                path = os.path.join(self.tmp, "in", f"c{c}_v{v}.wav")
                voices.write_wav(path, audio, SR)
                row.append((path, audio.shape[0]))
            self.files.append(row)
        self.order_rng = np.random.default_rng(
            inputs.subseeds(self.seed, 6)[5])

    def setup(self) -> None:
        from tpu_rvc_torch.pipeline.vc import VC
        from tpu_rvc_torch.retrieval.index import FeatureIndex

        cfg, clock = self.cfg, Clock()
        self.bundle = inputs.make(cfg, self.seed, self.device)
        clock.lap("weights")
        model, rmvpe_dir = write_files(self.bundle, cfg, self.tmp)
        clock.lap("files")
        hub = program_hubert(self.bundle, cfg, self.device)
        self.vc = VC(rmvpe_root=rmvpe_dir, x_pad=self.x_pad,
                     device=self.device)
        self.vc.get_vc(model, hubert=hub)
        self._keep_f0(self.vc.pipeline.synth)
        self.index = FeatureIndex(*self.bundle["index"])
        clock.lap("load")
        self._files()
        clock.lap("inputs")
        for row in self.files:           # every bucket the window uses
            self._convert(row[0][0])
        sync(self.device)
        clock.lap("warm")
        self.setup_laps = clock.laps

    def _keep_f0(self, synth) -> None:
        """Keep the (pitch, pitchf) each conversion hands the synthesizer
        (two copies on the card a call)."""
        infer = synth.infer
        self._f0 = None

        def keeping(phone, lengths, sid, pitch=None, pitchf=None, **kw):
            self._f0 = (pitch.clone(), pitchf.clone())
            return infer(phone, lengths, sid, pitch, pitchf, **kw)

        synth.infer = keeping

    def _convert(self, path: str) -> np.ndarray:
        _, (sr, out) = self.vc.vc_single(0, path, **self.kw, index=self.index)
        return out

    # ---------------------------------------------------------------
    def window(self, seconds: float, tracer) -> Dict:
        from tpu_rvc_torch.utils import timing

        traced = tracer is not None
        calls, outs, errors, tracks = [], [], [], []
        rounds = 0
        if traced:
            timing.enable()
        ctx = tracer if traced else nothing()
        with ctx:
            start = time.perf_counter()
            deadline = start + seconds
            while time.perf_counter() < deadline:
                order = self.order_rng.permutation(len(self.files))
                v = rounds % self.cell["files_per_class"]
                for c in order:
                    if time.perf_counter() >= deadline:
                        break
                    path, n = self.files[c][v]
                    self._f0 = None
                    t0 = time.perf_counter()
                    with phase(traced, f"rvcbench.convert.c{c}"):
                        try:
                            out = self._convert(path)
                        except Exception as e:  # counted, and not correct
                            out = None
                            errors.append(f"{type(e).__name__}: {e}")
                    calls.append({"class": int(c), "variant": v, "t0": t0,
                                  "t1": time.perf_counter(), "samples": n})
                    outs.append(out)
                    tracks.append(self._f0)
                rounds += 1
            end = time.perf_counter()
        spans = timing.read() if traced else {}
        timing.disable()
        tgt = self.cfg["data"]["sampling_rate"]
        done = [o for o in outs if o is not None]
        return {"window_s": end - start, "attempted": len(calls),
                "failed": len(calls) - len(done), "errors": errors[:3],
                "audio_s": sum(o.shape[0] for o in done) / tgt,
                "calls": calls, "outs": outs, "f0": tracks, "spans": spans}

    def release(self) -> None:
        del self.vc
        self.vc = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------
    def sample(self, rec: Dict) -> List[int]:
        """One finished call of each class, drawn from the seed: the
        longest class is always among them."""
        rng = np.random.default_rng(inputs.subseeds(self.seed, 7)[6])
        picks = []
        for c in range(len(self.files)):
            done = [i for i, k in enumerate(rec["calls"])
                    if k["class"] == c and rec["outs"][i] is not None]
            if done:
                picks.append(done[int(rng.integers(len(done)))])
        return picks

    def _reference(self, tf32: bool = False) -> Offline:
        hub, syn, rmv, index = inputs.reference_nets(self.bundle, self.cfg,
                                                     self.device)
        ref = Offline(hub, syn, rmv, index, self.device, x_pad=self.x_pad)
        ref.tf32 = tf32
        return ref

    def _path(self, rec: Dict, i: int) -> str:
        k = rec["calls"][i]
        return self.files[k["class"]][k["variant"]][0]

    def reference(self, rec: Dict, picks: List[int], ref: Offline,
                  follow: Dict = None) -> Dict[int, tuple]:
        """Each pick's (answer, f0 track) from `ref`, following the
        given tracks where `follow` has them."""
        kw = dict(self.kw)
        kw.pop("f0_method"), kw.pop("filter_radius")
        out = {}
        with precision(ref.tf32):
            for i in picks:
                out[i] = ref.convert(voices.read_wav(self._path(rec, i)),
                                     f0=None if follow is None else
                                     follow.get(i), **kw)
        return out

    def own_f0(self, rec: Dict, picks: List[int], ref: Offline) -> Dict:
        """The reference's own f0 track of each pick's input."""
        out = {}
        with precision(ref.tf32):
            for i in picks:
                pad, _ = ref.pad(voices.read_wav(self._path(rec, i)))
                out[i] = ref.f0(torch.as_tensor(pad, device=self.device)[None],
                                self.kw["f0_up_key"])
        return out

    def check(self, rec: Dict) -> List[Dict]:
        """The f0 stage (the reference's RMVPE against the tracks the
        program used) and the conversion (the reference following those
        tracks against the program's answers)."""
        picks = self.sample(rec)
        ref = self._reference()
        used = {i: rec["f0"][i] for i in picks if rec["f0"][i] is not None}
        want = self.reference(rec, picks, ref, follow=used)
        return compare(rec, picks, want, self.own_f0(rec, picks, ref),
                       used, self.cell["check"], len(self.files))

    def control(self, rec: Dict) -> List[Dict]:
        """The same comparison with the reference in TF32 in the
        program's place."""
        picks = self.sample(rec)
        got = self.reference(rec, picks, self._reference(tf32=True))
        ref = self._reference()
        used = {i: got[i][1] for i in picks}
        want = self.reference(rec, picks, ref, follow=used)
        fake = dict(rec, outs=[got[i][0] if i in got else None
                               for i in range(len(rec["outs"]))])
        return compare(fake, picks, want, self.own_f0(rec, picks, ref),
                       used, self.cell["check"], len(self.files))

    # ---------------------------------------------------------------
    def count(self, rec: Dict) -> Dict:
        """The window's work: the yardstick's FLOPs of each finished call,
        and each call's decoder geometry for the kernels' roofline."""
        from rvcbench.ref import count, models

        buckets: Dict[int, int] = {}
        for k, o in zip(rec["calls"], rec["outs"]):
            if o is not None:
                L = bucket(k["samples"] + 2 * int(SR * self.x_pad))
                buckets[L] = buckets.get(L, 0) + 1
        hk = models.hubert_kwargs(self.cfg["hubert"])
        flops = sum(n * count.offline_flops(
            self.bundle["config"], self.cfg["version"], hk, L,
            self.bundle["index"][0].shape[0], x_pad=self.x_pad)
            for L, n in buckets.items())
        decoder = [{"streams": 1, "frames": min(L // 160, feat_frames(L)),
                    "calls": n} for L, n in sorted(buckets.items())]
        return {"flops": flops, "decoder_calls": decoder,
                "flops_dtype": "tf32"}


def compare(rec: Dict, picks: List[int], want: Dict[int, tuple],
            own_f0: Dict, used_f0: Dict, limits: Dict,
            n_classes: int) -> List[Dict]:
    """`f0_p99`: the largest, over the picks, of the 99th percentile over
    frames of the f0 gap between the track the answer was made from and
    the reference's own, over the reference's f0 (1 Hz at least): it sees
    a fault on a few frames in a hundred (octave jumps, voicing at
    onsets), and lets the rare frame whose salience peaks tie to rounding
    take either side.  `coarse_off`: the frames whose coarse pitch, which
    the encoder embeds, is not the reference's quantisation of the f0 it
    was made with.  `frame_p50`: the largest, over the picks, of the
    answer's median frame gap of spectra to the reference's conversion
    from the same track, and `rel_l2`, the widest gap of samples; answers
    of the wrong length or missing count."""
    worst, bad_len, frames, f0_p99, coarse_off = 0.0, 0, [], 0.0, 0
    for i in picks:
        got, ref = rec["outs"][i], want[i][0]
        if got is None or got.shape != ref.shape or i not in used_f0:
            bad_len += 1
            continue
        pitch_used = used_f0[i][0].flatten()
        pf_used = used_f0[i][1].double().flatten()
        pf_ref = own_f0[i][1].double().flatten().to(pf_used.device)
        f0_p99 = max(f0_p99, float(torch.quantile(
            (pf_used - pf_ref).abs() / pf_ref.clamp(min=1.0), 0.99)))
        coarse, _ = post_process(used_f0[i][1].flatten().float(), 0.0)
        coarse_off += int((coarse.to(pitch_used.device) != pitch_used)
                          .sum())
        worst = max(worst, rel_l2(got, ref))
        frames.append(frame_errors(got, ref))
    return [
        {"name": "f0_p99", "value": f0_p99, "limit": limits["f0_p99"]},
        {"name": "coarse_off", "value": coarse_off, "limit": 0},
        {"name": "frame_p50", "value": worst_median(frames),
         "limit": limits["frame_p50"]},
        {"name": "rel_l2", "value": worst, "limit": limits["rel_l2"]},
        {"name": "answers_missing", "value": n_classes - len(picks) + bad_len,
         "limit": 0},
    ]
