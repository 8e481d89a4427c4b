"""Multi-stream serving through `SlotScheduler.tick` (serial mode): every
slot holds a live client whose next block is always queued, so ticks run
back to back, as in a server at capacity.

A client streams one voice from a pool made in set-up from the seed, for
a length from `client_s`; when its last block is delivered it leaves and
the next client takes its slot (a fresh stream).  Every tick converts one
block of every slot, so every seed does the same work.  The window runs
ticks until `--seconds` have passed.  `correct` compares, once the window
has closed, one finished client of each length drawn from the seed with
the reference's stream of the same blocks, whose SOLA takes the
program's offset where two offsets tie (`ref.stream.sola_follow`)."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from rvcbench.lib import inputs, voices
from rvcbench.lib.compare import frame_errors, worst_median
from rvcbench.drivers.common import (Clock, nothing, phase, program_hubert,
                                     sync, write_files)
from rvcbench.ref.precision import precision
from rvcbench.ref.stream import Geometry, Stream


class Driver:
    def __init__(self, cell: Dict, cfg: Dict, seed: int, device, tmp: str):
        self.cell, self.cfg, self.seed = cell, cfg, int(seed)
        self.device = torch.device(device)
        self.tmp = tmp
        self.n = int(cell["slots"])
        self.stream = dict(samplerate=cell["samplerate"],
                           block_time=cell["block_time"],
                           crossfade_time=cell["crossfade_time"],
                           extra_time=cell["extra_time"])
        self.geo = Geometry(**self.stream)

    def setup(self) -> None:
        from tpu_rvc_torch.models.loader import load_synthesizer
        from tpu_rvc_torch.pipeline.rt import RealtimeVC
        from tpu_rvc_torch.pipeline.serve import SlotScheduler
        from tpu_rvc_torch.retrieval.index import FeatureIndex

        cfg, cell, clock = self.cfg, self.cell, Clock()
        self.bundle = inputs.make(cfg, self.seed, self.device)
        clock.lap("weights")
        model, rmvpe_dir = write_files(self.bundle, cfg, self.tmp)
        clock.lap("files")
        synth, _ = load_synthesizer(model, self.device)
        engine = RealtimeVC(hubert=program_hubert(self.bundle, cfg,
                                                  self.device),
                            synth=synth, version=cfg["version"],
                            index=FeatureIndex(*self.bundle["index"]),
                            index_rate=cell["index_rate"],
                            rmvpe_root=rmvpe_dir, device=self.device)
        self.sched = SlotScheduler(engine, self.n, f0method=cell["f0_method"],
                                   protect=cell["protect"], **self.stream)
        self.steps = 0
        clock.lap("load")
        s = inputs.subseeds(self.seed, 8)
        rng = np.random.default_rng(s[4])
        longest = max(cell["client_s"])
        self.pool = [voices.voice(longest, int(rng.integers(2 ** 62)),
                                  self.geo.sr, device=self.device)
                     for _ in range(cell["voices"])]
        clock.lap("inputs")
        self.rng = np.random.default_rng(s[5])
        self.slots = [self.sched.attach() for _ in range(self.n)]
        for _ in range(cell["warm_ticks"]):   # the tick's one shape
            self._submit_all([np.zeros(self.geo.block_frame, np.float32)] *
                             self.n)
            self.sched.tick()
            self.steps += 1
            for slot in self.slots:
                self.sched.collect(slot)
        sync(self.device)
        clock.lap("warm")
        self.setup_laps = clock.laps

    def _submit_all(self, blocks) -> None:
        for slot, blk in zip(self.slots, blocks):
            self.sched.submit(slot, blk)

    def _client(self) -> Dict:
        """The next client: its length and its voice, from the seed."""
        lengths = self.cell["client_s"]
        seconds = lengths[int(self.rng.integers(len(lengths)))]
        v = int(self.rng.integers(len(self.pool)))
        n_blocks = int(round(seconds / self.geo.block_frame * self.geo.sr))
        return {"seconds": seconds, "voice": v, "n_blocks": n_blocks,
                "steps": [], "out": [], "slot": None}

    # ---------------------------------------------------------------
    def window(self, seconds: float, tracer) -> Dict:
        from tpu_rvc_torch.utils import timing

        traced = tracer is not None
        bf = self.geo.block_frame
        for slot in self.slots:        # the window's clients start fresh
            self.sched.detach(slot)
        self.slots = [self.sched.attach() for _ in range(self.n)]
        current = [self._client() for _ in range(self.n)]
        for s, c in enumerate(current):
            c["slot"] = s
        # stagger the first clients, so that slots change hands apart
        for s, c in enumerate(current):
            c["n_blocks"] -= s % max(1, c["n_blocks"] // 2)
        finished: List[Dict] = []
        tick_ms: List[float] = []
        delivered = 0

        def tick():
            nonlocal delivered
            for s, c in enumerate(current):
                i = len(c["out"])
                self.sched.submit(self.slots[s], self.pool[c["voice"]][
                    i * bf: (i + 1) * bf])
            t0 = time.perf_counter()
            with phase(traced, "rvcbench.tick"):
                self.sched.tick()
                outs = [self.sched.collect(slot) for slot in self.slots]
            ms = (time.perf_counter() - t0) * 1e3
            self.steps += 1
            with phase(traced, "rvcbench.clients"):
                for s, c in enumerate(current):
                    c["out"].append(outs[s])
                    c["steps"].append(self.steps)
                    delivered += len(outs[s])
                    if len(c["out"]) == c["n_blocks"]:
                        finished.append(c)
                        self.sched.detach(self.slots[s])
                        self.slots[s] = self.sched.attach()
                        current[s] = self._client()
                        current[s]["slot"] = self.slots[s]
            return ms

        if traced:
            timing.enable()
        ctx = tracer if traced else nothing()
        with ctx:
            start = time.perf_counter()
            while time.perf_counter() - start < seconds:
                tick_ms.append(tick())
            end = time.perf_counter()
        spans = timing.read() if traced else {}
        timing.disable()
        audio_s = delivered / self.geo.sr
        # answers due: a client of every length finished, ticking on past
        # the window (a minute at most) if none has yet
        late = time.perf_counter()
        while (len(self.sample(finished, draw=False)) < self.wanted()
               and time.perf_counter() - late < 60.0):
            tick()
        stats = self.sched.stats()
        return {"window_s": end - start, "attempted": len(tick_ms) * self.n,
                "failed": sum(1 for c in finished for o in c["out"]
                              if len(o) != bf), "errors": [],
                "audio_s": audio_s, "tick_ms": tick_ms,
                "finished": finished, "spans": spans,
                "underruns": int(sum(stats["underruns"]))}

    def release(self) -> None:
        del self.sched
        self.sched = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------------
    def sample(self, finished: List[Dict], draw: bool = True
               ) -> List[Dict]:
        """Two finished clients of each length, drawn from the seed (the
        first that fit with `draw` False): one from each half of the
        batch, one from an even slot and one from an odd, so that a fault
        in any half of the slots, by position or by parity, is seen.  The
        window's first clients were cut short to stagger the slots: they
        are not drawn."""
        rng = np.random.default_rng(inputs.subseeds(self.seed, 8)[6])
        half, picks = self.n // 2, []
        for j, seconds in enumerate(sorted(set(self.cell["client_s"]))):
            full = int(round(seconds * self.geo.sr / self.geo.block_frame))
            pool = [c for c in finished
                    if c["seconds"] == seconds and c["n_blocks"] == full]
            for side in (0, 1):
                parity = (j + side) % 2 if self.n >= 4 else side
                cand = [c for c in pool if c["slot"] % 2 == parity
                        and (c["slot"] >= half) == bool(side)
                        and c not in picks]
                if cand:
                    picks.append(cand[int(rng.integers(len(cand)))
                                      if draw else 0])
        return picks

    def wanted(self) -> int:
        return 2 * len(set(self.cell["client_s"])) if self.n > 1 else \
            len(set(self.cell["client_s"]))

    def reference(self, clients: List[Dict], tf32: bool = False,
                  follow: List[List[np.ndarray]] = None):
        """The reference's stream of each client; with `follow`, each
        client's delivered blocks, whose SOLA offsets it takes where they
        tie (`sola_follow`); `self.shortfalls` keeps, for each client, the
        largest share by which the offset nearest a delivered block scores
        below the best."""
        hub, syn, rmv, index = inputs.reference_nets(self.bundle, self.cfg,
                                                     self.device)
        ref = Stream(hub, syn, rmv, index, self.device, self.geo,
                     index_rate=self.cell["index_rate"],
                     protect=self.cell["protect"])
        bf = self.geo.block_frame
        out, self.shortfalls = [], []
        with precision(tf32):
            for j, c in enumerate(clients):
                audio = self.pool[c["voice"]]
                blocks = [audio[i * bf: (i + 1) * bf]
                          for i in range(c["n_blocks"])]
                out.append(np.concatenate(ref.run(
                    blocks, c["steps"], self.n, c["slot"],
                    follow=None if follow is None else follow[j],
                    tie=self.cell["sola_tie"])))
                self.shortfalls.append(max(ref.shortfalls, default=0.0))
        return out

    def check(self, rec: Dict) -> List[Dict]:
        picks = self.sample(rec["finished"])
        delivered = [c["out"] for c in picks]
        return compare([np.concatenate(d) for d in delivered],
                       self.reference(picks, follow=delivered), rec,
                       self.cell["check"], self.wanted())

    def control(self, rec: Dict) -> List[Dict]:
        picks = self.sample(rec["finished"])
        bf = self.geo.block_frame
        ctrl = self.reference(picks, tf32=True)
        delivered = [[s[i: i + bf] for i in range(0, len(s), bf)]
                     for s in ctrl]
        return compare(ctrl, self.reference(picks, follow=delivered), rec,
                       self.cell["check"], self.wanted())

    def count(self, rec: Dict) -> Dict:
        from rvcbench.ref import count, models

        ticks = len(rec["tick_ms"])
        per_tick = count.tick_flops(
            self.bundle["config"], self.cfg["version"],
            models.hubert_kwargs(self.cfg["hubert"]), self.geo, self.n,
            self.bundle["index"][0].shape[0])
        return {"flops": per_tick * ticks, "decoder_calls": [
            {"streams": self.n, "frames": self.geo.return_length,
             "calls": ticks}]}


def compare(got, want, rec: Dict, limits: Dict, wanted: int) -> List[Dict]:
    """The sampled clients' streams against the reference's, by each STFT
    frame's gap of magnitudes: the worst client's median frame
    (`frame_p50`), and the 90th percentile over every frame of the
    sampled clients (`frame_p90`).  A block's SOLA seam (its 40 ms
    crossfade, where a wrong offset or a missing fade shows) touches a
    third of a 48 kHz stream's 2048-sample frames: the median passes over
    it, the 90th percentile does not.  Magnitudes, not samples: where two
    offsets tie to rounding, SOLA takes either on the card, and a sound
    stream then runs on some samples out of line, with the same sound."""
    missing, frames = wanted - len(want), []
    for g, w in zip(got, want):
        if g.shape != w.shape:
            missing += 1
            continue
        frames.append(frame_errors(g, w))
    pooled = np.concatenate(frames) if frames else np.zeros(1)
    return [
        {"name": "frame_p50", "value": worst_median(frames),
         "limit": limits["frame_p50"]},
        {"name": "frame_p90", "value": float(np.percentile(pooled, 90)),
         "limit": limits["frame_p90"]},
        {"name": "clients_missing", "value": missing, "limit": 0},
        {"name": "underruns", "value": rec["underruns"], "limit": 0},
    ]
