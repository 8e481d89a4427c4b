"""Live duplex streaming machinery and the persisted realtime settings
(port of tpu_rvc/pipeline/live.py:38-215).

Plays the role of the reference's realtime GUI plumbing without depending
on any audio hardware package:

  - LiveConfig: user settings persisted to JSON across sessions
    (reference gui.py:176-247 load / :650-651 save of
    configs/inuse/config.json, including the same field set and defaults).
  - list_audio_devices: hostapi/device enumeration, gated on sounddevice
    (reference gui.py update_devices, :252-294).
  - LiveLoop: the device-callback <-> model-loop coupling through ring
    buffers with under/overrun accounting (reference AudioIoProcess,
    infer/lib/audio.py:206-376: double-buffered SharedMemory rings between
    the PortAudio process and the model loop; here the callback may run on
    any thread — sounddevice's, a test's, or a subprocess bridge).
    Mid-stream control (set_key / set_formant / set_index_rate) mirrors
    the GUI sliders wired at reference gui.py:518-592,700-760.

The loop needs no audio hardware: tests/test_torch_live.py feeds the
callback from the test's own thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Optional

import numpy as np

from tpu_rvc_torch.audio.native_ring import NativeRingBuffer


@dataclasses.dataclass
class LiveConfig:
    """Persisted realtime settings (field set of reference
    gui.py:218-241's config.json defaults)."""

    pth_path: str = ""
    index_path: str = ""
    sg_hostapi: str = ""
    sg_input_device: str = ""
    sg_output_device: str = ""
    sr_type: str = "sr_model"
    threhold: float = -60.0        # dB gate (reference spelling kept)
    pitch: float = 0.0
    formant: float = 0.0
    index_rate: float = 0.0
    rms_mix_rate: float = 0.0
    block_time: float = 0.25
    crossfade_length: float = 0.05
    extra_time: float = 2.5
    n_cpu: int = 4
    f0method: str = "rmvpe"
    use_pv: bool = False
    samplerate: int = 48000

    @classmethod
    def load(cls, path: str) -> "LiveConfig":
        """Load persisted settings; unknown keys are ignored and missing
        ones take defaults (reference gui.py:176-216 fallback behavior)."""
        cfg = cls()
        try:
            with open(path) as f:
                data = json.load(f)
            if not isinstance(data, dict):  # valid JSON, wrong shape
                return cfg
            fields = {f.name for f in dataclasses.fields(cls)}
            for k, v in data.items():
                if k in fields:
                    setattr(cfg, k, v)
        except (OSError, ValueError):
            pass
        return cfg

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)


def list_audio_devices():
    """Enumerate duplex-capable audio devices (reference update_devices,
    gui.py:252-294).  Returns {"hostapis": [...], "input": [...],
    "output": [...]} — empty lists when sounddevice/PortAudio is absent."""
    try:
        import sounddevice as sd
    except Exception:
        return {"hostapis": [], "input": [], "output": []}
    sd._terminate()
    sd._initialize()
    devices = sd.query_devices()
    hostapis = [h["name"] for h in sd.query_hostapis()]
    return {
        "hostapis": hostapis,
        "input": [d["name"] for d in devices
                  if d["max_input_channels"] > 0],
        "output": [d["name"] for d in devices
                   if d["max_output_channels"] > 0],
    }


class LiveLoop:
    """Couples a duplex audio callback to a StreamSession via ring buffers.

    The audio side calls `callback(indata, outdata)` per device block (any
    block size); the model side calls `process_available()` (typically in a
    loop/thread) which converts every full block queued in the input ring
    and writes the result to the output ring.  Short reads on the output
    ring emit silence and count as underruns (reference gui.py:1099-1126
    underrun recovery: the stream keeps running, output degrades to
    silence until the model catches up)."""

    def __init__(self, session, ring_blocks: int = 8,
                 threshold_db: Optional[float] = None):
        self.session = session
        bf = session.block_frame
        self.block_frame = bf
        self.in_ring = NativeRingBuffer(bf * ring_blocks)
        self.out_ring = NativeRingBuffer(bf * ring_blocks)
        self.threshold_db = threshold_db
        # rolling 40 ms history for the per-frame RMS gate (reference
        # gui.py:950-951 rms_buffer)
        self._rms_buffer = np.zeros(4 * session.zc, np.float32)
        self.blocks_processed = 0
        self._lock = threading.Lock()

    # ---- audio-thread side ----
    def callback(self, indata: np.ndarray, outdata: np.ndarray,
                 frames: int = None, t=None, status=None) -> None:
        """sounddevice-compatible duplex callback.  Accepts (N,) mono or
        (N, C) arrays; writes converted audio (or silence on underrun)
        into outdata."""
        mono = indata[:, 0] if indata.ndim == 2 else indata
        self.in_ring.write(np.asarray(mono, np.float32))
        out = self.out_ring.read(len(mono))
        if outdata.ndim == 2:
            outdata[:, 0] = out
            if outdata.shape[1] > 1:
                outdata[:, 1:] = out[:, None]
        else:
            outdata[:] = out

    # ---- model-thread side ----
    def _gate(self, block: np.ndarray) -> np.ndarray:
        """Zero sub-threshold 10 ms frames (reference gui.py:950-963).

        The gate MUTES quiet frames but the block is still fed to the
        session, so the rolling context windows and the SOLA seam keep
        advancing across silence — skipping the pipeline would butt
        pre-pause context against resumed speech and glitch the seam.
        Each frame's decision uses a 40 ms RMS window ending at the
        frame's end (rolling history across blocks, reference
        rms_buffer)."""
        zc = self.session.zc
        ext = np.concatenate([self._rms_buffer, block])
        self._rms_buffer = ext[-4 * zc:].copy()
        nf = len(block) // zc
        win = np.lib.stride_tricks.sliding_window_view(ext, 4 * zc)
        frames = win[zc::zc][:nf]  # frame i: ext[(i+1)*zc : (i+5)*zc]
        rms = np.sqrt(np.mean(frames.astype(np.float64) ** 2, axis=1))
        gated = 20 * np.log10(rms + 1e-12) < self.threshold_db
        if not gated.any():
            return block
        out = block.copy()
        mask = np.repeat(gated, zc)
        out[: len(mask)][mask] = 0.0
        return out

    def process_available(self) -> int:
        """Convert every complete queued block; returns blocks done."""
        n = 0
        while self.in_ring.readable() >= self.block_frame:
            block = self.in_ring.read(self.block_frame)
            if self.threshold_db is not None:
                block = self._gate(block)
            with self._lock:
                out = self.session.feed(block)
            self.out_ring.write(np.asarray(out, np.float32))
            self.blocks_processed += 1
            n += 1
        return n

    def run(self, stop_event: threading.Event, poll: float = 0.002) -> None:
        """Model loop until stop_event is set (reference gui.py soundinput
        loop role)."""
        while not stop_event.is_set():
            if not self.process_available():
                time.sleep(poll)

    # ---- mid-stream control (reference gui.py slider events) ----
    def set_key(self, key: float) -> None:
        with self._lock:
            self.session.set_key(key)

    def set_formant(self, formant: float) -> None:
        with self._lock:
            self.session.set_formant(formant)

    def set_index_rate(self, rate: float) -> None:
        with self._lock:
            self.session.set_index_rate(rate)

    def set_rms_mix_rate(self, rate: float) -> None:
        with self._lock:
            self.session.set_rms_mix_rate(rate)

    def stats(self) -> dict:
        s = {"blocks_processed": self.blocks_processed}
        s["in"] = self.in_ring.stats()
        s["out"] = self.out_ring.stats()
        return s
