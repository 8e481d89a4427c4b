"""Multi-client realtime serving core: N streaming voice-conversion
sessions advanced by one batched block on the device per tick (port of
tpu_rvc/pipeline/serve.py:44-357).

The reference's realtime engine is single-user, one `gui.py`/rtrvc process
per person (infer/lib/rtrvc.py:19).  Here the streams of many clients are
one batch: every stage of the block, both CUDA kernels included, takes the
N streams in one call.

  SlotScheduler owns a FusedStreamGraph(n_streams=N) plus per-slot host
    state (rolling input window, SOLA seam buffer, queues).  Clients
    attach() to a slot, submit() PCM of any size and collect() converted
    PCM; tick() pops one block per slot that is ready (or overdue: silence
    and an underrun count), runs the one batched block, and SOLA-merges
    each slot's seam on its own (gui.py:1058-1090 math, rt.sola_merge).

Threading contract: socket threads call submit/collect/attach/detach under
the scheduler lock; ONE scheduler thread calls tick().  The device state
belongs to the tick thread alone: attach() only marks a slot for reset,
and tick() zeroes that slot's state rows before the next block.

The TCP front end is tpu_rvc_torch/apps/serve.py.  Everything here runs on
the CPU too (`device="cpu"` engines), which is how the tests drive it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from tpu_rvc_torch.pipeline.rt import (BlockGeometry, FusedStreamGraph,
                                       RealtimeVC, sola_merge)
from tpu_rvc_torch.utils.timing import span


class _ChunkQueue:
    """Queue of PCM chunks with O(1) append and popleft and O(popped)
    assembly: no whole-buffer reallocation per small submit under the
    shared scheduler lock."""

    def __init__(self):
        self._chunks: Deque[np.ndarray] = deque()
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, pcm: np.ndarray) -> None:
        if len(pcm):
            self._chunks.append(pcm)
            self._len += len(pcm)

    def pop(self, n: Optional[int] = None) -> np.ndarray:
        """Pop up to n samples (all queued when n is None)."""
        if n is not None and n <= 0:
            return np.zeros(0, np.float32)
        if n is None or n >= self._len:
            out = (np.concatenate(self._chunks) if self._chunks
                   else np.zeros(0, np.float32))
            self.clear()
            return out
        taken, got = [], 0
        while got < n:
            c = self._chunks[0]
            need = n - got
            if len(c) <= need:
                taken.append(self._chunks.popleft())
                got += len(c)
            else:
                taken.append(c[:need])
                self._chunks[0] = c[need:]
                got = n
        self._len -= n
        return np.concatenate(taken)

    def clear(self) -> None:
        self._chunks, self._len = deque(), 0


class _Fetch:
    """One block's audio on its way from the device to the host, started
    without waiting for it.  On a card: a copy into a pinned host buffer on
    a side stream, behind the work queued so far, and an event recorded
    after it; `result()` waits on that event only.  The tick thread goes
    on to prepare and queue the next block meanwhile.  Without a side
    stream (serial mode, or an engine on the CPU, where the audio is host
    memory already) `result()` waits for the card and copies."""

    def __init__(self, out: torch.Tensor, side_stream=None):
        self._done = None
        if side_stream is None:
            self._host = out
            return
        self._host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        side_stream.wait_stream(torch.cuda.current_stream(out.device))
        with torch.cuda.stream(side_stream):
            self._host.copy_(out, non_blocking=True)
            self._done = torch.cuda.Event()
            self._done.record(side_stream)
        out.record_stream(side_stream)

    def result(self) -> np.ndarray:
        with span("fetch"):
            if self._done is not None:
                self._done.synchronize()
            return self._host.cpu().numpy()


class SlotScheduler:
    """Batched streaming server core of fixed capacity.

    All slots share one engine (weights, retrieval index, conversion
    settings); pitch caches, rolling windows and SOLA seams are per slot.

    clock: injectable monotonic time source.  The underrun cadence ("a
    started slot is fed silence once it is a full block_time past its last
    feed") compares clock() readings; tests pass a hand-advanced clock, so
    that slow ticks cannot fake starvation.

    pipelined=True: tick k's device-to-host fetch overlaps tick k+1's host
    work and the queueing of its block (`_Fetch`).  One more block of
    delivery latency buys a tick whose critical path is the longer of the
    device's work and the host's, not their sum.  Delivery stays in order,
    so the SOLA seams are those of serial mode, sample for sample.
    """

    def __init__(self, engine: RealtimeVC, n_slots: int,
                 samplerate: int = 48000, block_time: float = 0.25,
                 crossfade_time: float = 0.05, extra_time: float = 2.5,
                 f0method: str = "rmvpe", protect: float = 1.0,
                 clock=time.monotonic, pipelined: bool = False):
        self._clock = clock
        self.engine = engine
        self.n_slots = int(n_slots)
        # the frame geometry StreamSession uses (rt.BlockGeometry)
        geo = BlockGeometry(samplerate, block_time, crossfade_time,
                            extra_time)
        self.geometry = geo
        self.sr = samplerate
        self.block_time = float(block_time)
        self.zc = geo.zc
        self.block_frame = geo.block_frame
        self.crossfade_frame = geo.crossfade_frame
        self.sola_buffer_frame = geo.sola_buffer_frame
        self.sola_search_frame = geo.sola_search_frame
        self.extra_frame = geo.extra_frame
        self.total = geo.total
        self.fused = FusedStreamGraph(
            engine, stream_sr=samplerate, block_frame=self.block_frame,
            ctx_frame=2 * geo.zc, total_len=geo.total,
            skip_head=geo.skip_head, return_length=geo.return_length,
            f0method=f0method, protect=protect, n_streams=self.n_slots)
        self.state = self.fused.init_state()
        self.fade_in = geo.fade_in
        self.fade_out = geo.fade_out

        self._lock = threading.Lock()
        self.active = [False] * self.n_slots
        # a slot joins the underrun accounting with its first submit():
        # the gap between attach and the first block is not starvation
        self.started = [False] * self.n_slots
        # device-state resets asked for by attach(), applied by tick()
        self._pending_reset: set = set()
        # bumped by attach(): a block's output goes only to the generation
        # that was attached when its input was consumed, so a detach and
        # attach during the (unlocked) block can never hand the previous
        # client's audio to the new one
        self._gen = [0] * self.n_slots
        self.input_wav = np.zeros((self.n_slots, geo.total), np.float32)
        self.sola_buffers = np.zeros(
            (self.n_slots, self.sola_buffer_frame), np.float32)
        self._in_buf = [_ChunkQueue() for _ in range(self.n_slots)]
        self._out_buf = [_ChunkQueue() for _ in range(self.n_slots)]
        # per-slot block cadence: a started slot is fed silence (an
        # underrun) only once it is a full block_time past its last feed,
        # so clients out of phase do not starve each other when another
        # slot's readiness triggers a tick
        self._last_fed = [0.0] * self.n_slots
        self.underruns = [0] * self.n_slots
        self.blocks = [0] * self.n_slots
        self.ticks = 0
        self.pipelined = bool(pipelined)
        self._inflight = None  # (_Fetch, fed list, generations)
        self._side_stream = None
        if self.pipelined and engine.device.type == "cuda":
            self._side_stream = torch.cuda.Stream(engine.device)

    # ---- client-thread side ------------------------------------------
    def attach(self) -> int:
        """Claim a free slot; resets its host state and asks for its
        device state to be reset in the next tick.  Raises RuntimeError
        when the server is full."""
        with self._lock:
            for s in range(self.n_slots):
                if not self.active[s]:
                    self.active[s] = True
                    self.started[s] = False
                    self._gen[s] += 1
                    self._in_buf[s].clear()
                    self._out_buf[s].clear()
                    self.input_wav[s] = 0.0
                    self.sola_buffers[s] = 0.0
                    self.underruns[s] = 0
                    self.blocks[s] = 0
                    self._pending_reset.add(s)
                    return s
        raise RuntimeError(f"server full ({self.n_slots} slots)")

    def detach(self, slot: int) -> None:
        with self._lock:
            self.active[slot] = False

    def submit(self, slot: int, pcm: np.ndarray) -> None:
        """Queue input PCM (float32 mono at `samplerate`, any length)."""
        pcm = np.asarray(pcm, np.float32).reshape(-1)
        with self._lock:
            self._in_buf[slot].push(pcm)
            if not self.started[slot]:
                self.started[slot] = True
                self._last_fed[slot] = self._clock()

    def collect(self, slot: int, max_samples: Optional[int] = None
                ) -> np.ndarray:
        """Pop converted PCM queued for this slot (possibly empty)."""
        with self._lock:
            return self._out_buf[slot].pop(max_samples)

    def pending(self, slot: int) -> int:
        with self._lock:
            return len(self._in_buf[slot])

    def ready(self) -> bool:
        """True when at least one active slot has a full block queued or
        is overdue for its silence block."""
        now = self._clock()
        with self._lock:
            return any(
                self.active[s] and
                (len(self._in_buf[s]) >= self.block_frame
                 or (self.started[s]
                     and now - self._last_fed[s] >= self.block_time))
                for s in range(self.n_slots))

    # ---- scheduler-thread side ---------------------------------------
    def tick(self) -> Dict[str, object]:
        """Advance every due session by one block with one batched call.

        A slot consumes a queued block when it has one; a started slot a
        full block_time past its last feed gets silence and an underrun
        count (the stream must keep its realtime cadence, reference
        gui.py:1099-1126).  Slots that are idle or not due yet ride along
        as zeros with their device state frozen (`fed` false)."""
        with span("tick", root=True):
            bf = self.block_frame
            now = self._clock()
            with span("pop"), self._lock:
                resets = sorted(self._pending_reset)
                self._pending_reset.clear()
                fed: List[bool] = []
                for s in range(self.n_slots):
                    if self.active[s] and len(self._in_buf[s]) >= bf:
                        block = self._in_buf[s].pop(bf)
                        self._last_fed[s] = now
                        fed.append(True)
                    elif (self.active[s] and self.started[s]
                          and now - self._last_fed[s] >= self.block_time):
                        block = np.zeros(bf, np.float32)
                        self.underruns[s] += 1
                        self._last_fed[s] = now
                        fed.append(True)
                    else:
                        fed.append(False)
                        continue
                    self.input_wav[s, :-bf] = self.input_wav[s, bf:]
                    self.input_wav[s, -bf:] = block
                # a copy: the block below runs unlocked and must not see a
                # concurrent attach() zeroing a row
                seg = self.input_wav[:, -bf - 2 * self.zc:].copy()
                gen = list(self._gen)

            # the device state is touched ONLY here, on the tick thread
            for s in resets:
                for v in self.state.values():
                    (v if self.n_slots == 1 else v[s]).zero_()
            if not any(fed):  # nothing due: no block
                self._drain_inflight()  # deliver a pending pipelined block
                return self._count_tick()
            if self.n_slots == 1:
                out, self.state = self.fused(self.state, seg[0], fed=fed[0],
                                             fetch=False)
                out = out[None]
            else:
                out, self.state = self.fused(self.state, seg,
                                             fed=np.asarray(fed), fetch=False)
            fetch = _Fetch(out, self._side_stream)
            if self.pipelined:
                # this tick's fetch is on its way; deliver LAST tick's block
                self._inflight, prev = (fetch, fed, gen), self._inflight
                if prev is not None:
                    self._deliver(prev[0].result(), prev[1], prev[2])
            else:
                self._deliver(fetch.result(), fed, gen)
            return self._count_tick()

    def _count_tick(self) -> Dict[str, object]:
        with self._lock:
            self.ticks += 1
            return self.stats_locked()

    def flush(self) -> None:
        """Deliver the pipelined block in flight, if any (call at shutdown
        or when pausing the tick thread)."""
        self._drain_inflight()

    def _drain_inflight(self) -> None:
        if self._inflight is None:
            return
        fetch, fed, gen = self._inflight
        self._inflight = None
        self._deliver(fetch.result(), fed, gen)

    def _deliver(self, out: np.ndarray, fed, gen) -> None:
        """SOLA-merge and queue one block's output (tick thread only)."""
        bf = self.block_frame
        with span("sola"), self._lock:
            for s in range(self.n_slots):
                # a slot attached anew during the block must not get the
                # previous occupant's audio
                if not (self.active[s] and fed[s]
                        and self._gen[s] == gen[s]):
                    continue
                merged, self.sola_buffers[s] = sola_merge(
                    out[s], self.sola_buffers[s], self.fade_in,
                    self.fade_out, bf, self.sola_buffer_frame,
                    self.sola_search_frame)
                self._out_buf[s].push(merged)
                self.blocks[s] += 1

    # ---- introspection -----------------------------------------------
    def stats_locked(self) -> Dict[str, object]:
        return {
            "ticks": self.ticks,
            "active": int(sum(self.active)),
            "slots": self.n_slots,
            "blocks": list(self.blocks),
            "underruns": list(self.underruns),
            "block_frame": self.block_frame,
            "samplerate": self.sr,
        }

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return self.stats_locked()
