"""Phase timing and device tracing (the counterpart of
tpu_rvc/utils/profiling.py): the reference's coarse wall-clock
accumulators (`times=[npy, f0, infer]` and EpochRecorder) and a
`torch.profiler` trace for device timelines.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


class PhaseTimer:
    """Accumulating named phase timer (the reference's times[] role,
    infer/modules/vc/pipeline.py:107)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        return ", ".join(
            f"{k}: {v:.3f}s/{self.counts[k]}x" for k, v in self.totals.items())


class EpochRecorder:
    """Per-epoch elapsed time (reference train.py:89-99)."""

    def __init__(self):
        self.last = time.time()

    def record(self) -> str:
        now = time.time()
        elapsed = now - self.last
        self.last = now
        return f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] | ({elapsed:.1f}s)"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """A `torch.profiler` trace of the block (CPU activity, and CUDA where
    a card is present) written as a Chrome trace into `log_dir`; a no-op
    without a log dir.  Where the JAX function logs a warning and carries
    on when its profiler will not start, this one raises."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
