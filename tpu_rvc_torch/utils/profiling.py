"""Device tracing (the counterpart of tpu_rvc/utils/profiling.py's
`device_trace`): a `torch.profiler` trace of a block as a Chrome trace,
with the program's stages on it as `tpu_rvc_torch.<name>` marks while
`utils/timing.py` is enabled.  Stage timing itself is `utils/timing.py`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


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
