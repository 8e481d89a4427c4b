"""Per-stage device timing with CUDA events.

`span(name, device)` marks a stage of the conversion (hubert, f0, enc_p,
flow, decoder).  It costs nothing until `enable()` is called; then each
span records a pair of CUDA events on the current stream when `device` is
a CUDA device (the host clock otherwise), and `read()` synchronises once
and returns the milliseconds per stage name summed since `enable()`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

_records: Optional[List[Tuple[str, object, object]]] = None


def enable() -> None:
    global _records
    _records = []


def disable() -> None:
    global _records
    _records = None


@contextlib.contextmanager
def span(name: str, device: torch.device):
    if _records is None:
        yield
        return
    if torch.device(device).type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
    else:
        start = time.perf_counter()
        yield
        end = time.perf_counter()
    _records.append((name, start, end))


def read() -> Dict[str, float]:
    """Milliseconds per span name since `enable()`."""
    out: Dict[str, float] = {}
    if not _records:
        return out
    if any(isinstance(start, torch.cuda.Event) for _, start, _ in _records):
        torch.cuda.synchronize()
    for name, start, end in _records:
        ms = (start.elapsed_time(end) if isinstance(start, torch.cuda.Event)
              else (end - start) * 1e3)
        out[name] = out.get(name, 0.0) + ms
    return out
