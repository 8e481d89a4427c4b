"""Per-stage device timing with CUDA events.

`span(name, device)` marks a stage of the conversion (hubert, f0, enc_p,
flow, decoder).  It costs nothing until `enable()` is called; then each
span records a pair of CUDA events on `device`'s current stream when it
is a CUDA device (the host clock otherwise), and `read()` waits for each
span's end event and returns the milliseconds per stage name summed since
`enable()`.
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
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end.record(stream)
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
    for name, start, end in _records:
        if isinstance(start, torch.cuda.Event):
            end.synchronize()   # on its own card, whichever is current
            ms = start.elapsed_time(end)
        else:
            ms = (end - start) * 1e3
        out[name] = out.get(name, 0.0) + ms
    return out
