"""The port's spans: stage timing on the host's clock and, on a card, with
CUDA events, for the benchmark's per-layer metrics and for one request's
timeline.

`span(name, device=None, root=False)` marks a stage of a conversion, a
serving tick or a training step.  Until `enable()` it costs one check of
a module global: no clock read, no allocation.  Once enabled, each span
records

- its name, and its host start and end on `time.time_ns()`, the clock a
  `torch.profiler` trace's events are stamped with;
- on a CUDA `device`, a pair of CUDA events on that device's current
  stream;
- its parent: the innermost span open on the same thread (each thread,
  the serving tick's and the GUI's among them, keeps its own stack);
- a request id: a span takes its parent's; a root span (`call`, `tick`,
  `step`) and a span opened with none open on its thread open a new one.

Each enabled span also opens `torch.profiler.record_function(
"tpu_rvc_torch.<name>")`, so that a profiler that records puts the stages
on the kernels' timeline (the mark's device copy is a user annotation,
no work of the card's).

`count(name, n)` adds `n` to a counter, at the same cost while disabled.

`read()` sums milliseconds per name since `enable()`: under `<name>` on
the device's clock for spans on a card and on the host's otherwise, and
under `host.<name>` on the host's clock for every span; and each
counter's total under `count.<name>`.  `records()` returns the spans
themselves, in the order they closed.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

import torch

MARK = "tpu_rvc_torch."
HOST = "host."
COUNT = "count."

_records: Optional[List["_Span"]] = None
_counts: Dict[str, int] = {}
_numbers = itertools.count(1)     # span numbers and request ids: next() on
_requests = itertools.count(1)    # a count is atomic under the GIL


class _Stack(threading.local):
    def __init__(self):
        self.open: List[_Span] = []


_stack = _Stack()


def enable() -> None:
    global _records, _counts
    _records, _counts = [], {}


def disable() -> None:
    global _records, _counts
    _records, _counts = None, {}


class _Off:
    """The span of a disabled timer."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "number", "parent", "request", "t0", "t1",
                 "_device", "_root", "_events", "_mark", "_into")

    def __init__(self, name: str, device, root: bool):
        self.name, self._device, self._root = name, device, root
        self._into = _records

    def __enter__(self):
        opened = _stack.open
        parent = opened[-1] if opened else None
        self.number = next(_numbers)
        self.parent = None if parent is None else parent.number
        self.request = (next(_requests) if self._root or parent is None
                        else parent.request)
        self._events = None
        if self._device is not None and \
                torch.device(self._device).type == "cuda":
            self._events = (torch.cuda.current_stream(self._device),
                            torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        self._mark = torch.profiler.record_function(MARK + self.name)
        opened.append(self)
        self.t0 = time.time_ns()
        self._mark.__enter__()
        if self._events is not None:
            self._events[1].record(self._events[0])
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[2].record(self._events[0])
        self._mark.__exit__(*exc)
        self.t1 = time.time_ns()
        _stack.open.remove(self)
        self._into.append(self)
        return False

    def host_ms(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device_ms(self) -> Optional[float]:
        if self._events is None:
            return None
        _, start, end = self._events
        end.synchronize()   # on its own card, whichever is current
        return start.elapsed_time(end)


def span(name: str, device=None, root: bool = False):
    """A stage named `name`; `device`: where its work is queued (CUDA
    events on a card; None or the CPU: the host's clock alone); `root`: it
    opens a new request id."""
    if _records is None:
        return _OFF
    return _Span(name, device, root)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (nothing while disabled)."""
    if _records is None:
        return
    _counts[name] = _counts.get(name, 0) + int(n)


def read() -> Dict[str, float]:
    """Milliseconds per span name since `enable()`: `<name>` on the
    device's clock for spans on a card and on the host's otherwise,
    `host.<name>` on the host's clock; each counter's total under
    `count.<name>`."""
    out: Dict[str, float] = {COUNT + k: v for k, v in _counts.items()}
    for s in list(_records or ()):
        host = s.host_ms()
        dev = s.device_ms()
        out[s.name] = out.get(s.name, 0.0) + (host if dev is None else dev)
        key = HOST + s.name
        out[key] = out.get(key, 0.0) + host
    return out


def records() -> List[Dict[str, object]]:
    """The spans closed since `enable()`, in the order they closed: name,
    span number, the parent's number (None at the top of a thread), the
    request id, the host's start and end in `time.time_ns()` and the
    device milliseconds (None off a card)."""
    return [{"name": s.name, "span": s.number, "parent": s.parent,
             "request": s.request, "t0_ns": s.t0, "t1_ns": s.t1,
             "device_ms": s.device_ms()} for s in list(_records or ())]
