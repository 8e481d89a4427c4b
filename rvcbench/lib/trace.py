"""The traced window: `torch.profiler` over the window, read into the
device's busy seconds (the union of every kernel, copy and set on the
card), the device time of each kernel name, and the longest idle gaps,
each named by what the host was doing in it (the harness's phase and the
innermost operation the host was in)."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from .stats import gaps, union_seconds


class Trace:
    def __init__(self, cuda: bool = True):
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self.cuda = cuda
        self.prof = profile(activities=acts)
        self.t0 = self.t1 = None

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def read(self, n_top: int = 10) -> Dict[str, object]:
        """{"window_s", "busy_s", "kernels": {name: s}, "device_ops":
        [[name, s]], "idle_gaps": [[label, s]]}."""
        t0, t1 = self.t0, self.t1
        dev: List[Tuple[int, int, str]] = []
        cpu: List[Tuple[int, int, str, bool]] = []
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns()
            end = s + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                # the harness's phases appear on the device's timeline too:
                # they are no operation of the card's
                if e.is_user_annotation() or e.name().startswith(
                        "rvcbench."):
                    continue
                if end > t0 and s < t1:
                    dev.append((max(s, t0), min(end, t1), e.name()))
            elif end > t0 and s < t1:
                cpu.append((s, end, e.name(), e.is_user_annotation()))
        kernels: Dict[str, float] = {}
        for s, e, name in dev:
            kernels[name] = kernels.get(name, 0.0) + (e - s) / 1e9
        busy = union_seconds((s, e) for s, e, _ in dev) / 1e9
        idle = sorted(gaps([(s, e) for s, e, _ in dev], t0, t1),
                      key=lambda g: g[0] - g[1])[:n_top]
        return {
            "window_s": (t1 - t0) / 1e9,
            "busy_s": busy,
            "kernels": kernels,
            "device_ops": sorted(([k, v] for k, v in kernels.items()),
                                 key=lambda kv: -kv[1])[:n_top],
            "idle_gaps": [[_label(cpu, (s + e) // 2), (e - s) / 1e9]
                          for s, e in idle],
        }


def _label(cpu, at: int) -> str:
    """The harness's phase and the innermost host operation at `at`."""
    phase, op, op_start = None, None, None
    for s, e, name, annotation in cpu:
        if s <= at < e:
            if annotation:
                if phase is None or name.startswith("rvcbench."):
                    phase = name
            elif op_start is None or s >= op_start:
                op, op_start = name, s
    return f"{phase or 'host'}: {op or 'python'}"
