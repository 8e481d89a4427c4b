"""Launch counters, one plain integer per kernel wrapper, the guard every
wrapper runs first, the device its launches run on, and the counting
context that stands in for the kernels when a graph's FLOPs are counted."""

import contextlib
import threading
from typing import Dict, Iterator, Optional

import torch

launch_counts = {"banded_rel_attention": 0, "fused_stage": 0,
                 "fused_resblock": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise, on every device, when autograd would record through a kernel
    wrapper: the kernels and their plain twins alike have no backward (the
    JAX kernels have no VJP either), so a training forward must take the
    modules' differentiable branches (`train=True`), never a wrapper."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad; the kernel has no backward, "
            "so training runs the module's differentiable path (train=True)")



def launch_device(x: torch.Tensor):
    """The context a launch on x's card runs in: that card made the
    thread's current device when it is not.  The libraries'
    `cudaFuncSetAttribute` calls and launches act on the current device,
    and `resblock.cu` reads the SM count of the first card it runs on
    once: identical cards share it, so no kernel source changes for
    several cards."""
    if x.device.index is None or \
            x.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(x.device)


class KernelCount:
    """What the wrappers called inside `counting()` would have done: the
    operations of each kernel (its formula, which is what
    `FlopCounterMode` counts over its plain twin at the same shapes) and
    the launches it would have made."""

    def __init__(self):
        self.flops: Dict[str, int] = dict.fromkeys(launch_counts, 0)
        self.launches: Dict[str, int] = dict.fromkeys(launch_counts, 0)

    def add(self, name: str, flops: int, launches: int) -> None:
        self.flops[name] += flops
        self.launches[name] += launches

    def total(self) -> int:
        return sum(self.flops.values())


_active = threading.local()   # .count: the calling thread's open count


def active_count() -> Optional[KernelCount]:
    """The count a wrapper called now adds to, or None: the one flag test
    a wrapper makes before it computes or launches."""
    return getattr(_active, "count", None)


@contextlib.contextmanager
def counting() -> Iterator[KernelCount]:
    """Inside, every kernel wrapper called from this thread adds its
    formula's operations to the yielded count and returns zeros of its
    output's shape: it launches no kernel and runs no plain twin, on any
    device, and `launch_counts` stays as it was.  Other threads compute
    and launch as usual.  A count opened inside another adds what it
    counted to the outer one when it closes."""
    outer = active_count()
    count = KernelCount()
    _active.count = count
    try:
        yield count
    finally:
        _active.count = outer
        if outer is not None:
            for name in count.flops:
                outer.add(name, count.flops[name], count.launches[name])
