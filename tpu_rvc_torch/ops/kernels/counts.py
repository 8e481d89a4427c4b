"""Launch counters, one plain integer per kernel wrapper, the guard every
wrapper runs first, and the device its launches run on."""

import contextlib

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
