"""The port's device rule: CUDA unless the caller asks for another device;
and its precision: fp32 throughout, TF32 off for cuDNN and cuBLAS."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means "cuda".  A CUDA device without CUDA raises: the port
    never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_rvc_torch: CUDA is not available; pass device='cpu' to run "
            "the plain PyTorch path on the CPU")
    return dev


@contextlib.contextmanager
def fp32_math():
    """Run cuDNN convolutions and cuBLAS products in full fp32 (PyTorch
    lets cuDNN use TF32 by default), restoring the caller's flags after.
    The entry points (`Pipeline.pipeline`/`vc_chunk`, `Synthesizer.infer`,
    `Hubert.forward`) wear it as a decorator, so every conversion has the
    fp32 precision the JAX reference is held to."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


@contextlib.contextmanager
def cudnn_autotune():
    """Let cuDNN time its algorithms once for each new convolution shape
    (`torch.backends.cudnn.benchmark`), restoring the caller's flag after.
    Its heuristic pick is not safe for the UVR5 nets: on an H100, for the
    fp32 3x3 convolutions of 3 to 7 windows at a time, it took an FFT
    algorithm of some 33,000 launches that ran the HP net 4x and the DeEcho
    net 14-25x slower than the timed pick, with 20-25 GB of workspace.
    The timed pick can differ from one process to the next, so two
    processes may differ in the last bits."""
    cudnn = torch.backends.cudnn
    saved = cudnn.benchmark
    cudnn.benchmark = True
    try:
        yield
    finally:
        cudnn.benchmark = saved


SEARCH_LIMIT = 3   # cuDNN algorithms timed a convolution (PyTorch's default: 10)


@contextlib.contextmanager
def deterministic_math():
    """Run-to-run reproducible training math on the card: cuDNN held to
    its deterministic algorithms and choosing among them by timing
    (`cudnn.deterministic` with `cudnn.benchmark`), restoring the caller's
    flags after.  The timed choice is made once a shape and a process, so
    two runs in one process take the same algorithms; the heuristic's
    deterministic pick made the v2/48k step 1.6x slower on an NVIDIA H100
    80GB HBM3 at 700 W (`tools/determinism_probe.py`).  The port's own differentiable code
    has no atomic adds on the training path (the spectrogram's frames,
    `ops/stft.py`; the attention's band, `nn/attention.py`), so PyTorch's
    `use_deterministic_algorithms` is not needed.  The search times at
    most SEARCH_LIMIT algorithms a convolution (`cudnn.benchmark_limit`):
    on that card a new batch shape's first step took 4.2-5.9 s in fp32
    and 15.6-22.8 s in bf16 at 3, 10.5-16.5 s and 20.1-43.4 s at 10
    (`determinism_probe --cost`, one call).  The limit does not bound the
    search's memory: in fp32 it reserves what the card has free while it
    runs, at either limit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark, cudnn.benchmark_limit
    cudnn.deterministic = cudnn.benchmark = True
    cudnn.benchmark_limit = SEARCH_LIMIT
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.benchmark_limit = saved


_constants = {}


def device_constant(key, make, device) -> torch.Tensor:
    """A small constant tensor (a window, a filterbank, a resampling
    kernel) built once per `key` and device by `make()` (numpy array or
    CPU tensor) and kept there.  Uploading it anew in every call would be
    a blocking host-to-device copy in the middle of a streaming block."""
    dev = torch.device(device)
    full_key = (key, dev.type, dev.index)
    if full_key not in _constants:
        _constants[full_key] = torch.as_tensor(make()).to(dev)
    return _constants[full_key]


class RowGenerators(list):
    """One generator a row, and `shared`, the generator of what a batch
    draws once for all its rows (the sine source's initial phase in a
    training step).  A plain list of generators draws even that row by
    row."""

    def __init__(self, rows, shared: torch.Generator):
        super().__init__(rows)
        self.shared = shared


def _draw(fn, shape, generator, like):
    if isinstance(generator, (list, tuple)):
        # one generator a row: row i is what generator i draws for a batch
        # of one, so a batched conversion repeats each single one's noise
        if shape[0] not in (1, len(generator)):
            raise ValueError(f"{len(generator)} generators for {shape[0]} "
                             "rows")
        return torch.cat([_draw(fn, (1, *shape[1:]), g, like)
                          for g in generator])
    dev = like.device if generator is None else generator.device
    out = fn(tuple(shape), generator=generator, device=dev, dtype=like.dtype)
    return out.to(like.device)


def draw_normal(shape, generator: Optional[torch.Generator],
                like: torch.Tensor) -> torch.Tensor:
    """Standard normal noise of `like`'s dtype on `like`'s device, drawn
    where `generator` lives: a CPU generator gives the same numbers for a
    tensor on any device (the model hash relies on it).  A list of
    generators draws one row each."""
    return _draw(torch.randn, shape, generator, like)


def draw_uniform(shape, generator: Optional[torch.Generator],
                 like: torch.Tensor) -> torch.Tensor:
    """As `draw_normal`, uniform on [0, 1)."""
    return _draw(torch.rand, shape, generator, like)
