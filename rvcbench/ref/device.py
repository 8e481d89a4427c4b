"""Device helpers of the reference: constants kept per device, seeded noise
drawn where its generator lives (frozen from tpu_rvc_torch/core/device.py)."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def fp32_math():
    """A no-op here: the reference runs at the precision its caller sets
    (`rvcbench/ref/precision.py`), fp32 with TF32 off, or TF32 for the
    control."""
    yield


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


class RowOf:
    """Row `row` of what `generator` draws for a batch of `n` rows: a
    stream served in a batch draws its noise as that row, and the
    reference follows one stream at a time."""

    def __init__(self, generator: torch.Generator, n: int, row: int):
        self.generator, self.n, self.row = generator, int(n), int(row)


def _draw(fn, shape, generator, like):
    if isinstance(generator, RowOf):
        full = _draw(fn, (generator.n, *shape[1:]), generator.generator, like)
        return full[generator.row: generator.row + 1]
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
