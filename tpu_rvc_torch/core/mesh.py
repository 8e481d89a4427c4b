"""The device mesh of the port (counterpart of tpu_rvc/core/mesh.py:19-46).

The JAX package runs one SPMD program over a `jax.sharding.Mesh` and lets
XLA place each shard.  Here a `Mesh` is a small (n_data, n_model) grid of
`torch.device`s: a batch is split into row blocks over the `data` axis,
each block runs on the first device of its grid row, and the rows are
gathered back in order.  Launches are asynchronous, so the shards of
distinct cards overlap while the host issues them one after another.
Nothing runs on the `model` axis: the port shards no model, so the
devices after the first of a grid row stay idle.  The axis is kept so a
mesh has the JAX package's shape (there an unsharded `P("data")` array
is replicated over it).

A device may appear more than once: each appearance is a logical shard
that takes its own rows.  The CPU tests rehearse 2-8 shards that way, as
the JAX tests use `--xla_force_host_platform_device_count=8`, and
`chip_smoke.py` drives the shard path on one card.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device

AXES = ("data", "model")


class Mesh:
    """An (n_data, n_model) grid of devices with the axis names `AXES`."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices = [list(row) for row in devices]
        self.axis_names = AXES
        self.shape: Dict[str, int] = {"data": len(self.devices),
                                      "model": len(self.devices[0])}

    @property
    def shard_devices(self) -> List[torch.device]:
        """The device each data shard runs on, in row order."""
        return [row[0] for row in self.devices]


def canonical(device: Union[str, torch.device]) -> torch.device:
    """`device` with its index: "cuda" is the current CUDA device."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A (data, model) mesh over `devices`, by default every visible CUDA
    device once.  Without CUDA the default raises, as `resolve_device`
    does; a CPU mesh is asked for by naming the CPU.  With n_model > 1
    only the first device of each grid row converts (module docstring)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [canonical(d) for d in devices]
    n = len(devices)
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n or n == 0:
        raise ValueError(f"mesh {n_data}x{n_model} != {n} devices")
    return Mesh([devices[i * n_model:(i + 1) * n_model]
                 for i in range(n_data)])


def shard_bounds(n_rows: int, mesh: Mesh) -> List[slice]:
    """The row block of each data shard; n_rows must be a multiple of the
    data axis, as a `P("data")` sharding requires."""
    n_data = mesh.shape["data"]
    if n_rows % n_data:
        raise ValueError(f"batch {n_rows} not divisible by data axis "
                         f"{n_data}")
    per = n_rows // n_data
    return [slice(i * per, (i + 1) * per) for i in range(n_data)]


def split_rows(x, mesh: Mesh) -> List[torch.Tensor]:
    """(n, ...) numpy or tensor -> one row block a shard, each on its
    shard's device."""
    x = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    return [x[s].to(dev) for s, dev in zip(shard_bounds(x.shape[0], mesh),
                                           mesh.shard_devices)]


def gather_rows(parts: Sequence[torch.Tensor],
                device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """The shards' row blocks, in order, as one tensor on `device`."""
    return torch.cat([p.to(device) for p in parts])


def _replicate(pipeline, device: torch.device):
    """A copy of `pipeline` whose HuBERT, synthesizer and f0 networks live
    on `device`; everything else (geometry, noise settings) is shared."""
    rep = copy.copy(pipeline)
    rep.__dict__.pop("_replicas", None)
    rep.device = device
    rep.hubert = copy.deepcopy(pipeline.hubert).to(device)
    rep.synth = copy.deepcopy(pipeline.synth).to(device)
    # the relaid stage weights belong to the source's device
    rep.synth.dec._stage_cache = {}
    rep.f0_gen = copy.copy(pipeline.f0_gen)
    rep.f0_gen.device = device
    rep.f0_gen._estimators = {}
    return rep


def _sync_estimators(pipeline, rep) -> None:
    """Give the replica a copy, on its device, of every estimator the
    source has built since the replica was made."""
    for name, est in pipeline.f0_gen._estimators.items():
        if name in rep.f0_gen._estimators:
            continue
        mine = copy.copy(est)
        if hasattr(est, "device"):
            mine.device = rep.device
        model = getattr(est, "model", None)
        if isinstance(model, torch.nn.Module):
            mine.model = copy.deepcopy(model).to(rep.device)
        rep.f0_gen._estimators[name] = mine


def replicas(pipeline, mesh: Mesh) -> list:
    """One pipeline a data shard: the pipeline itself for a shard on its
    own device, else a replica on the shard's device, made once per
    distinct device and kept on the pipeline (a second call copies no
    weights).  The index arrays follow through `FeatureIndex.
    device_arrays`, which keeps one upload per device.  "cpu:0" is
    another device than "cpu" here, so the CPU tests rehearse replicas."""
    cache = pipeline.__dict__.setdefault("_replicas", {})
    home = canonical(pipeline.device)
    out = []
    for dev in mesh.shard_devices:
        if dev == home:
            out.append(pipeline)
            continue
        key = str(dev)
        if key not in cache:
            cache[key] = _replicate(pipeline, dev)
        _sync_estimators(pipeline, cache[key])
        out.append(cache[key])
    return out
