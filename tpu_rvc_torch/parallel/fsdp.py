"""FSDP over the mesh's "model" axis (port of tpu_rvc/parallel/fsdp.py:
28-91).

The JAX package shards every parameter and its Adam moments across the
mesh's second axis, ZeRO-3 style, and lets GSPMD insert the all-gathers
and reduce-scatters.  The port does it with FSDP2 (`fully_shard`) over a
2-D `DeviceMesh` ("data", "model") of the process group: parameters
replicated over "data" and sharded over "model" (HSDP), each on the axis
`fsdp_spec` picks.  The step (`train/step.py`) runs unchanged but for its
backward, which FSDP2 needs whole (`TrainState.fsdp`).

Two differences from the JAX layout: FSDP2 keeps no parameter whole inside
its shard group, so a leaf the JAX rule leaves replicated (no axis divides)
is sharded on its first axis with padding; and `run_training` does not
call this, as in the JAX package: it is library surface.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Shard, distribute_tensor


def fsdp_spec(shape, n_shard: int) -> Optional[int]:
    """The axis to shard over n_shard ranks: the largest one that n_shard
    divides, ties to the last (a conv's or a matmul's output channels), or
    None for scalars, n_shard 1, or no divisible axis."""
    if n_shard <= 1 or not shape:
        return None
    best, best_dim = None, 0
    for i, d in enumerate(shape):
        if d % n_shard == 0 and d >= best_dim and d > 1:
            best, best_dim = i, d
    return best


def train_mesh(n_data: int, n_model: int, device_type: str) -> DeviceMesh:
    """The (data, model) mesh over every process of the job."""
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def shard_train_state(state, mesh: DeviceMesh,
                      axis: Optional[str] = "model"):
    """Make `state` (a `TrainState` on every process, the same weights) one
    rank of a step over `mesh`: rows by the "data" coordinate, gradients
    averaged over the whole mesh, and G and D sharded over `axis` with
    their optimizers' moments.  `axis=None` or a size-1 axis leaves the
    state replicated (gradients all-reduced by the step)."""
    names = mesh.mesh_dim_names
    if names != ("data", "model"):
        raise ValueError(f"a training mesh is ('data', 'model'), not {names}")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of the job's "
                         f"{dist.get_world_size()} processes")
    if axis not in (None, "model"):
        raise ValueError(f"FSDP shards over 'model', not {axis!r}")
    state.group = dist.group.WORLD
    state.rows = (mesh.get_local_rank("data"), mesh.size(0))
    n = mesh.size(1)
    if axis is None or n <= 1:
        return state

    def placement(p):
        d = fsdp_spec(tuple(p.shape), n)
        return None if d is None else Shard(d)

    for net, opt_name in ((state.net_g, "opt_g"), (state.net_d, "opt_d")):
        opt = getattr(state, opt_name)
        saved = opt.state_dict()
        fully_shard(net, mesh=mesh, shard_placement_fn=placement)
        params = list(net.parameters())
        for i, moments in saved["state"].items():
            p = params[int(i)]
            for k in ("exp_avg", "exp_avg_sq"):
                moments[k] = distribute_tensor(moments[k], p.device_mesh,
                                               p.placements)
        new = state.make_optimizer(net)
        new.load_state_dict(saved)
        setattr(state, opt_name, new)
    state.fsdp = True
    return state


def assert_state_sharded(state, axis: str = "model",
                         min_sharded_frac: float = 0.9) -> float:
    """The fraction of G's and D's parameter elements sharded over `axis`;
    raises AssertionError below min_sharded_frac."""
    total = sharded = 0
    for net in (state.net_g, state.net_d):
        for p in net.parameters():
            total += p.numel()
            if isinstance(p, DTensor) and axis in p.device_mesh.mesh_dim_names:
                dim = p.device_mesh.mesh_dim_names.index(axis)
                if isinstance(p.placements[dim], Shard):
                    sharded += p.numel()
    frac = sharded / max(total, 1)
    if frac < min_sharded_frac:
        raise AssertionError(
            f"only {frac:.1%} of param elements sharded over '{axis}'")
    return frac
