"""Several training processes, one a card (port of
tpu_rvc/parallel/multihost.py:44-124; reference
infer/modules/train/train.py:102-217).

The reference trains with one process per GPU wired by NCCL, or by gloo
and a hand-built TCPStore.  So does the port: every process runs the same
`run_training` call, joined by `torch.distributed` (the JAX package's
`jax.distributed`, which stitches the hosts' chips into one mesh, has no
counterpart: the port's data axis is the process group).  What the host
side needs:

1. each process feeds only its own rows of every global batch,
   `BucketBatcher.epoch_local_slice(epoch, rank, world)`: every process
   derives the same global plan and takes rows `rank::world` of each
   batch, so all step through the same number of batches of the same
   shapes, which the collectives of the step require;
2. the step (`train/step.py` with a group) makes the global batch's step
   out of the ranks' rows.

Launch, on one machine with N cards:

    torchrun --nproc-per-node N -m tpu_rvc_torch.apps.train train \\
        --multihost ...

or the same command in every process with `--coordinator <host0>:<port>
--num-processes N --process-id $i` in place of `--multihost`.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from tpu_rvc_torch.core.device import resolve_device

logger = logging.getLogger(__name__)

TIMEOUT_S = 600.0   # rendezvous and every collective: a missing rank fails


def process_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This process's device: for a card `cuda:LOCAL_RANK` (torchrun's
    variable, else the rank modulo the visible cards), else `device` as
    given."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    rank = process_index() if rank is None else rank
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device=None,
               timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the job (idempotent); returns this process's device.

    With no arguments the rendezvous reads torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), the role of the JAX package's
    auto-detection; otherwise `tcp://<coordinator_address>` with the
    given process count and id (the reference's MASTER_ADDR/RANK/
    WORLD_SIZE contract).  The backend is NCCL for a card and gloo for the
    CPU unless `backend` names one.  Call it before the first use of the
    card: it makes this process's card the current one."""
    if dist.is_initialized():
        return process_device(device)
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit) and None in explicit:
        raise ValueError("coordinator_address, num_processes and process_id "
                         "go together (or none of them, for torchrun's "
                         "environment)")
    rank = (int(os.environ.get("RANK", 0)) if process_id is None
            else int(process_id))
    dev = process_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=rank,
                                timeout=timeout)
    logger.info("multihost: process %d/%d on %s over %s", process_index(),
                process_count(), dev, backend)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that writes checkpoints and logs (the
    reference's rank 0, train.py:604)."""
    return process_index() == 0


def data_group() -> Optional[dist.ProcessGroup]:
    """The group a training step averages over: every process once the
    job is joined (a group of one too), else None (no collectives)."""
    return dist.group.WORLD if dist.is_initialized() else None


def global_batch_from_local(batch: Dict[str, Any],
                            device) -> Dict[str, torch.Tensor]:
    """This process's rows of the global batch onto its device.  No
    process holds the global batch: the step (`train/step.py`) makes the
    global batch's step from every rank's rows."""
    from tpu_rvc_torch.train.step import batch_to_device
    return batch_to_device(batch, device)


def assert_same_across_hosts(value: int, what: str) -> int:
    """Check that an integer agrees on every process; returns rank 0's.

    Used for resume: only rank 0 writes checkpoints, so without a shared
    experiment dir the other processes would start at epoch 0 with fresh
    weights while rank 0 resumes, and hang in a collective much later.
    Fail at startup instead."""
    if not is_multiprocess():
        return value
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    r0 = int(t.item())
    if r0 != value:
        raise RuntimeError(
            f"multihost desync: {what} is {value} on process "
            f"{process_index()} but {r0} on rank 0 — the experiment "
            "dir (checkpoints) must be visible to every host, e.g. on "
            "shared storage")
    return r0
