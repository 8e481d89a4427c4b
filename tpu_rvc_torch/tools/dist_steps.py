"""Data-parallel and sharded GAN steps, one process a rank, for the tests
and `chip_smoke.py`.

    python -m tpu_rvc_torch.tools.dist_steps JOB RANK WORLD PORT

JOB is a `torch.save`d dict; every rank joins a group over
tcp://127.0.0.1:PORT (`parallel/multihost.py` `initialize`, NCCL on a
card unless JOB names a backend) and writes `rank{RANK}.pt` into
JOB["out"].  `launch(job, world)` starts the ranks, waits for them within a
time limit and returns their results; a failing rank raises.  Cases
(JOB["case"]):

  steps         from one set of weights (JOB["seed"], or "g_state" and
                "d_state"), for each of JOB["layouts"] a fresh state run
                through JOB["batches"] (global batches, numpy), each rank
                on its rows: "replicated" (`create_train_state(group=...)`)
                or a (n_data, n_model) mesh (`parallel/fsdp.py`
                `shard_train_state`).  Per layout: every step's scalar
                metrics and host ms (after a synchronize), peak memory,
                `assert_state_sharded`'s reading before and after, and
                after each step count in JOB["snapshots"] (default: the
                last) whether every rank holds rank 0's parameters bit for
                bit, and rank 0's full parameters (only after the counts
                in JOB["keep"], if given), or with JOB["reference"] (a
                file of full parameters by step count) their
                `param_gap` from those; with JOB["gate"] (a path) the
                ranks build the first state, then wait for that file
                before they load the reference and step.  JOB["desync"]
                then
                checks `assert_same_across_hosts` with a value that
                differs on every rank;
  run_training  `train/loop.py` `run_training(JOB["exp"], ...)`, the paths
                each rank passed to `torch.save` recorded;
  cli_timing    the train CLI's `main(JOB["argv"])` (it joins and leaves
                its own group), then steps on JOB["exp"]'s batches timed in
                a group of this one process and without a group, in turns
                (after JOB["gate"] appears, if given).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def make_batch(hp, lengths, seed: int, T: int, pins=None) -> Dict:
    """A seeded global batch of len(lengths) rows in a T-frame bucket, the
    JAX layout (channel-last); `pins` (ids_slice) adds the pinned slice
    and posterior eps."""
    rng = np.random.default_rng(seed)
    B, hop = len(lengths), hp.data.hop_length
    batch = {
        "phone": rng.standard_normal((B, T, hp.encoder_dim)).astype(
            np.float32),
        "phone_lengths": np.asarray(lengths, np.int32),
        "pitch": rng.integers(1, 255, (B, T)).astype(np.int32),
        "pitchf": rng.uniform(100, 300, (B, T)).astype(np.float32),
        "spec": rng.standard_normal((B, T, hp.data.spec_channels)).astype(
            np.float32),
        "spec_lengths": np.asarray(lengths, np.int32),
        "wave": rng.standard_normal((B, T * hop, 1)).astype(np.float32)
        * 0.1,
        "sid": np.zeros((B,), np.int32),
    }
    if pins is not None:
        batch["pin_ids_slice"] = np.asarray(pins, np.int32)
        batch["pin_noise_eps"] = rng.standard_normal(
            (B, T, hp.model.inter_channels)).astype(np.float32)
    return batch


def rows_of(batch: Dict, offset: int, stride: int) -> Dict:
    return {k: v[offset::stride] for k, v in batch.items()}


def _whole(v) -> torch.Tensor:
    """A DTensor sharded over one mesh axis, whole: each rank writes its
    chunk (`torch.chunk`'s, as FSDP2 cuts them) into zeros and the axis's
    group sums them.  `full_tensor` would all-gather the chunks, and gloo
    crashed on the card for a rank whose chunk is empty."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    local = v.to_local()
    whole = torch.zeros(v.shape, dtype=v.dtype, device=local.device)
    index, group = [slice(None)] * v.dim(), None
    for axis, placement in enumerate(v.placements):
        if isinstance(placement, Shard):
            n = v.shape[placement.dim]
            size = -(-n // v.device_mesh.size(axis))
            start = min(v.device_mesh.get_local_rank(axis) * size, n)
            index[placement.dim] = slice(start,
                                         start + local.shape[placement.dim])
            group = v.device_mesh.get_group(axis)
    whole[tuple(index)] = local
    if group is not None:
        dist.all_reduce(whole, group=group)
    return whole


def full_params(state) -> Dict[str, torch.Tensor]:
    """G's and D's parameters whole, on the CPU (a collective under
    FSDP: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    out = {}
    for tag, net in (("g.", state.net_g), ("d.", state.net_d)):
        for k, v in net.state_dict().items():
            v = _whole(v) if isinstance(v, DTensor) else v
            out[tag + k] = v.detach().cpu().clone()
    return out


def run_steps(state, batches: List[Dict], snapshots=(), at_snapshot=None):
    """Each global batch's rows for this rank through `state.train_step`:
    the scalar metrics of every step and its host ms (to a synchronize);
    after each step count in `snapshots`, `at_snapshot(state)`'s result,
    by count."""
    offset, stride = state.rows
    metrics, ms, snaps = [], [], {}
    for i, batch in enumerate(batches):
        t0 = time.perf_counter()
        m = state.train_step(rows_of(batch, offset, stride))
        if state.device.type == "cuda":
            torch.cuda.synchronize(state.device)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items() if v.dim() == 0})
        if i + 1 in snapshots:
            snaps[i + 1] = at_snapshot(state)
    return metrics, ms, snaps


def param_gap(got: Dict[str, torch.Tensor],
              want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The largest element difference and the fraction of elements more
    than 1e-6 apart."""
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    return {"max_abs": float(diff.max()),
            "beyond_1e6": float((diff > 1e-6).float().mean())}


def wait_for(path, timeout_s: float = 600) -> None:
    """Wait until the file `path` exists (None: at once): the launcher's
    signal that the card is free for the timed part."""
    deadline = time.monotonic() + timeout_s
    while path and not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s} s")
        time.sleep(0.05)


def _same_as_rank0(params: Dict[str, torch.Tensor], device) -> bool:
    import torch.distributed as dist

    flat = torch.cat([v.reshape(-1).float() for v in params.values()])
    flat = flat.to(device)
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    return bool(torch.equal(ref, flat))


def _steps(job, rank, device):
    import torch.distributed as dist
    from tpu_rvc_torch.parallel import fsdp, multihost
    from tpu_rvc_torch.train.step import create_train_state

    results = []
    for i, layout in enumerate(job["layouts"]):
        group = dist.group.WORLD if layout == "replicated" else None
        state = create_train_state(job["hp"], seed=job.get("seed"),
                                   device=device,
                                   g_state=job.get("g_state"),
                                   d_state=job.get("d_state"), group=group)
        fracs = []
        if layout != "replicated":
            mesh = fsdp.train_mesh(*layout, device.type)
            state = fsdp.shard_train_state(state, mesh)
            if layout[1] > 1:
                fracs.append(fsdp.assert_state_sharded(state, "model", 0.5))
        if i == 0:
            wait_for(job.get("gate"))
            reference = (torch.load(job["reference"], map_location="cpu",
                                    weights_only=True)
                         if rank == 0 and job.get("reference") else None)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)

        counts = job.get("snapshots", [len(job["batches"])])
        keep = job.get("keep", counts)

        def snapshot(state):
            params = full_params(state)
            out = {"same_as_rank0": _same_as_rank0(params, device)}
            if rank == 0 and state.step in keep:
                if reference is None:
                    out["params"] = params
                else:
                    out["gap"] = param_gap(params, reference[state.step])
            return out

        metrics, ms, snaps = run_steps(state, job["batches"], counts,
                                       snapshot)
        if fracs:
            fracs.append(fsdp.assert_state_sharded(state, "model", 0.5))
        results.append({
            "layout": layout, "metrics": metrics, "ms": ms,
            "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if device.type == "cuda" else None),
            "sharded_frac": fracs, "snapshots": snaps})
        del state
    out = {"layouts": results, "primary": multihost.is_primary(),
           "multiprocess": multihost.is_multiprocess()}
    if job.get("desync"):
        try:
            multihost.assert_same_across_hosts(7 + rank, "resume start_epoch")
            out["desync"] = None
        except RuntimeError as e:
            out["desync"] = str(e)
    return out


def _run_training(job, rank, device):
    from tpu_rvc_torch.train.loop import run_training

    saved, save = [], torch.save

    def spy(obj, path, *a, **kw):
        saved.append(str(path))
        return save(obj, path, *a, **kw)

    torch.save = spy
    try:
        metrics = run_training(job["exp"], job["hp"],
                               total_epochs=job["epochs"],
                               save_every_epoch=job["epochs"],
                               name=job.get("name", "model"),
                               log_fn=lambda s: None, tensorboard=False,
                               device=device)
    finally:
        torch.save = save
    return {"metrics": metrics, "saved": saved}


def _cli_timing(job, rank, world, port, device):
    from tpu_rvc_torch.apps.train import main as train_main
    from tpu_rvc_torch.parallel import multihost
    from tpu_rvc_torch.train.data import BucketBatcher, RVCDataset
    from tpu_rvc_torch.train.step import create_train_state

    t0 = time.perf_counter()
    train_main(job["argv"])
    cli_s = time.perf_counter() - t0
    hp = job["hp"]
    device = multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                  backend=job.get("backend"), device=device)
    cuda = device.type == "cuda"
    ds = RVCDataset(os.path.join(job["exp"], "filelist.txt"), hp)
    bs = hp.train.batch_size
    batcher = BucketBatcher(ds, bs, seed=hp.train.seed)
    state = create_train_state(hp, steps_per_epoch=max(len(ds) // bs, 1),
                               device=device, group=multihost.data_group())
    group = state.group

    def batches():
        e = 0
        while True:
            yield from batcher.epoch(e)
            e += 1

    it = batches()
    wait_for(job.get("gate"))
    ms, peak = {"group": [], "none": []}, {"group": 0.0, "none": 0.0}
    for i, arm in enumerate(["group"] * job["n_warm"]
                            + [a for a in ("group", "none", "none", "group")
                               for _ in range(job["n_timed"])]):
        batch = next(it)
        state.group = group if arm == "group" else None
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        m = state.train_step(batch)
        if cuda:
            torch.cuda.synchronize(device)
            peak[arm] = max(peak[arm],
                            torch.cuda.max_memory_allocated(device) / 1e9)
        if i >= job["n_warm"]:
            ms[arm].append((time.perf_counter() - t0) * 1e3)
    finite = all(np.isfinite(float(v)) for v in m.values() if v.dim() == 0)
    return {"cli_s": cli_s, "ms": ms, "finite": finite,
            "peak_gb": peak if cuda else None}


def main(argv) -> int:
    job_path, rank, world, port = argv[0], *map(int, argv[1:4])
    job = torch.load(job_path, map_location="cpu", weights_only=False)
    torch.set_num_threads(job.get("threads", 1))
    from tpu_rvc_torch.parallel import multihost

    device = job.get("device", "cuda")
    if job["case"] == "cli_timing":
        out = _cli_timing(job, rank, world, port, device)
    else:
        device = multihost.initialize(f"127.0.0.1:{port}", world, rank,
                                      backend=job.get("backend"),
                                      device=device,
                                      timeout_s=job.get("timeout_s", 60))
        if job["case"] == "steps":
            out = _steps(job, rank, device)
        else:
            out = _run_training(job, rank, device)
    multihost.shutdown()
    from tpu_rvc_torch.ops.kernels import launch_counts
    out["launches"] = dict(launch_counts)
    torch.save(out, os.path.join(job["out"], f"rank{rank}.pt"))
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """`world` processes running one job (`start`); `wait` collects."""

    def __init__(self, job: Dict, world: int):
        os.makedirs(job["out"], exist_ok=True)
        self.out, self.world = job["out"], world
        path = os.path.join(job["out"], "job.pt")
        torch.save(job, path)
        port = free_port()
        env = dict(os.environ, PYTHONFAULTHANDLER="1", PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.logs = [open(os.path.join(job["out"], f"rank{r}.log"), "w+")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_rvc_torch.tools.dist_steps", path,
             str(r), str(world), str(port)], env=env, stdout=log,
            stderr=subprocess.STDOUT, cwd=REPO)
            for r, log in enumerate(self.logs)]

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()

    def wait(self, timeout_s: float = 180) -> List[Dict]:
        """The ranks' results; a rank that fails or outlives `timeout_s`
        raises RuntimeError with its output's end.  Every process started
        is stopped."""
        deadline = time.monotonic() + timeout_s
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        tails = []
        for r, (p, log) in enumerate(zip(self.procs, self.logs)):
            if p.returncode != 0:
                log.seek(0)
                tails.append(f"rank {r} exit {p.returncode}:\n"
                             + log.read()[-3000:])
            log.close()
        if tails:
            raise RuntimeError("\n".join(tails))
        return [torch.load(os.path.join(self.out, f"rank{r}.pt"),
                           map_location="cpu", weights_only=False)
                for r in range(self.world)]


def launch(job: Dict, world: int, timeout_s: float = 180) -> List[Dict]:
    """Run `job` in `world` processes; their results by rank."""
    return Ranks(job, world).wait(timeout_s)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
