"""The collectives a data-parallel or sharded step uses, timed on the card.

    python3 -m tpu_rvc_torch.tools.collectives_probe [--mb 436]

Runs child processes on 127.0.0.1 that share card 0: two ranks over gloo
(CUDA tensors staged through the host), one rank over NCCL, and two ranks
over NCCL on the one card.  Each prints one JSON line per collective:
`all_reduce` of --mb megabytes of fp32 (the median of 3 after a warm-up),
`all_gather_into_tensor` and `reduce_scatter_tensor` (FSDP2's two), or the
error the backend raised (NCCL refuses two ranks on one card).  Needs a
CUDA card.
"""

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist


def child(rank: int, world: int, port: int, backend: str, mb: float) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)

    def run(name, fn, reps=1):
        try:
            ms = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out = {"ms": sorted(ms)[len(ms) // 2]}
        except Exception as e:   # the backend's refusal is the reading
            out = {"error": f"{type(e).__name__}: {e}"[:300]}
        if rank == 0:
            print(json.dumps({"backend": backend, "ranks": world,
                              "collective": name, **out}), flush=True)

    x = torch.ones(int(mb * 1e6 / 4), device=dev)
    run("all_reduce warm-up", lambda: dist.all_reduce(x))
    run(f"all_reduce {mb:g} MB", lambda: dist.all_reduce(x), reps=3)
    part = torch.ones(1 << 20, device=dev)
    whole = torch.empty(world << 20, device=dev)
    run("all_gather_into_tensor 4 MB a rank",
        lambda: dist.all_gather_into_tensor(whole, part), reps=3)
    run("reduce_scatter_tensor 4 MB a rank",
        lambda: dist.reduce_scatter_tensor(part, whole), reps=3)
    dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="collectives_probe")
    p.add_argument("--mb", type=float, default=436.0)
    p.add_argument("--child", nargs=4, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        rank, world, port, backend = args.child
        child(int(rank), int(world), int(port), backend, args.mb)
        return 0
    if not torch.cuda.is_available():
        print("collectives_probe: CUDA is not available", file=sys.stderr)
        return 2
    from tpu_rvc_torch.tools.dist_steps import REPO, free_port
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [q for q in [os.environ.get("PYTHONPATH")] if q]))
    for backend, world in (("gloo", 2), ("nccl", 1), ("nccl", 2)):
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tpu_rvc_torch.tools.collectives_probe",
             "--mb", str(args.mb), "--child", str(r), str(world), str(port),
             backend], env=env) for r in range(world)]
        for proc in procs:
            try:
                proc.wait(timeout=180)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                print(json.dumps({"backend": backend, "ranks": world,
                                  "error": "timed out"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
