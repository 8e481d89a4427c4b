"""Run one cell of the benchmark once and print its result line.

    python3 rvcbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (weights and inputs from the seed, the program loaded, every
shape of the cell warmed) is timed as `setup_s`; then the window runs
for `--seconds`; then, with the program's state freed, the plain
reference checks what the window produced.  `--trace 0` reports the
cell's end-to-end metrics, `--trace 1` its per-layer ones, read from a
profiler trace of the window and the program's spans.  The last lines
of standard error are the numbers compared, each with its limit; the
last line of standard output is the result as JSON."""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_rvc")


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX behind a
    library's back; one host thread for the math libraries, so that the
    program's host work does not contend with idle pool threads (a run's
    load is one process)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    build = REPO / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError):
        return None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             tmp: str, cell=None, cfg=None) -> dict:
    """Set-up, window, check and the metrics' inputs of one run:
    {"rec", "checks", "setup_s", "memory_peak_bytes"}."""
    import torch
    from rvcbench.lib import cells
    from rvcbench.lib.trace import Trace

    cell = cells.traffic(name) if cell is None else cell
    cfg = cells.config(cell["config"]) if cfg is None else cfg
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    drv = cells.driver(cell["entry"]).Driver(cell, cfg, seed, device, tmp)
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    tracer = Trace(cuda) if trace else None
    rec = drv.window(seconds, tracer)
    if trace:
        rec["trace"] = tracer.read()
        del tracer
    peak = torch.cuda.max_memory_allocated() if cuda else None
    drv.release()
    gc.collect()
    checks = drv.check(rec)
    checks.append({"name": "failed_calls", "value": rec["failed"],
                   "limit": 0})
    if trace:
        rec.update(drv.count(rec))
    rec["setup_s"] = setup_s
    rec["cell"], rec["cfg"] = cell, cfg
    return {"rec": rec, "checks": checks, "setup_s": setup_s,
            "memory_peak_bytes": peak, "driver": drv}


def passed(checks) -> bool:
    return all(c["limit"] is None or c["value"] <= c["limit"]
               for c in checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch
    from rvcbench.lib import cells

    torch.set_num_threads(1)

    cell = cells.traffic(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"rvcbench: {args.workload} needs {cell['chips']} CUDA "
              "device(s); none usable here", file=sys.stderr)
        return 3
    import tpu_rvc_torch  # noqa: F401  (the program must be present)

    wanted = cells.metrics_for(args.workload, bool(args.trace))
    readers = {m["name"]: cells.metric(m["name"]) for m in wanted}
    tmp = tempfile.mkdtemp(prefix="rvcbench-")
    try:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", tmp, cell=cell)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec, checks = out["rec"], out["checks"]
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(rec)
        if value is None:
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(cell["chips"]),
              "memory_peak_bytes": out["memory_peak_bytes"],
              "power": power_limit()}
    result = {"correct": passed(checks), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tr = rec["trace"]
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    for name, s in getattr(out["driver"], "setup_laps", {}).items():
        print(f"setup {name} {s:.3f} s", file=sys.stderr)
    if rec.get("tick_ms"):
        from rvcbench.lib.stats import percentile
        ms = rec["tick_ms"]
        print(f"window {len(ms)} ticks, ms p10 {percentile(ms, 10):.1f} "
              f"p50 {percentile(ms, 50):.1f} p90 {percentile(ms, 90):.1f} "
              f"max {max(ms):.1f}", file=sys.stderr)
    for e in rec.get("errors", []):
        print(f"rvcbench: a call failed: {e}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print("rvcbench: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 4
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    for c in checks:
        print(f"check {c['name']} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
