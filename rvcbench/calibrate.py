"""Readings that the limits of `correct` are set from: for each seed, the
cell's set-up, a window of `--seconds` at the cell's own load, the
numbers the check compares for the program and for the control (the
reference in the next precision below the configuration's, in the
program's place).  The benchmark's runs never run this.

    python3 rvcbench/calibrate.py --workload <cell> --seconds 6 \
        --seeds <n> [<n> ...] [--control-seeds k] [--fault <name>]

One JSON line a seed on standard output."""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import sys
import tempfile
import time

from run import REPO, _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="read the control on the first this many seeds")
    ap.add_argument("--fault", default=None,
                    help="plant this fault (faults.py) and read the program")
    args = ap.parse_args(argv)
    _environment()
    import torch
    from rvcbench.lib import cells

    cell = cells.traffic(args.workload)
    cfg = cells.config(cell["config"])
    take_out = None
    if args.fault:
        from rvcbench import faults
        take_out = faults.plant(cell["entry"], args.fault)
    n_control = (len(args.seeds) if args.control_seeds is None
                 else args.control_seeds)
    for k, seed in enumerate(args.seeds):
        tmp = tempfile.mkdtemp(prefix="rvcbench-cal-")
        try:
            t0 = time.perf_counter()
            drv = cells.driver(cell["entry"]).Driver(cell, cfg, seed, "cuda",
                                                     tmp)
            drv.setup()
            setup_s = time.perf_counter() - t0
            rec = drv.window(args.seconds, None)
            drv.release()
            gc.collect()
            t1 = time.perf_counter()
            prog = {c["name"]: c["value"] for c in drv.check(rec)}
            ref_s = time.perf_counter() - t1
            short = getattr(drv, "shortfalls", None)
            ctrl = ({} if args.fault or k >= n_control else
                    {c["name"]: c["value"] for c in drv.control(rec)})
            print(json.dumps({"seed": seed, "fault": args.fault,
                              "program": prog, "sola_shortfall": short,
                              "control": ctrl, "control_sola_shortfall":
                              getattr(drv, "shortfalls", None) if ctrl
                              else None, "setup_s": setup_s,
                              "reference_s": ref_s,
                              "laps": getattr(drv, "setup_laps", None)}),
                  flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
            torch.cuda.empty_cache()
    if take_out is not None:
        take_out()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
