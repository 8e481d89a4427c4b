"""Where the card's GAN step stops being reproducible, and what a
deterministic step costs.

    python3 -m tpu_rvc_torch.tools.determinism_probe [--runs 2] [--timed 10]

Runs `chip_smoke.py` T5's one-process run (v2/48k at full width from
seed 7, fp32 with TF32 off, four rows of 200, 163, 200 and 110 frames,
three pinned then two unpinned steps) in child processes, `--runs` times
under each setting, in turns:

  deterministic  `torch.use_deterministic_algorithms(True,
                 warn_only=True)`, `torch.backends.cudnn.deterministic`,
                 and CUBLAS_WORKSPACE_CONFIG=:4096:8 in the child's
                 environment (it must be set before the first cuBLAS
                 handle, hence a process a run);
  cudnn          `torch.backends.cudnn.deterministic` alone;
  cublas         CUBLAS_WORKSPACE_CONFIG=:4096:8 alone;
  default        none of them, as the training step runs.

Each child then times `--timed` more steps on the unpinned batch.  Prints
one JSON line a setting: the operations that warned they have no
deterministic implementation, and against the first run of the setting,
each other run's largest element difference and share of elements more
than 1e-6 apart after 1 and 5 steps (`bit_equal` when every element is
equal), and the median step ms of each run; then the card's name and
power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import warnings

# setting -> (use_deterministic_algorithms, cudnn.deterministic, the
# cuBLAS workspace configuration)
SETTINGS = {"deterministic": (True, True, True), "cudnn": (False, True, False),
            "cublas": (False, False, True), "default": (False, False, False)}
LENGTHS = (200, 163, 200, 110)
SNAPSHOTS = (1, 5)


def child(setting: str, n_timed: int, out: str) -> None:
    import dataclasses

    import numpy as np
    import torch

    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.tools.dist_steps import (full_params, make_batch,
                                                run_steps)
    from tpu_rvc_torch.train.step import create_train_state

    algorithms, cudnn, _ = SETTINGS[setting]
    if algorithms:
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = cudnn
    hp = hparams_for("v2", 48000)
    hp = dataclasses.replace(hp, train=dataclasses.replace(
        hp.train, fp16_run=False))
    batches = ([make_batch(hp, LENGTHS, 21, 200, pins=(10, 120, 150, 60))]
               * 3 + [make_batch(hp, LENGTHS, 22, 200)] * 2)
    state = create_train_state(hp, seed=7, device="cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, ms, snaps = run_steps(state, batches, SNAPSHOTS, full_params)
        _, timed, _ = run_steps(state, batches[-1:] * n_timed)
    ops = sorted({re.split(r" does not have", str(w.message))[0]
                  for w in caught
                  if "deterministic" in str(w.message)})
    torch.save({"snapshots": snaps, "ms": ms + timed, "ops": ops,
                "median_timed_ms": float(np.median(timed))}, out)


def param_gap(got, want):
    import torch

    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    return {"max_abs": float(diff.max()),
            "beyond_1e6": float((diff > 1e-6).float().mean()),
            "bit_equal": bool((diff == 0).all())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python3 -m tpu_rvc_torch.tools.determinism_probe")
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--settings", nargs="+", default=list(SETTINGS),
                   choices=list(SETTINGS))
    p.add_argument("--child", nargs=2, metavar=("SETTING", "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        child(args.child[0], args.timed, args.child[1])
        return 0

    import torch

    if not torch.cuda.is_available():
        print("determinism_probe: CUDA is not available", file=sys.stderr)
        return 2
    results = {s: [] for s in args.settings}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.runs):
            for setting in args.settings:
                env = dict(os.environ)
                if SETTINGS[setting][2]:
                    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
                else:
                    env.pop("CUBLAS_WORKSPACE_CONFIG", None)
                out = os.path.join(tmp, f"{setting}_{i}.pt")
                subprocess.run(
                    [sys.executable, "-m",
                     "tpu_rvc_torch.tools.determinism_probe", "--timed",
                     str(args.timed), "--child", setting, out],
                    env=env, check=True, timeout=900)
                results[setting].append(torch.load(out, weights_only=False))
    for setting, runs in results.items():
        first = runs[0]["snapshots"]
        print(json.dumps({
            "setting": setting,
            "ops_without_deterministic_implementation": sorted(
                {op for r in runs for op in r["ops"]}),
            "against_first_run": [
                {str(n): param_gap(r["snapshots"][n], first[n])
                 for n in SNAPSHOTS} for r in runs[1:]],
            "median_step_ms": [r["median_timed_ms"] for r in runs],
            "step_ms": [r["ms"] for r in runs]}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
