"""Where the card's GAN step stops being reproducible, and what a
deterministic step costs.

    python3 -m tpu_rvc_torch.tools.determinism_probe [--runs 2] [--timed 10]
        [--settings default deterministic ...] [--profile]
        [--against DIR]

Runs `chip_smoke.py` T5's one-process run (v2/48k at full width from
seed 7, fp32 with TF32 off, four rows of 200, 163, 200 and 110 frames,
three pinned then two unpinned steps) in child processes, `--runs` times
under each setting, in turns.  A setting is a set of switches:

  algorithms  `torch.use_deterministic_algorithms(True, warn_only=True)`
              (it also makes cuDNN take deterministic algorithms, and
              fills every new tensor with NaN);
  cudnn       `torch.backends.cudnn.deterministic`;
  cublas      CUBLAS_WORKSPACE_CONFIG=:4096:8 in the child's environment
              (it must be set before the first cuBLAS handle, hence a
              process a run);
  timed       `torch.backends.cudnn.benchmark`: cuDNN times its
              algorithms for each new shape (among the deterministic ones
              when `cudnn` or `algorithms` is on) instead of taking its
              heuristic's pick;
  step        the training step's own setting (`train/step.py`
              `TrainState.deterministic`), the others left as they are;
  limit10     with `step`: the search times 10 algorithms a convolution
              (PyTorch's default) instead of `core/device.py`'s
              SEARCH_LIMIT.

Each child takes the five steps twice from the seed, the second run's
state then times `--timed` more steps on the unpinned batch.  Prints
one JSON line a setting: the operations that warned they have no
deterministic implementation, and against the first run of the setting,
each other run's largest element difference and share of elements more
than 1e-6 apart after 1 and 5 steps (`bit_equal` when every element is
equal), the first step's losses and the parameters whose first-step
gradients differ (where the run-to-run rounding starts); the same for
the two runs inside each process (`within_process`: cuDNN's timed
choice of algorithms is made once a process, so only there do two runs
under `timed` take the same algorithms); and the median step ms of each
run.  `--profile` adds, in the first run of each
setting, torch.profiler's device time a step by kernel, and by
convolution operator and input shapes, over 3 steps, and a line that
sets each setting's kernels and convolutions against `default`'s (the
largest differences first).  `--against DIR` runs, in each turn, the
default step of the checkout in DIR (this file's child, run by path
with DIR's package on the path) as well, first in even turns and last
in odd ones, and prints each setting's median step ms over DIR's in the
same turn: the ratios, their median and quartiles.  Then the card's name
and power limit.  Needs a CUDA card.

    python3 -m tpu_rvc_torch.tools.determinism_probe --cost [--fp32]
        [--runs 10] [--timed 6] [--settings default step] [--against DIR]

`--cost` measures instead what the deterministic step costs as the
presets train (bf16 autocast; fp32 with `--fp32`): each child builds
v2/48k (segment 17280) and v2/40k (segment 12800) from seed 7 and takes,
for each of COST_SHAPES (a preset, the batch size, the bucket's frames),
one step on the new shape (its seconds, the peak reserved memory and the
reserved memory after it, the allocator's cache emptied before),
COST_WARM more and `--timed` timed ones (their median ms and peak
reserved memory).  Prints a line a setting and shape, then with
`--against DIR` each setting's ratios to DIR's median ms of the same
turn and shape: by shape, by batch size, and over all, median and
quartiles.
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

SETTINGS = {
    "default": (),
    "deterministic": ("algorithms", "cudnn", "cublas"),
    "cudnn": ("cudnn",),
    "cublas": ("cublas",),
    "algorithms": ("algorithms",),
    "cudnn_timed": ("cudnn", "timed"),
    "step": ("step",),
    "step_limit10": ("step", "limit10"),
}
LENGTHS = (200, 163, 200, 110)
SNAPSHOTS = (1, 5)
PROFILED_STEPS = 3


def _grad_recorder(state):
    """Record every parameter's gradient of the first step, as it is
    accumulated (the step drops them after each update) -> the dict it
    fills, by 'g.'/'d.' name."""
    grads = {}
    for tag, net in (("g.", state.net_g), ("d.", state.net_d)):
        for name, p in net.named_parameters():
            def hook(p, key=tag + name):
                if state.step == 0:
                    grads[key] = p.grad.detach().cpu().clone()
            p.register_post_accumulate_grad_hook(hook)
    return grads


def _kernel_table(prof, n_steps: int):
    """Device ms a step by kernel name, from a torch.profiler run."""
    from torch.autograd import DeviceType

    rows = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or "#" in e.key or \
                getattr(e, "is_user_annotation", False):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows[e.key] = [us / 1e3 / n_steps, e.count / n_steps]
    return rows


CONV_OPS = ("aten::cudnn_convolution", "aten::cudnn_convolution_transpose",
            "aten::convolution_backward")


def _conv_table(prof, n_steps: int):
    """Device ms a step of each convolution operator by its input shapes
    (the forward and the backward, each with the kernels it launched)."""
    rows = {}
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key not in CONV_OPS:
            continue
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0.0)
        shapes = [s for s in e.input_shapes if s][:3]
        rows[f"{e.key} {shapes}"] = [us / 1e3 / n_steps, e.count / n_steps]
    return rows


def switch_on(setting: str) -> set:
    """Set the process-wide switches of `setting` -> its switches."""
    import torch

    on = set(SETTINGS[setting])
    if "algorithms" in on:
        torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = "cudnn" in on
    torch.backends.cudnn.benchmark = "timed" in on
    if "limit10" in on:
        from tpu_rvc_torch.core import device
        device.SEARCH_LIMIT = 10
    return on


def child(setting: str, n_timed: int, out: str, profile: bool) -> None:
    import dataclasses

    import numpy as np
    import torch

    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.tools.dist_steps import (full_params, make_batch,
                                                run_steps)
    from tpu_rvc_torch.train.step import create_train_state

    on = switch_on(setting)
    hp = hparams_for("v2", 48000)
    hp = dataclasses.replace(hp, train=dataclasses.replace(
        hp.train, fp16_run=False))
    batches = ([make_batch(hp, LENGTHS, 21, 200, pins=(10, 120, 150, 60))]
               * 3 + [make_batch(hp, LENGTHS, 22, 200)] * 2)

    def one_run():
        state = create_train_state(hp, seed=7, device="cuda")
        state.deterministic = "step" in on
        grads = _grad_recorder(state)
        return (state, grads, *run_steps(state, batches, SNAPSHOTS,
                                         full_params))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, grads_0, _, _, snaps_0 = one_run()   # the same run again, here
        state, grads, metrics, ms, snaps = one_run()
        _, timed, _ = run_steps(state, batches[-1:] * n_timed)
    within = {str(n): param_gap(snaps[n], snaps_0[n]) for n in SNAPSHOTS}
    within["grads_1"] = grads_that_differ(grads, grads_0)
    ops = sorted({re.split(r" does not have", str(w.message))[0]
                  for w in caught
                  if "deterministic" in str(w.message)})
    kernels = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof_ctx

        with prof_ctx(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA],
                      record_shapes=True) as prof:
            run_steps(state, batches[-1:] * PROFILED_STEPS)
        kernels = _kernel_table(prof, PROFILED_STEPS)
        kernels["convs"] = _conv_table(prof, PROFILED_STEPS)
    torch.save({"snapshots": snaps, "ms": ms + timed, "ops": ops,
                "losses_1": metrics[0], "grads_1": grads, "within": within,
                "kernels": kernels,
                "median_timed_ms": float(np.median(timed))}, out)


def param_gap(got, want):
    import torch

    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    return {"max_abs": float(diff.max()),
            "beyond_1e6": float((diff > 1e-6).float().mean()),
            "bit_equal": bool((diff == 0).all())}


def grads_that_differ(got, want, top: int = 12):
    """The parameters whose first-step gradients are not bit-equal, by
    module path (the parameter's name without its last part), largest
    difference first: [(module, parameters, max abs difference)]."""
    mods = {}
    for k, w in want.items():
        d = float((got[k] - w).abs().max())
        if d > 0 or not bool((got[k] == w).all()):
            mod = k.rsplit(".", 1)[0]
            n, worst = mods.get(mod, (0, 0.0))
            mods[mod] = (n + 1, max(worst, d))
    rows = sorted(((m, n, d) for m, (n, d) in mods.items()),
                  key=lambda r: -r[2])
    return {"n_params": len(want),
            "n_differ": sum(n for _, n, _ in rows),
            "modules": [list(r) for r in rows[:top]],
            "n_modules": len(rows)}


def kernel_delta(table, base, top: int = 15):
    """Kernels whose device ms a step differ most from `base`'s:
    [(name, ms here, ms in base, calls here, calls in base)]."""
    names = set(table) | set(base)
    rows = [(n[:160], table.get(n, [0.0, 0])[0], base.get(n, [0.0, 0])[0],
             table.get(n, [0.0, 0])[1], base.get(n, [0.0, 0])[1])
            for n in names]
    rows.sort(key=lambda r: -abs(r[1] - r[2]))
    return {"total_ms": sum(v[0] for v in table.values()),
            "base_total_ms": sum(v[0] for v in base.values()),
            "top": [[n, round(a, 3), round(b, 3), ca, cb]
                    for n, a, b, ca, cb in rows[:top]]}


COST_SHAPES = (("v2", 48000, 4, 200), ("v2", 48000, 8, 300),
               ("v2", 40000, 4, 250), ("v2", 40000, 8, 150))
COST_WARM = 2


def cost_child(setting: str, n_timed: int, out: str, fp32: bool) -> None:
    """COST_SHAPES under `setting`, by the package on the path: only names
    every version of it since the deterministic option has (`run_steps`
    times to a synchronize)."""
    import dataclasses
    import gc
    import time

    import numpy as np
    import torch

    from tpu_rvc_torch.core.config import hparams_for
    from tpu_rvc_torch.tools.dist_steps import make_batch, run_steps
    from tpu_rvc_torch.train.step import create_train_state

    on = switch_on(setting)
    rows, state, preset = [], None, None
    for i, (version, sr, b, T) in enumerate(COST_SHAPES):
        if (version, sr) != preset:
            preset, state = (version, sr), None
            gc.collect()
            hp = hparams_for(version, sr)
            if fp32:
                hp = dataclasses.replace(hp, train=dataclasses.replace(
                    hp.train, fp16_run=False))
            state = create_train_state(hp, seed=7, device="cuda")
            state.deterministic = "step" in on
        batch = make_batch(state.hp, [T - 17 * (j % 3) for j in range(b)],
                           40 + i, T)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run_steps(state, [batch])
        first_s = time.perf_counter() - t0
        first_gb = torch.cuda.max_memory_reserved() / 1e9
        after_gb = torch.cuda.memory_reserved() / 1e9
        run_steps(state, [batch] * COST_WARM)
        torch.cuda.reset_peak_memory_stats()
        _, ms, _ = run_steps(state, [batch] * n_timed)
        rows.append({"shape": f"{version}/{sr // 1000}k b{b} T{T}",
                     "segment": state.hp.train.segment_size,
                     "first_step_s": first_s,
                     "first_peak_reserved_gb": first_gb,
                     "reserved_after_first_gb": after_gb,
                     "warm_peak_reserved_gb":
                         torch.cuda.max_memory_reserved() / 1e9,
                     "median_ms": float(np.median(ms)), "ms": ms})
    torch.save(rows, out)


def _run_child(setting: str, args, out: str, root=None,
               profile: bool = False):
    """One child: this file run by path, with this tree's package or
    (root) the checkout in root's on the path -> what it saved."""
    import torch

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(root or here))
    if "cublas" in SETTINGS[setting]:
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    else:
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    cmd = [sys.executable, os.path.abspath(__file__), "--timed",
           str(args.timed), "--child", setting, out]
    cmd += [f for f, on in (("--cost", args.cost), ("--fp32", args.fp32),
                            ("--profile", profile)) if on]
    subprocess.run(cmd, env=env, cwd=os.path.abspath(root or here),
                   check=True, timeout=900)
    return torch.load(out, weights_only=False)


def _spread(v):
    import numpy as np

    return {"median": float(np.median(v)),
            "quartiles": [float(np.percentile(v, 25)),
                          float(np.percentile(v, 75))],
            "n": len(v)}


def print_cost(results, against, root) -> None:
    """The lines `--cost` describes."""
    named = dict(results, **({"against": against} if against else {}))
    for s, turns in named.items():
        for k, row in enumerate(turns[0]):
            print(json.dumps({
                "setting": s, "shape": row["shape"],
                "segment": row["segment"], **{
                    key: [t[k][key] for t in turns]
                    for key in ("first_step_s", "first_peak_reserved_gb",
                                "reserved_after_first_gb",
                                "warm_peak_reserved_gb", "median_ms")}}),
                flush=True)
    if not against:
        return
    for s, turns in results.items():
        by_shape, by_batch, every = {}, {}, []
        for turn, base in zip(turns, against):
            for row, ref in zip(turn, base):
                r = row["median_ms"] / ref["median_ms"]
                by_shape.setdefault(row["shape"], []).append(r)
                by_batch.setdefault(row["shape"].split()[1], []).append(r)
                every.append(r)
        print(json.dumps({
            "setting": s, "against": os.path.abspath(root),
            "ratio": _spread(every),
            "by_batch": {k: _spread(v) for k, v in by_batch.items()},
            "by_shape": {k: dict(_spread(v), each=v)
                         for k, v in by_shape.items()}}), flush=True)


def print_runs(results, against, args) -> None:
    """The lines of the reproducibility runs."""
    for setting, runs in results.items():
        first = runs[0]
        line = {
            "setting": setting, "switches": list(SETTINGS[setting]),
            "ops_without_deterministic_implementation": sorted(
                {op for r in runs for op in r["ops"]}),
            "against_first_run": [
                {**{str(n): param_gap(r["snapshots"][n],
                                      first["snapshots"][n])
                    for n in SNAPSHOTS},
                 "losses_1_equal": r["losses_1"] == first["losses_1"],
                 "grads_1": grads_that_differ(r["grads_1"],
                                              first["grads_1"])}
                for r in runs[1:]],
            "within_process": [r["within"] for r in runs],
            "median_step_ms": [r["median_timed_ms"] for r in runs],
            "step_ms": [r["ms"] for r in runs]}
        print(json.dumps(line), flush=True)
    if args.profile and "default" in results:
        base = dict(results["default"][0]["kernels"])
        base_convs = base.pop("convs")
        deltas = {}
        for s, r in results.items():
            if s != "default":
                table = dict(r[0]["kernels"])
                convs = table.pop("convs")
                deltas[s] = dict(kernel_delta(table, base),
                                 convs=kernel_delta(convs, base_convs, 12))
        print(json.dumps({"kernels_against_default": deltas}), flush=True)
    if against:
        base = [r["median_timed_ms"] for r in against]
        print(json.dumps({
            "against": os.path.abspath(args.against),
            "against_median_step_ms": base,
            "ratio_to_against": {
                s: dict(_spread(v), each=v) for s, v in (
                    (s, [r["median_timed_ms"] / b
                         for r, b in zip(runs, base)])
                    for s, runs in results.items())}}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python3 -m tpu_rvc_torch.tools.determinism_probe")
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--timed", type=int, default=10)
    p.add_argument("--settings", nargs="+", default=list(SETTINGS),
                   choices=list(SETTINGS))
    p.add_argument("--profile", action="store_true")
    p.add_argument("--against", metavar="DIR")
    p.add_argument("--cost", action="store_true")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--child", nargs=2, metavar=("SETTING", "OUT"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child and args.cost:
        cost_child(args.child[0], args.timed, args.child[1], args.fp32)
        return 0
    if args.child:
        child(args.child[0], args.timed, args.child[1], args.profile)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("determinism_probe: CUDA is not available", file=sys.stderr)
        return 2
    results = {s: [] for s in args.settings}
    against = []
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.runs):
            if args.against and i % 2 == 0:
                against.append(_run_child("default", args, os.path.join(
                    tmp, f"against_{i}.pt"), args.against))
            for s in args.settings:
                results[s].append(_run_child(
                    s, args, os.path.join(tmp, f"{s}_{i}.pt"),
                    profile=args.profile and i == 0 and not args.cost))
            if args.against and i % 2 == 1:
                against.append(_run_child("default", args, os.path.join(
                    tmp, f"against_{i}.pt"), args.against))
    if args.cost:
        print_cost(results, against, args.against)
    else:
        print_runs(results, against, args)
    print(card_line())
    return 0


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


if __name__ == "__main__":
    sys.exit(main())
