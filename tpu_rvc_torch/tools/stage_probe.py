#!/usr/bin/env python3
"""Where the ResBlock1 stage kernel's time goes, conv by conv, on one card.

    python3 -m tpu_rvc_torch.tools.stage_probe

For each width of the v2/48k decoder at a 16 s bucket it times single
launches of the conv kernel for k = 3, 7, 11, as the first conv of a pair
(lrelu in and out, one store) and as the second (residual read, next x and
running stage output written), medians of CUDA events.  The slope over k
is what a tap costs (the tensor-core loop); what is left at k = 0 is the
conv's fixed cost (staging, epilogue, device memory).  Then it runs the
C = 128 stage in a loop for a few seconds beside `nvidia-smi`, to show
whether the card's power limit is what holds the clock.  One JSON line
per measurement, the card's name and power limit first.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from tpu_rvc_torch.core.device import fp32_math
from tpu_rvc_torch.ops.kernels import resblock as rs

SHAPES = ((256, 19176), (128, 191760), (64, 383520), (32, 767040))


def median_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def probe_convs(g):
    stream = torch.cuda.current_stream().cuda_stream
    for C, T in SHAPES:
        x = torch.randn(C, T, generator=g, device="cuda")
        res = torch.randn(C, T, generator=g, device="cuda")
        out, acc = torch.empty_like(x), torch.zeros_like(x)
        bias = torch.zeros(C, device="cuda")
        fn = rs._kernel(C)
        ms = {}
        for K in (3, 7, 11):
            w = torch.randn(K, C, C, generator=g, device="cuda")
            wp = rs.pack_conv_weight(w / math.sqrt(K * C))
            first = lambda: fn(x.data_ptr(), wp.data_ptr(), bias.data_ptr(),  # noqa: E731
                               0, out.data_ptr(), acc.data_ptr(), C, T, K, 1,
                               1, 1, 0, 1.0, stream)
            second = lambda: fn(x.data_ptr(), wp.data_ptr(), bias.data_ptr(),  # noqa: E731
                                res.data_ptr(), out.data_ptr(),
                                acc.data_ptr(), C, T, K, 1, 0, 0, 2, 1.0,
                                stream)
            ms[K] = (median_ms(first), median_ms(second))
        per_tap = (ms[11][0] - ms[3][0]) / 8
        print(json.dumps({
            "C": C, "T": T, "first_conv_ms": {k: v[0] for k, v in ms.items()},
            "second_conv_ms": {k: v[1] for k, v in ms.items()},
            "ms_per_tap": per_tap,
            "tap_tf32_tflops": 2 * C * C * T * 3 / per_tap / 1e9,
            "first_conv_fixed_ms": ms[3][0] - 3 * per_tap,
            "second_conv_fixed_ms": ms[3][1] - 3 * per_tap,
            "one_pass_of_the_activations_ms": 4 * C * T / 3.35e12 * 1e3}),
            flush=True)


def probe_power(g, seconds=3.0):
    C, T = 128, 191760
    ks = (3, 7, 11)
    x = torch.randn(C, T, generator=g, device="cuda") * 0.3
    w = [[torch.randn(k, C, C, generator=g, device="cuda")
          / math.sqrt(k * C) for _ in range(6)] for k in ks]
    b = [[torch.zeros(C, device="cuda") for _ in range(6)] for _ in ks]
    sw = rs.pack_stage(ks, (1, 3, 5), w, b)
    for name, fn in (("fused_stage", rs.fused_stage),
                     ("stage_plain", rs.stage_plain)):
        fn(x, sw)
        torch.cuda.synchronize()
        mon = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "250"],
            stdout=subprocess.PIPE, text=True)
        t0 = time.time()
        while time.time() - t0 < seconds:
            for _ in range(10):
                fn(x, sw)
            torch.cuda.synchronize()
        mon.terminate()
        rows = [ln.split(",") for ln in mon.communicate()[0].splitlines()]
        rows = [(float(r[0]), float(r[1])) for r in rows[3:] if len(r) == 2]
        print(json.dumps({
            "running": name, "C": C, "T": T, "samples": len(rows),
            "sm_clock_mhz_min_median_max": [
                min(r[0] for r in rows), float(np.median([r[0] for r in rows])),
                max(r[0] for r in rows)],
            "power_w_median": float(np.median([r[1] for r in rows]))}),
            flush=True)


def main():
    if not torch.cuda.is_available():
        print("stage_probe: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    with fp32_math():
        probe_convs(g)
        probe_power(g)
    return 0


if __name__ == "__main__":
    sys.exit(main())
