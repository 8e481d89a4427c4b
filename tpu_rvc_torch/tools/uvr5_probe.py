#!/usr/bin/env python3
"""The UVR5 nets alone on one card, by windows a call, under cuDNN's
heuristic algorithm choice and under its timed one.

    python3 -m tpu_rvc_torch.tools.uvr5_probe

For the full-width HP5-style `CascadedASPPNet` and the DeEcho
`CascadedNetDeEcho` (random weights, n_fft 1344, 512-frame windows) it
times a call of B windows (median of 3 CUDA-event runs after a warm-up)
and reads the peak memory, in fp32 without TF32 as the separators run.
Each setting runs in a process of its own: cuDNN keeps the algorithm it
chose for a shape for the rest of the process.  One JSON line per
measurement, the card's name and power limit first.
"""

import json
import subprocess
import sys

import numpy as np
import torch

SETTINGS = ("heuristic", "timed")
BATCHES = {"hp5": (1, 3, 4, 8), "deecho": (1, 3, 8)}


def make_net(name: str) -> torch.nn.Module:
    from tpu_rvc_torch.ckpt import uvr5_loader as ld
    from tpu_rvc_torch.models.uvr5 import CascadedASPPNet, CascadedNetDeEcho

    if name == "hp5":
        net = CascadedASPPNet(1344)
        net.load_state_dict(ld.cascaded_aspp_state_from_reference(
            ld.random_cascaded_aspp_reference_state(41, 1344)))
    else:
        net = CascadedNetDeEcho(1344)
        net.load_state_dict(ld.deecho_state_from_reference(
            ld.random_deecho_reference_state(42, 1344)))
    return net.cuda().eval()


def time_call(net, batch: int, iters: int = 3):
    from tpu_rvc_torch.core.device import fp32_math

    x = torch.rand(batch, 2, 673, 512, device="cuda")
    agg = (torch.tensor(0.1, device="cuda"), 85)
    with torch.no_grad(), fp32_math():
        net(x, agg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            net(x, agg)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return float(np.median(times)), torch.cuda.max_memory_allocated() / 1e9


def run_setting(setting: str) -> None:
    torch.backends.cudnn.benchmark = setting == "timed"
    for name, batches in BATCHES.items():
        net = make_net(name)
        for batch in batches:
            ms, gb = time_call(net, batch)
            print(json.dumps({"net": name, "cudnn": setting, "windows": batch,
                              "ms": ms, "ms_per_window": ms / batch,
                              "peak_mem_gb": gb}), flush=True)
        del net
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("uvr5_probe: CUDA is not available", file=sys.stderr)
        return 2
    if len(sys.argv) > 1:
        run_setting(sys.argv[1])
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for setting in SETTINGS:
        subprocess.run([sys.executable, "-m", "tpu_rvc_torch.tools.uvr5_probe",
                        setting], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
