"""What the drivers share: the set-up's clock, the files the program
loads (a small model `.pth`, `rmvpe.pt`) and the HuBERT it is handed,
all from the input bundle (`lib/inputs.py`), and the harness's phase
marks in a traced window."""

from __future__ import annotations

import os
import time
from typing import Dict, Tuple

import torch


class Clock:
    """Seconds of each set-up phase, in order."""

    def __init__(self):
        self.laps: Dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + now - self._t
        self._t = now


def write_files(bundle: Dict, cfg: Dict, tmp: str) -> Tuple[str, str]:
    """The small model and `rmvpe.pt` under `tmp` -> (model path, RMVPE
    directory)."""
    model = os.path.join(tmp, "model.pth")
    torch.save({"weight": bundle["synth"], "config": bundle["config"],
                "f0": int(cfg["f0"]), "version": cfg["version"],
                "info": "random weights"}, model)
    rmvpe_dir = os.path.join(tmp, "rmvpe")
    os.makedirs(rmvpe_dir, exist_ok=True)
    torch.save(bundle["rmvpe"], os.path.join(rmvpe_dir, "rmvpe.pt"))
    return model, rmvpe_dir


def program_hubert(bundle: Dict, cfg: Dict, device):
    """The program's HuBERT, loaded from the bundle's fairseq layout."""
    from tpu_rvc_torch.ckpt.hubert_loader import hubert_state_from_fairseq
    from tpu_rvc_torch.models.hubert import Hubert
    from rvcbench.ref.models import hubert_kwargs

    kw = hubert_kwargs(cfg["hubert"])
    with torch.device(device):
        hub = Hubert(**kw)
    hub.load_state_dict(hubert_state_from_fairseq(
        bundle["hubert"], kw["output_layer"], kw["final_proj"]))
    return hub.eval()


class nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def phase(traced: bool, name: str):
    """A mark on the trace's host timeline, which names the idle gaps."""
    if traced:
        return torch.profiler.record_function(name)
    return nothing()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
