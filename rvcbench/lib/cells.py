"""Everything of one cell is found by name: its traffic in
`traffic/<cell>.json`, its configuration in `configs/<config>.json`, the
driver of its entry in `drivers/<entry>.py`, and each metric's reader in
`metrics/<metric>.py`.  Which metrics a cell reports is what
`BENCHMARK.json` at the root of the checkout lists for it."""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]
BENCHMARK = ROOT.parent / "BENCHMARK.json"


def _json(kind: str, name: str) -> Dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} ({path})")
    return json.loads(path.read_text())


def traffic(cell: str) -> Dict:
    return _json("traffic", cell)


def config(name: str) -> Dict:
    return _json("configs", name)


def driver(entry: str) -> ModuleType:
    return importlib.import_module(f"rvcbench.drivers.{entry}")


def metric(name: str) -> ModuleType:
    path = ROOT / "metrics" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no metric reader {path}")
    spec = importlib.util.spec_from_file_location(
        "rvcbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict:
    return json.loads(BENCHMARK.read_text())


def metrics_for(cell: str, trace: bool, bench: Dict = None) -> List[Dict]:
    """The entries of BENCHMARK.json's `end_to_end` (trace off) or
    `per_layer` (trace on) that this cell reports."""
    bench = benchmark() if bench is None else bench
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]
