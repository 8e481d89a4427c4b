"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/*.cu` file exposes a plain C interface and is compiled on its
own into `build/kernels/<name>-<hash>.so` beside the package (the hash
covers the source text and the flags, so an edit rebuilds).  All the
sources compile at once, one nvcc process each.  Nothing is built when a
module is imported: the first launch on a CUDA tensor calls `load()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-lineinfo", "-Xptxas", "-v")
SOURCES = ("rel_attention", "resblock")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's -Xptxas -v report per source, and the wall seconds of the last build
ptxas_report: Dict[str, str] = {}
last_build_seconds: Optional[float] = None


def _nvcc() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (CUDA toolkit required to build "
                           "the tpu_rvc_torch kernels)")
    return cand


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, all nvcc processes in parallel."""
    global last_build_seconds
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        ptxas_report[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    last_build_seconds = time.time() - t0
    return {name: _target(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, building all on first use."""
    with _lock:
        if name not in _libs:
            paths = build()
            for n, p in paths.items():
                _libs[n] = ctypes.CDLL(str(p))
        return _libs[name]
