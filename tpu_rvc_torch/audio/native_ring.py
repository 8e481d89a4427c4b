"""ctypes binding for the native SPSC ring buffer (native/ringbuffer.cpp),
the port's own copy of tpu_rvc/audio/native_ring.py; it replaces the
reference's SharedMemory ring buffers in AudioIoProcess
(infer/lib/audio.py:206-376).

The library is the same `native/libringbuffer.so` the JAX package loads,
built on demand (`make -C native libringbuffer.so`); without a compiler a
numpy ring with the same API takes its place, and `is_native()` says which
of the two runs.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).parent.parent.parent / "native"
LIB_PATH = NATIVE_DIR / "libringbuffer.so"


def _ensure_built() -> Optional[ctypes.CDLL]:
    if not LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(NATIVE_DIR),
                            "libringbuffer.so"],
                           capture_output=True, check=True)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(LIB_PATH))
    except OSError:
        return None
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_uint64]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    for fn in ("rb_readable", "rb_writable", "rb_overruns", "rb_underruns"):
        getattr(lib, fn).restype = ctypes.c_uint64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.rb_write.restype = ctypes.c_uint64
    lib.rb_write.argtypes = [ctypes.c_void_p,
                             ctypes.POINTER(ctypes.c_float), ctypes.c_uint64]
    lib.rb_read.restype = ctypes.c_uint64
    lib.rb_read.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_float), ctypes.c_uint64]
    return lib


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        _LIB = _ensure_built() or False
    return _LIB or None


def is_native() -> bool:
    """True when new rings use the compiled library, False when they use
    the numpy ring."""
    return _lib() is not None


class NativeRingBuffer:
    """SPSC float ring; zero-fills on underrun, drops oldest on overrun."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        lib = _lib()
        if lib is not None:
            self._lib = lib
            self._h = lib.rb_create(capacity)
            if not self._h:
                raise MemoryError("rb_create failed")
            self._fallback = None
        else:  # the numpy ring
            self._lib = None
            self._fallback = np.zeros(capacity, np.float32)
            self._head = 0
            self._tail = 0
            self.overruns = 0
            self.underruns = 0

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def write(self, x: np.ndarray) -> int:
        x = np.ascontiguousarray(x, np.float32)
        if self._lib is not None:
            return int(self._lib.rb_write(
                self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                len(x)))
        n = min(len(x), self.capacity)
        x = x[-n:]
        if self._head + n - self._tail > self.capacity:
            self._tail = self._head + n - self.capacity
            self.overruns += 1
        idx = (self._head + np.arange(n)) % self.capacity
        self._fallback[idx] = x
        self._head += n
        return n

    def read(self, n: int) -> np.ndarray:
        out = np.zeros(n, np.float32)
        if self._lib is not None:
            self._lib.rb_read(
                self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                n)
            return out
        avail = self._head - self._tail
        take = min(avail, n)
        idx = (self._tail + np.arange(take)) % self.capacity
        out[:take] = self._fallback[idx]
        if take < n:
            self.underruns += 1
        self._tail += take
        return out

    def readable(self) -> int:
        if self._lib is not None:
            return int(self._lib.rb_readable(self._h))
        return self._head - self._tail

    def stats(self):
        if self._lib is not None:
            return {"overruns": int(self._lib.rb_overruns(self._h)),
                    "underruns": int(self._lib.rb_underruns(self._h))}
        return {"overruns": self.overruns, "underruns": self.underruns}

    def __del__(self):
        if getattr(self, "_lib", None) is not None and self._h:
            self._lib.rb_destroy(self._h)
            self._h = None
