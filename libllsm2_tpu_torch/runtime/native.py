"""ctypes binding to the native streaming ring (native/llsm_ring.cpp):
the overlap-add ring buffer behind the streaming synthesizer
(counterpart of libllsm2_tpu/runtime/native.py; reference: llsmrt.c ->
the ring buffers behind llsm_rtsynth_buffer_feed / _fetch).

The port compiles the source with g++ into build/native/ beside the
package (listed in .gitignore) on first use, as utils/dataio.py builds
the loader.  Where the library cannot be built or loaded, OLARing raises:
there is no fallback ring.  `_PyRing` is the ring's plain twin in Python,
the reference the tests hold the native ring against.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_ROOT, "native", "llsm_ring.cpp")
_SO_PATH = os.path.join(_ROOT, "build", "native", "libllsm_ring.so")
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
_F32P = ctypes.POINTER(ctypes.c_float)

_lib = None


def _build() -> None:
    """Compile the ring into _SO_PATH (through a temporary name, so that
    processes building at once never load a half-written library)."""
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    res = subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{res.stderr}")
    os.replace(tmp, _SO_PATH)


def _load():
    """The ring library with its signatures set (built first where it is
    missing or older than its source)."""
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO_PATH)
            or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_SO_PATH)
    lib.llsm_ring_create.restype = ctypes.c_void_p
    lib.llsm_ring_create.argtypes = [ctypes.c_int64]
    lib.llsm_ring_destroy.restype = None
    lib.llsm_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.llsm_ring_add.restype = ctypes.c_int
    lib.llsm_ring_add.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64,
                                  ctypes.c_int64]
    lib.llsm_ring_advance.restype = None
    lib.llsm_ring_advance.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.llsm_ring_readable.restype = ctypes.c_int64
    lib.llsm_ring_readable.argtypes = [ctypes.c_void_p]
    lib.llsm_ring_read.restype = ctypes.c_int64
    lib.llsm_ring_read.argtypes = [ctypes.c_void_p, _F32P, ctypes.c_int64]
    _lib = lib
    return lib


class OLARing:
    """Overlap-add ring buffer of `capacity` float32 samples, in native
    code.

    add(seg, pos): OLA `seg` at absolute sample position `pos` (BufferError
      when the write would reach behind the read point or past capacity).
    advance(upto): finalize samples < upto (ready for read).
    read(n): pop up to n finalized samples.
    """

    def __init__(self, capacity: int):
        self._lib = _load()
        self.capacity = int(capacity)
        self._ptr = self._lib.llsm_ring_create(self.capacity)
        if not self._ptr:
            raise MemoryError(f"llsm_ring_create({self.capacity}) failed")

    def add(self, seg: np.ndarray, pos: int) -> None:
        seg = np.ascontiguousarray(seg, np.float32)
        if self._lib.llsm_ring_add(self._ptr, seg.ctypes.data_as(_F32P),
                                   len(seg), int(pos)) != 0:
            raise BufferError("ring overrun")

    def advance(self, upto: int) -> None:
        self._lib.llsm_ring_advance(self._ptr, int(upto))

    def readable(self) -> int:
        return int(self._lib.llsm_ring_readable(self._ptr))

    def read(self, n: int) -> np.ndarray:
        out = np.empty(max(int(n), 0), np.float32)
        got = int(self._lib.llsm_ring_read(
            self._ptr, out.ctypes.data_as(_F32P), len(out)))
        return out[:got]

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.llsm_ring_destroy(ptr)
            self._ptr = None


class _PyRing:
    """OLARing's plain twin in Python (the JAX package's fallback ring),
    the reference of the tests."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._buf = np.zeros(self.capacity, np.float32)
        self._head = self._tail = self._wmax = 0

    def add(self, seg: np.ndarray, pos: int) -> None:
        seg = np.asarray(seg, np.float32)
        if pos < self._head or pos + len(seg) - self._head > self.capacity:
            raise BufferError("ring overrun")
        for i, v in enumerate(seg):
            a = pos + i
            idx = a % self.capacity
            if a >= self._wmax:
                self._buf[idx] = v
            else:
                self._buf[idx] += v
        self._wmax = max(self._wmax, pos + len(seg))

    def advance(self, upto: int) -> None:
        self._tail = max(self._tail, min(upto, self._wmax))

    def readable(self) -> int:
        return self._tail - self._head

    def read(self, n: int) -> np.ndarray:
        got = max(min(n, self.readable()), 0)
        idx = (self._head + np.arange(got)) % self.capacity
        out = self._buf[idx].copy()
        self._buf[idx] = 0.0
        self._head += got
        return out
