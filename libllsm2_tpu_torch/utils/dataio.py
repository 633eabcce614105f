"""Corpus data loading (counterpart of libllsm2_tpu/utils/dataio.py): the
native C++ WAV batch loader with a scipy fallback.

The batched corpus path (BASELINE config 5) assembles padded
[batch, bucket_samples] arrays; doing that per file in Python is host-
bound, so the heavy lifting lives in native/llsm_loader.cpp (RIFF parse,
PCM->float32, channel average, zero-padded row writes), bound via ctypes.
The port compiles that source itself with g++ into build/native/ beside
the package (listed in .gitignore) on first use; where no compiler or
source is found it falls back to scipy, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Sequence, Tuple

import numpy as np

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC = os.path.join(_ROOT, "native", "llsm_loader.cpp")
_SO_PATH = os.path.join(_ROOT, "build", "native", "libllsm_loader.so")
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_lib_tried = False


def _build() -> None:
    """Compile the loader into _SO_PATH (through a temporary name, so that
    processes building at once never load a half-written library)."""
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    subprocess.run(["g++", *CXXFLAGS, "-o", tmp, _SRC], check=True,
                   capture_output=True)
    os.replace(tmp, _SO_PATH)


def _load():
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if (not os.path.exists(_SO_PATH)
                or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)):
            _build()
        lib = ctypes.CDLL(_SO_PATH)
        for name, ptr in (("llsm_load_batch", ctypes.c_float),
                          ("llsm_load_batch_i16", ctypes.c_int16)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.POINTER(ptr), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def load_wav_batch(paths: Sequence[str], bucket_samples: int,
                   dtype: str = "float32", out: np.ndarray | None = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load WAV files into a zero-padded [len(paths), bucket_samples]
    batch.  Returns (batch, lengths, sample_rates); rows that fail to
    parse have length 0.  Uses the native loader when available, scipy
    otherwise.

    dtype="int16" emits PCM16 rows (scaled by 32767): convert on the card
    with ``x.to(float32) * float32(1 / 32767)``, which halves the
    host->device bytes of the corpus hot path.  out (optional): a
    C-contiguous array of that shape and dtype to fill instead of a new
    one, e.g. a view of pinned host memory."""
    B = len(paths)
    i16 = dtype == "int16"
    np_dtype = np.int16 if i16 else np.float32
    if out is None:
        out = np.zeros((B, bucket_samples), np_dtype)
    elif (out.shape != (B, bucket_samples) or out.dtype != np_dtype
          or not out.flags.c_contiguous):
        raise ValueError(f"out must be a C-contiguous {np.dtype(np_dtype)} "
                         f"array of shape {(B, bucket_samples)}")
    lengths = np.zeros((B,), np.int64)
    rates = np.zeros((B,), np.int32)
    lib = _load()
    if lib is not None:
        blob = b"".join(p.encode() + b"\0" for p in paths)
        offsets = np.zeros((B,), np.int64)
        off = 0
        for i, p in enumerate(paths):
            offsets[i] = off
            off += len(p.encode()) + 1
        fn = lib.llsm_load_batch_i16 if i16 else lib.llsm_load_batch
        ptr_t = ctypes.c_int16 if i16 else ctypes.c_float
        fn(blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
           B, out.ctypes.data_as(ctypes.POINTER(ptr_t)),
           bucket_samples,
           lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
           rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out, lengths, rates
    from . import audio
    out[...] = 0
    for i, p in enumerate(paths):
        try:
            x, fs = audio.wavread(p)
            n = min(len(x), bucket_samples)
            row = np.clip(x[:n] * 32767.0, -32768, 32767).astype(np.int16) \
                if i16 else x[:n]
            out[i, :n] = row
            lengths[i] = n
            rates[i] = int(fs)
        except Exception:
            pass
    return out, lengths, rates


def wav_info(path: str) -> Tuple[int, int]:
    """(per-channel sample count, sample rate) from the RIFF header
    alone (no data read): corpus bucketing scans thousands of headers
    before loading anything.  Returns (0, 0) on ANY malformed header: the
    scanner sees the same untrusted files the hardened native loader does,
    so a truncated fmt chunk must not crash the corpus run (struct.error
    is not an OSError).  Chunk skips honor RIFF word alignment (odd-size
    ancillary chunks carry a pad byte), matching the native parser."""
    import struct
    try:
        with open(path, "rb") as f:
            hdr = f.read(12)
            if len(hdr) < 12 or hdr[:4] != b"RIFF":
                return 0, 0
            nch, bits, rate = 1, 16, 0
            while True:
                ck = f.read(8)
                if len(ck) < 8:
                    return 0, 0
                cid, size = ck[:4], struct.unpack("<I", ck[4:])[0]
                if cid == b"fmt ":
                    fmt = f.read(size)
                    if len(fmt) < 16:
                        return 0, 0
                    nch = struct.unpack("<H", fmt[2:4])[0]
                    rate = struct.unpack("<I", fmt[4:8])[0]
                    bits = struct.unpack("<H", fmt[14:16])[0]
                    if size % 2:
                        f.seek(1, 1)
                    if nch == 0 or bits // 8 == 0:
                        return 0, 0
                elif cid == b"data":
                    return size // max(nch * (bits // 8), 1), rate
                else:
                    f.seek((size + 1) & ~1, 1)
    except Exception:
        return 0, 0


def wav_nsamples(path: str) -> int:
    """Per-channel sample count from the RIFF header alone (see
    wav_info); 0 on any parse failure."""
    return wav_info(path)[0]
