"""Build and load the port's CUDA kernels (csrc/*.cu).

The sources are compiled with nvcc for sm_90a (Hopper) into ONE shared
library with a plain C interface and loaded with ctypes -- no PyTorch
headers, so the build takes seconds.  The library goes to
``build/kernels/`` beside the package (listed in .gitignore), named by a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # dc, ar, ai, kl, out, R, T, K, stream
    "llsm_osc_bank": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    # dc, frames, hw, lo, hi, kl, re, im, wsum, xsum, R, W, K, center,
    # c0, c1, c2, c3, ncoef, stream
    "llsm_harmonic_project_win": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _L, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    # ampl, phse, cyc_c, hw, eq_re, eq_im, out_re, out_im, B, N, K, D,
    # nhop, stride, nq, stream
    "llsm_deconv_full": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _P),
    # cyc, edc, ar, ai, base, segs, y, B, N, nhop, C, Ke, stream
    "llsm_noise_mod_ola": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P),
}

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (PATH or CUDA_HOME)")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libllsm2_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
