"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by its own nvcc process for sm_90a (Hopper), all
started together, and the objects are linked into ONE shared library with
a plain C interface, loaded with ctypes -- no PyTorch headers, so the
build takes seconds.  The library goes to ``build/kernels/`` beside the
package (listed in .gitignore), named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused.  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -Xptxas -v: each kernel's registers, spills and shared memory, kept in
# <library>.ptxas.txt beside the library (resource_usage reads it)
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
                     "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
# C entry points: name -> argtypes (every one returns cudaGetLastError())
SIGNATURES = {
    # cyc, ampl, phse, mask, x (or null), y, B, N, K, nhop, stream
    "llsm_osc_bank": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, rep, nx, N, K, nhop,
    # center, c0, c1, c2, c3, ncoef, stream
    "llsm_harmonic_project_win": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                  _F, _I, _P),
    # ampl, phse, cyc_c, hw, eq_re, eq_im, out_re, out_im, B, N, K, D,
    # nhop, stride, nq, stream
    "llsm_deconv_full": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _P),
    # cyc, edc, ar, ai, base, segs, y, B, N, nhop, C, Ke, stream
    "llsm_noise_mod_ola": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P),
    # a, p, cyc_c, mask, voiced, pp, cs2, r2, guard (bool), cre, cim, csr,
    # csi, B, N, K, taps1 (host), n1, taps2 (host), n2, complex_input, stream
    "llsm_denoise_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _I, _I, _P, _I, _P, _I, _I, _P),
    # v, wmul, cre, cim, csr, csi, cyc_c, mask, guard, o_r, o_i, fr, fi,
    # ur, ui, B, N, K, strength, emit, stream
    "llsm_denoise_apply": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # dc, xw, lo, hi, re, im, R, W, K, stream
    "llsm_harmonic_project": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
    # x, cyc, hw, re, im, wsum, xsum, B, nx, N, K, nhop, reach, c0, c1, c2,
    # c3, ncoef, stream
    "llsm_harmonic_project_mxu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _F, _F, _I, _P),
    # in0, out0, C0, in1, out1, C1, B, N, taps (device), ntaps, stream
    "llsm_fir_frames": (_P, _P, _I, _P, _P, _I, _I, _I, _P, _I, _P),
    # cyc, edc, ar, ai, base, env, base_out, B, N, nhop, nx, C, Ke, stream
    "llsm_env_render": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P),
    # re, im, bits_re, bits_im (or null), seed, frame_base, N, nbin, stream
    "llsm_noise_bins": (_P, _P, _P, _P, _U, _U, _I, _I, _P),
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


def _run_all(cmds) -> str:
    """Run the commands in parallel -> their stderr, joined; raise with the
    failures' stderr."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed, errs = [], []
    for cmd, proc in procs:
        _, err = proc.communicate()
        errs.append(err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(errs)


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
        tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
        objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
        nvcc = _nvcc()
        try:
            report = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                               for s, o in zip(sources, objs)])
            out.with_suffix(".ptxas.txt").write_text(report)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            _run_all([[nvcc, *ARCH, "-shared", "-o", str(tmp),
                       *map(str, objs)]])
            os.replace(tmp, out)
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ptxas_report = out.with_suffix(".ptxas.txt")
    _lib = lib
    return lib


def resource_usage() -> list:
    """[(kernel, registers, spill bytes stored + loaded, static shared
    bytes)] of every compiled kernel, from the build's ptxas report."""
    report = library().ptxas_report
    rows, name, spill = [], None, 0
    for line in (report.read_text() if report.exists() else "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), spill,
                         int(smem.group(1)) if smem else 0))
            name = None
    return rows
