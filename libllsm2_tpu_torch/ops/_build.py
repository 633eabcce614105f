"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by its own nvcc process for sm_90a (Hopper), all
started together, and the objects are linked into ONE shared library with
a plain C interface, loaded with ctypes -- no PyTorch headers, so the
build takes seconds.  The library goes to ``build/kernels/`` beside the
package (listed in .gitignore), named by a hash of the sources and flags,
so an edited source rebuilds and an unchanged one is reused.  Nothing
here runs at import time.

This build cache is the port's only cache: the JAX package's
utils/cache.py wires XLA's persistent compile cache, which PyTorch's eager
ops do not have, so the port has no counterpart of that module.
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
# C entry points: name -> argtypes (each returns an int: cudaGetLastError(),
# or for llsm_sample_cycles_words a count)
SIGNATURES = {
    # cyc, ampl, phse, mask, x (or null), y, B, N, K, nhop, stream
    "llsm_osc_bank": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x, cyc, hw, lo, hi, kl, re, im, wsum, xsum, Bx, rep, nx, N, K, nhop,
    # center, c0, c1, c2, c3, ncoef, F, Q (kernels._proj_win_geometry),
    # stream
    "llsm_harmonic_project_win": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                                  _F, _I, _I, _I, _P),
    # ampl, phse, cyc, hw, mask, out_a, out_b, taps (the wide path's
    # scratch, or null), B, N, K, D, nhop, stride, polar, FT, KC (0: the
    # first kernel), TT, stage (kernels._deconv_geometry), stream
    "llsm_deconv_full": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _I, _P),
    # cyc, edc, ar, ai, base, re, im, spec batch stride, gain, bands (host,
    # 2 C ints), bands (device, or null), y, B, N, nhop, C, Ke, F, threads,
    # chunk (kernels._noise_geometry), the long kernel's scratch (or null),
    # stream
    "llsm_noise_mod_ola": (_P, _P, _P, _P, _P, _P, _P, _L, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # cyc, edc, ar, ai, base, segs, y, B, N, nhop, C, Ke, stream
    "llsm_noise_mod_ola_seg": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _P),
    # a, p, cyc_c, mask, voiced, pp, cs2, r2, guard (bool), cre, cim, csr,
    # csi, B, N, K, taps1 (host), n1, taps2 (host), n2, taps1, taps2
    # (device, or null), kc, cw (kernels._denoise_geometry), the wide
    # path's scratch part, edge (or null), complex_input, stream
    "llsm_denoise_stats": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _I, _I,
                           _P, _P, _I, _P),
    # v, wmul, cre, cim, csr, csi, cyc_c, mask, guard (bool), o0, o1, B, N,
    # K, strength, polar, warps, blocks, per, stage
    # (kernels._apply_geometry), stream
    "llsm_denoise_apply": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                           _I, _I, _F, _I, _I, _I, _I, _I, _P),
    # a, delta (complex64), cyc_c, mask, ampl, phse, B, N, K, stream
    "llsm_denoise_finish": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # dc, xw, lo, hi, re, im, R, W, K, S, G (kernels._project_geometry),
    # stream
    "llsm_harmonic_project": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I,
                              _P),
    # x, cyc, hw, re, im, wsum, xsum, B, nx, N, K, nhop, reach, c0, c1, c2,
    # c3 (the window's cosine coefficients, zero past its own), stream
    "llsm_harmonic_project_mxu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _F, _F, _F, _F, _P),
    # in0, out0, C0, in1, out1, C1, B, N, taps (device), ntaps, stream
    "llsm_fir_frames": (_P, _P, _I, _P, _P, _I, _I, _I, _P, _I, _P),
    # cyc, edc, ar, ai, base, env, base_out, B, N, nhop, nx, C, Ke, stream
    "llsm_env_render": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _P),
    # re, im, bits_re, bits_im (or null), seed, frame_base, N, nbin, stream
    "llsm_noise_bins": (_P, _P, _P, _P, _U, _U, _I, _I, _P),
    # f0, out, words (int64 scratch: llsm_sample_cycles_words of them),
    # base (a float64 a row, or null), start, B, N, nhop, nx, fs, stream
    "llsm_sample_cycles": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    # B, nhop, nx -> how many words llsm_sample_cycles needs
    "llsm_sample_cycles_words": (_I, _I, _I),
    # x, f0, taps (device), out, B, nx, N, D, g, ntaps, nhop_d, C, Wf,
    # delta_d, iters, H_d, fs_d, dt_d, 2 pi dt_d, rel_winsize fs_d,
    # 1 - max_rel_dev, 1 + max_rel_dev, pass_hz, lo, hi, a0, a1, a2, a3 (the
    # window's cosine coefficients), ncoef (0: mltsine), F, G, P, PQ
    # (kernels._refine_geometry), stream
    "llsm_refine_f0_dec": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _L,
                           _L, _F, _F, _F, _F, _I, _I, _I, _I, _I, _P),
    # x, f0, out, B, nx, N, nhop, H, delta, iters, fs, dt, 2 pi dt,
    # rel_winsize fs, 1 - max_rel_dev, 1 + max_rel_dev, a0, a1, a2, a3,
    # ncoef, F, G (kernels._refine_geometry at D = 1), stream
    "llsm_refine_f0_full": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                            _F, _F, _F, _F, _F, _F, _F, _F, _I, _I, _I, _P),
    # obs, lt, path, final scores, backpointer scratch (or null), the
    # cooperative kernels' work (or null), B, N, S, renorm, P, C, lt_mode,
    # bp_smem, bp_bytes (kernels._viterbi_geometry), warps, row warps, row
    # blocks (kernels._viterbi_grid or _viterbi_stream; 0 but in lt modes 4
    # and 5), dest warps, rows a thread, chunk (_viterbi_stream; 0 but in
    # lt mode 5), stream
    "llsm_viterbi_scan": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
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


def _digest(flags, paths) -> str:
    """A hash of the flags and of the files' names and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of every C entry point the library has."""
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def variants(specs) -> list:
    """One loaded library each of specs [(source stem, {macro: value})]:
    that source of csrc/ alone, built with NVCC_FLAGS and the macros as -D
    defines (a kernel's LLSM_SKIP_PASS_A / _B, say), into BUILD_DIR under a
    hash of the source, the headers, the flags and the defines, so an
    unchanged variant is reused; the missing ones by one nvcc each, all
    started together."""
    headers = sorted(CSRC.glob("*.cuh"))
    outs, cmds = [], []
    for stem, macros in specs:
        src = CSRC / f"{stem}.cu"
        flags = NVCC_FLAGS + tuple(f"-D{k}={v}" for k, v in
                                   sorted(macros.items()))
        out = BUILD_DIR / f"{stem}_{_digest(flags, [src, *headers])}.so"
        outs.append(out)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmds.append((tmp, out, [_nvcc(), *flags, "-shared", "-o",
                                    str(tmp), str(src)]))
    if cmds:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _run_all([cmd for _, _, cmd in cmds])
        for tmp, out, _ in cmds:
            os.replace(tmp, out)
    return [_bind(ctypes.CDLL(str(out))) for out in outs]


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    digest = _digest(NVCC_FLAGS, sorted(CSRC.glob("*.cu*")))
    out = BUILD_DIR / f"libllsm2_kernels_{digest}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{digest}.{os.getpid()}"
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
    lib = _bind(ctypes.CDLL(str(out)))
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
