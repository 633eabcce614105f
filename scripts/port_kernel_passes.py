"""Where the time of four of the port's kernels goes, by compiling passes
out: noise_mod_ola.cu (pass 1, the band iDFT; pass 2, the OLA, envelope
and band sum), deconv_full.cu (the tap build; the output pass),
harmonic_project_mxu.cu (the making of G and the window rows; the banded
product) and sample_cycles.cu (the steps' lerp and divide; the output
pass, on F0 70-300 Hz with every 7th frame unvoiced), each built four
times from the sources in
libllsm2_tpu_torch/csrc with one, the other, both or neither pass skipped
(their LLSM_SKIP_PASS_A / _B), and timed at the bench shape (128 rows x
1600 frames, 16 kHz: hop 80, K 80, D 7; the projection's halfwidths 107-
458, as F0 70-300 Hz gives them, reach 480) on random inputs, a launch's
share of a run of 20 (CUDA events, best of 5).  What is left with both
passes skipped is the staging: the block's loads into shared memory and
its tables (for the projection, the chunk walk, its barriers and the
epilogue).  Needs a CUDA card and nvcc; imports no jax:

    PYTHONPATH=. python3 scripts/port_kernel_passes.py [only=name,...]

The variants go to build/dev/ (listed in .gitignore).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from libllsm2_tpu_torch.config import ChunkConf
from libllsm2_tpu_torch.ops import _build, kernels

OUT = Path(__file__).resolve().parents[1] / "build" / "dev"
B, N, NHOP, C, KE, K, D = 128, 1600, 80, 4, 4, 80, 7
# source -> what its LLSM_SKIP_PASS_A and LLSM_SKIP_PASS_B compile out
PASSES = {
    "noise_mod_ola": ("pass 1 (band iDFT)",
                      "pass 2 (OLA, envelope, band sum)"),
    "deconv_full": ("the tap build", "the output pass"),
    "harmonic_project_mxu": ("G and the window rows", "the banded product"),
    "sample_cycles": ("the steps' lerp and divide", "the output pass"),
}


def build_variants(names):
    """-> {(name, skip_a, skip_b): loaded library} for the kernels `names`,
    one nvcc each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        for a in (0, 1):
            for b in (0, 1):
                so = OUT / f"passes_{name}_{a}{b}.so"
                cmd = [_build._nvcc(), *_build.ARCH, "-std=c++17", "-O3",
                       "-Xcompiler", "-fPIC", "-shared", f"-I{_build.CSRC}",
                       f"-DLLSM_SKIP_PASS_A={a}", f"-DLLSM_SKIP_PASS_B={b}",
                       "-o", str(so), str(_build.CSRC / f"{name}.cu")]
                jobs[(name, a, b)] = (so, subprocess.Popen(
                    cmd, stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, "llsm_" + key[0])
        fn.argtypes = _build.SIGNATURES["llsm_" + key[0]]
        libs[key] = fn
    return libs


def run_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    names = kw["only"].split(",") if "only" in kw else list(PASSES)
    libs = build_variants(names)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    nbin = NHOP + 1
    cyc = r(B, N * NHOP)
    edc, base = r(B, N, C), r(B, N, C) + 0.5
    ar, ai = r(B, N, C, KE) - 0.5, r(B, N, C, KE) - 0.5
    re, im = (torch.randn(N, nbin, generator=g, device=dev) for _ in range(2))
    gain = r(B, N, nbin)
    bands = kernels.band_ranges(nbin, 16000.0, tuple(ChunkConf().chan_edges))
    ranges = (ctypes.c_int * (2 * C))(*bands)
    y = torch.empty(B, N * NHOP, device=dev)
    ampl, phse, mask = r(B, N, K), 6.0 * r(B, N, K) - 3.0, (r(B, N, K) > 0.1)
    mask = mask.float()
    hw = 100.0 + 300.0 * r(B, N)
    o_a, o_b = torch.empty_like(ampl), torch.empty_like(ampl)
    x = torch.randn(B, N * NHOP, generator=g, device=dev)
    hw_p = 32000.0 / (70.0 + 230.0 * r(B, N))          # F0 70-300 Hz
    p_re, p_im = torch.empty_like(ampl), torch.empty_like(ampl)
    p_ws, p_xs = torch.empty_like(hw_p), torch.empty_like(hw_p)
    f0 = 70.0 + 230.0 * r(B, N)
    f0[:, ::7] = 0.0                                   # voicing edges
    cyc_o = torch.empty(B, N * NHOP, device=dev)
    # its tile words (at most one a row's 8 hops; the C entry zeroes them)
    words = torch.empty(B * ((N + 7) // 8), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "noise_mod_ola": lambda fn: fn(
            cyc.data_ptr(), edc.data_ptr(), ar.data_ptr(), ai.data_ptr(),
            base.data_ptr(), re.data_ptr(), im.data_ptr(), 0,
            gain.data_ptr(), ctypes.addressof(ranges), y.data_ptr(), B, N,
            NHOP, C, KE, stream),
        "deconv_full": lambda fn: fn(
            ampl.data_ptr(), phse.data_ptr(), cyc.data_ptr(), hw.data_ptr(),
            mask.data_ptr(), o_a.data_ptr(), o_b.data_ptr(), B, N, K, D, NHOP,
            8, 0, stream),
        "harmonic_project_mxu": lambda fn: fn(
            x.data_ptr(), cyc.data_ptr(), hw_p.data_ptr(), p_re.data_ptr(),
            p_im.data_ptr(), p_ws.data_ptr(), p_xs.data_ptr(), B, N * NHOP,
            N, K, NHOP, 6 * NHOP, 0.5, -0.5, 0.0, 0.0, stream),
        "sample_cycles": lambda fn: fn(
            f0.data_ptr(), cyc_o.data_ptr(), words.data_ptr(), None, 0, B,
            N, NHOP, N * NHOP, 16000.0, stream),
    }
    for (name, a, b), fn in libs.items():
        rc = calls[name](fn)
        if rc:
            raise RuntimeError(f"{name} {a}{b}: cudaError {rc}")
        pa, pb = PASSES[name]
        skipped = [p for p, s in ((pa, a), (pb, b)) if s] or ["nothing"]
        print(f"{name}: skipping {' and '.join(skipped)}: "
              f"{run_ms(lambda: calls[name](fn)):.4f} ms a launch in a run "
              f"of 20", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
