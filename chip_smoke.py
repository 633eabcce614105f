#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libllsm2_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero without the final
"ok" line:
  1. device: a CUDA card must be present; prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles the port's CUDA kernels from libllsm2_tpu_torch/csrc.
  3. kernels: captures every kernel's inputs on the library-default path
     (denoiser on) of the first 2 bench rows (K = 80, Wf = 960, plus the
     envelope projection), runs kernel and plain PyTorch version on them
     on the card, checks the maximum error against each tolerance, and
     times both (median of 10, CUDA events).  The denoiser kernels' other
     variants (apply without emit_resid, stats from (ampl, phse) = (|c|,
     angle c) of the captured complex track) run on the same inputs.
  4. denoiser off: batched_pipeline on 32 bench rows (16 noisy, 16 clean;
     ChunkConf(f0_floor=70), track_denoise=False, use_pallas=True) after
     zeroing the launch counters; its four kernels must have launched,
     the clean rows must reach 55.17 dB, noisy rows 0 and 1 must lie within
     0.2 dB of 32.69 and 33.14 dB.  Then the step time (median of 5).
  5. main path, the library default (create_aoptions(f0_floor=70,
     use_pallas=True): denoiser on, spectral gate at decimation 4) on all
     128 rows x 8 s after zeroing the launch counters: all six kernels must
     have launched, clean rows >= 55.17 dB, noisy rows 0 and 1 within 0.2
     dB of 40.05 and 40.6 dB.  Then the step time (median of 5) and peak
     memory.
The line before the last is the kernels' JSON summary (launches from
phase 5); the last line is {"ok": true, "device": {...}}.  TF32 is off for
every float32 matmul.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

BATCH, DURATION, N_NOISY = 128, 8.0, 64
OFF_ROWS = list(range(16)) + list(range(N_NOISY, N_NOISY + 16))  # phase 4
CLEAN_MIN_DB = 55.17                      # JAX Pallas-branch reference: 55.27
NOISY_TOL_DB = 0.2
# JAX Pallas-branch references on noisy rows 0 and 1
NOISY_PINS_DB = {"denoiser off": {0: 32.69, 1: 33.14},
                 "library default": {0: 40.05, 1: 40.6}}
# kernel -> (source, TPU kernel it replaces, tolerance on max |error|); a
# string tolerance "rel x" is x times the largest |track| of the call's
# inputs (the denoiser's: test_pallas.py's 2e-3 x scale)
KERNELS = {
    "harmonic_project_win": ("libllsm2_tpu_torch/csrc/harmonic_project_win.cu",
                             "libllsm2_tpu/ops/pallas_osc.py:254", 2e-3),
    "deconv_full": ("libllsm2_tpu_torch/csrc/deconv_full.cu",
                    "libllsm2_tpu/ops/pallas_osc.py:639", 5e-4),
    "osc_bank": ("libllsm2_tpu_torch/csrc/osc_bank.cu",
                 "libllsm2_tpu/ops/pallas_osc.py:112", 2e-4),
    "noise_mod_ola": ("libllsm2_tpu_torch/csrc/noise_mod_ola.cu",
                      "libllsm2_tpu/ops/pallas_osc.py:457", 5e-5),
    "denoise_stats": ("libllsm2_tpu_torch/csrc/denoise_stats.cu",
                      "libllsm2_tpu/ops/pallas_osc.py:1156", "rel 2e-3"),
    "denoise_apply": ("libllsm2_tpu_torch/csrc/denoise_apply.cu",
                      "libllsm2_tpu/ops/pallas_osc.py:1238", "rel 2e-3"),
}


class PhaseError(Exception):
    pass


def phase(name, ok, detail):
    print(f"phase {name}: {'ok' if ok else 'FAIL'} {detail}", flush=True)
    if not ok:
        raise PhaseError(f"{name}: {detail}")


def cuda_ms(torch, fn, reps):
    """Median milliseconds of fn() over reps runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def track_scale(torch, name, args, kw):
    """Largest |track| among a denoiser call's inputs."""
    if name == "denoise_stats" and not kw.get("complex_input"):
        return float(torch.max(torch.abs(args[0])))
    return float(torch.max(torch.hypot(args[0], args[1])))


def max_err(torch, name, got, ref, scale=1.0):
    """Max |error| of a kernel's outputs.  Complex (re, im) pairs count
    |delta re + j delta im|; the denoiser's powers (pp, |c_s|^2, |r|^2)
    count |delta| / scale and its unit rotation factors |delta| x scale,
    so every term is in track units; a flipped guard is an infinite
    error."""
    cplx = lambda a, b: float(torch.max(torch.hypot(a[0] - b[0], a[1] - b[1])))
    if name == "deconv_full":
        return cplx(got, ref)
    if name == "denoise_stats":
        if not torch.equal(got[3], ref[3]):
            return float("inf")
        powers = max(float(torch.max(torch.abs(g - r)))
                     for g, r in zip(got[:3], ref[:3]))
        return max(powers / scale, cplx(got[4:6], ref[4:6]),
                   cplx(got[6:8], ref[6:8]))
    if name == "denoise_apply":
        errs = [cplx(got[i:i + 2], ref[i:i + 2]) for i in range(0, len(got), 2)]
        if len(errs) == 3:
            errs[2] *= scale
        return max(errs)
    got = (got,) if torch.is_tensor(got) else got
    ref = (ref,) if torch.is_tensor(ref) else ref
    return max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref))


def variants(torch, name, args, kw):
    """The non-default variants of a captured denoiser call."""
    if name == "denoise_apply":
        return [("emit_resid=False", args, dict(kw, emit_resid=False))]
    if name == "denoise_stats":
        ap = (torch.hypot(args[0], args[1]), torch.atan2(args[1], args[0]))
        return [("(ampl, phse) input", ap + tuple(args[2:]),
                 dict(kw, complex_input=False))]
    return []


def check_kernel(torch, kernels, name, tol, args, kw, label):
    """Kernel against its plain version on one call's inputs -> case."""
    fn = getattr(kernels, name)
    ref_fn = getattr(kernels, name + "_ref")
    got, ref = fn(*args, **kw), ref_fn(*args, **kw)
    torch.cuda.synchronize()
    scale = 1.0
    if isinstance(tol, str):
        scale = track_scale(torch, name, args, kw)
        tol = float(tol.split()[1]) * scale
    err = max_err(torch, name, got, ref, scale)
    ms = cuda_ms(torch, lambda: fn(*args, **kw), 10)
    plain_ms = cuda_ms(torch, lambda: ref_fn(*args, **kw), 10)
    shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
    phase(f"3 {name}[{label}]", err <= tol,
          f"shapes {shapes[:2]} max_abs_err {err:.3e} (tol {tol:.3g}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return {"call": label, "shapes": shapes[:2], "max_abs_err": err,
            "tol": tol, "ms": ms, "plain_ms": plain_ms}


def run_path(torch, kernels, corpus, label, opt, sopt, data, pins, need):
    """Drive batched_pipeline once with the launch counters zeroed just
    before and read just after; check the kernels in `need` launched, the
    output, and the SNR pins; then the step time (median of 5) and peak
    memory.  -> the launch counts."""
    x, f0, x_ref, nxv = data
    B = x.shape[0]
    n_noisy = B // 2                 # noisy rows first, then clean
    kernels.reset_launches()
    y, snr, _ = corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase(f"{label} launches", all(launches[k] > 0 for k in need),
          str(launches))
    phase(f"{label} output", tuple(y.shape) == tuple(x.shape)
          and bool(torch.isfinite(y).all()), f"y {tuple(y.shape)} finite")
    snr = snr.cpu().tolist()
    clean = statistics.fmean(snr[n_noisy:])
    phase(f"{label} clean snr", clean >= CLEAN_MIN_DB,
          f"mean {clean:.4f} dB over {B - n_noisy} clean rows "
          f"(min {min(snr[n_noisy:]):.4f}; pin >= {CLEAN_MIN_DB})")
    for row, pin in pins.items():
        phase(f"{label} noisy snr row {row}",
              abs(snr[row] - pin) <= NOISY_TOL_DB,
              f"{snr[row]:.4f} dB (pin {pin} +- {NOISY_TOL_DB})")
    print(f"{label}: noisy rows mean snr {statistics.fmean(snr[:n_noisy]):.4f}"
          f" dB over {n_noisy} rows", flush=True)
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    step = statistics.median(steps)
    phase(f"{label} step", True,
          f"{B} x {DURATION} s: median {step * 1e3:.2f} ms of "
          f"{[round(t * 1e3, 2) for t in steps]} ms; "
          f"{B * DURATION / step:.1f} audio-sec/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _utterance(i):
    from libllsm2_tpu_torch.utils import testsig
    return testsig.make_test_utterance(
        duration=DURATION, seed=i, noise_level=0.05 if i < N_NOISY else 0.0,
        return_parts=True)


def fixtures(torch, dev):
    """The bench fixtures: rows [0, N_NOISY) noisy, the rest clean; made
    in worker processes (numpy, float64), which all exit before return."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, multiprocessing.get_context("spawn")) \
            as pool:
        rows = list(pool.map(_utterance, range(BATCH)))
    x, f0, x_ref = (torch.tensor(np.stack([r[j] for r in rows]),
                                 dtype=torch.float32, device=dev)
                    for j in range(3))
    nxv = torch.full((BATCH,), x.shape[1], dtype=torch.int64, device=dev)
    return x, f0, x_ref, nxv


def capture_kernel_inputs(kernels, run):
    """Run `run()` with every kernel wrapper recording its arguments."""
    calls = {name: [] for name in KERNELS}
    originals = {name: getattr(kernels, name) for name in KERNELS}

    def hook(name):
        def wrapped(*args, **kw):
            calls[name].append((args, kw))
            return originals[name](*args, **kw)
        return wrapped

    for name in KERNELS:
        setattr(kernels, name, hook(name))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    return calls


def main():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "libllsm2_tpu_torch" / "__init__.py").exists():
        print(f"FAIL: no libllsm2_tpu_torch package beside {__file__}",
              flush=True)
        return 1
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card, flush=True)
    phase("1 device", bool(card), f"{torch.cuda.get_device_name(0)}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.ops import _build, kernels
    from libllsm2_tpu_torch.parallel import corpus

    t0 = time.perf_counter()
    _build.library()
    phase("2 build", True, f"{time.perf_counter() - t0:.1f} s "
          "(nvcc sm_90a, ctypes)")

    opt_off = dataclasses.replace(create_aoptions(f0_floor=70.0),
                                  track_denoise=False, use_pallas=True)
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)   # library default
    assert opt.track_denoise and opt.track_denoise_spectral \
        and opt.track_spectral_decimate == 4
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    t0 = time.perf_counter()
    data = fixtures(torch, dev)
    print(f"fixtures: {BATCH} x {DURATION} s in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 3: every kernel against its plain version on main-path inputs
    calls = capture_kernel_inputs(kernels, lambda: corpus.batched_pipeline(
        opt, sopt, *(d[:2] for d in data[:2]), data[3][:2], data[2][:2]))
    summary = {}
    for name, (source, replaces, tol) in KERNELS.items():
        if not calls[name]:
            phase(f"3 {name}", False, "not called on the main path")
        cases = []
        for i, (args, kw) in enumerate(calls[name]):
            cases.append(check_kernel(torch, kernels, name, tol, args, kw,
                                      str(i)))
            for label, v_args, v_kw in variants(torch, name, args, kw):
                cases.append(check_kernel(torch, kernels, name, tol, v_args,
                                          v_kw, label))
        summary[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "max_abs_err": max(c["max_abs_err"] for c in cases),
                         "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
                         "cases": cases}
    del calls

    # phase 4: the denoiser-off path on 32 rows
    rows = torch.tensor(OFF_ROWS, device=dev)
    run_path(torch, kernels, corpus, "4 denoiser off", opt_off, sopt,
             tuple(d[rows] for d in data), NOISY_PINS_DB["denoiser off"],
             ("osc_bank", "harmonic_project_win", "deconv_full",
              "noise_mod_ola"))
    # phase 5: the main path, the library default, on all 128 rows
    launches = run_path(torch, kernels, corpus, "5 library default", opt,
                        sopt, data, NOISY_PINS_DB["library default"],
                        tuple(KERNELS))
    for name in KERNELS:
        summary[name]["launches"] = launches[name]
    print(card, flush=True)

    print(json.dumps({"kernels": list(summary.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke did not complete", flush=True)
        rc = 1
    sys.exit(rc)
