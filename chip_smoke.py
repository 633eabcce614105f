#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libllsm2_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero without the final
"ok" line:
  1. device: a CUDA card must be present; prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles the port's CUDA kernels from libllsm2_tpu_torch/csrc.
  3. kernels: captures every kernel's inputs on the main path of the first
     2 bench rows (K = 80, Wf = 960, plus the envelope projection), runs
     kernel and plain PyTorch version on them on the card, checks the
     maximum error against each tolerance, and times both (median of 10,
     CUDA events).
  4. main path: batched_pipeline on the bench fixtures (128 rows x 8 s,
     ChunkConf(f0_floor=70), track_denoise=False, use_pallas=True) after
     zeroing the launch counters; every kernel must have launched, the
     clean rows must reach 55.17 dB, noisy rows 0 and 1 must lie within
     0.2 dB of 32.69 and 33.14 dB.  Then the step time (median of 5).
The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.  TF32 is off for every float32 matmul.
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
CLEAN_MIN_DB = 55.17                      # JAX Pallas-branch reference: 55.27
NOISY_PINS_DB = {0: 32.69, 1: 33.14}      # JAX Pallas-branch reference
NOISY_TOL_DB = 0.2
# kernel -> (source, TPU kernel it replaces, tolerance on max |error|)
KERNELS = {
    "harmonic_project_win": ("libllsm2_tpu_torch/csrc/harmonic_project_win.cu",
                             "libllsm2_tpu/ops/pallas_osc.py:254", 2e-3),
    "deconv_full": ("libllsm2_tpu_torch/csrc/deconv_full.cu",
                    "libllsm2_tpu/ops/pallas_osc.py:639", 5e-4),
    "osc_bank": ("libllsm2_tpu_torch/csrc/osc_bank.cu",
                 "libllsm2_tpu/ops/pallas_osc.py:112", 2e-4),
    "noise_mod_ola": ("libllsm2_tpu_torch/csrc/noise_mod_ola.cu",
                      "libllsm2_tpu/ops/pallas_osc.py:457", 5e-5),
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


def max_err(torch, name, got, ref):
    if name == "deconv_full":          # complex tracks: |delta re + j delta im|
        return float(torch.max(torch.hypot(got[0] - ref[0],
                                           got[1] - ref[1])))
    got = (got,) if torch.is_tensor(got) else got
    ref = (ref,) if torch.is_tensor(ref) else ref
    return max(float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref))


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

    from libllsm2_tpu_torch import create_aoptions, create_soptions, ChunkConf
    from libllsm2_tpu_torch.ops import _build, kernels
    from libllsm2_tpu_torch.parallel import corpus

    t0 = time.perf_counter()
    _build.library()
    phase("2 build", True, f"{time.perf_counter() - t0:.1f} s "
          "(nvcc sm_90a, ctypes)")

    opt = dataclasses.replace(create_aoptions(), conf=ChunkConf(f0_floor=70.0),
                              track_denoise=False, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    t0 = time.perf_counter()
    x, f0, x_ref, nxv = fixtures(torch, dev)
    print(f"fixtures: {BATCH} x {DURATION} s in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 3: every kernel against its plain version on main-path inputs
    calls = capture_kernel_inputs(kernels, lambda: corpus.batched_pipeline(
        opt, sopt, x[:2], f0[:2], nxv[:2], x_ref[:2]))
    summary = {}
    for name, (source, replaces, tol) in KERNELS.items():
        if not calls[name]:
            phase(f"3 {name}", False, "not called on the main path")
        cases = []
        for i, (args, kw) in enumerate(calls[name]):
            fn = getattr(kernels, name)
            ref_fn = getattr(kernels, name + "_ref")
            got, ref = fn(*args, **kw), ref_fn(*args, **kw)
            torch.cuda.synchronize()
            err = max_err(torch, name, got, ref)
            ms = cuda_ms(torch, lambda: fn(*args, **kw), 10)
            plain_ms = cuda_ms(torch, lambda: ref_fn(*args, **kw), 10)
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            cases.append({"call": i, "shapes": shapes[:2], "max_abs_err": err,
                          "ms": ms, "plain_ms": plain_ms})
            phase(f"3 {name}[{i}]", err <= tol,
                  f"shapes {shapes[:2]} max_abs_err {err:.3e} (tol {tol:g}) "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        summary[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces,
                         "max_abs_err": max(c["max_abs_err"] for c in cases),
                         "ms": cases[0]["ms"], "plain_ms": cases[0]["plain_ms"],
                         "cases": cases}
    del calls

    # phase 4: the main path through the kernels
    kernels.reset_launches()
    y, snr, _ = corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    for name in KERNELS:
        summary[name]["launches"] = launches[name]
    phase("4 launches", all(v > 0 for v in launches.values()), str(launches))
    phase("4 output", tuple(y.shape) == tuple(x.shape)
          and bool(torch.isfinite(y).all()), f"y {tuple(y.shape)} finite")
    snr = snr.cpu().tolist()
    clean = statistics.fmean(snr[N_NOISY:])
    noisy = statistics.fmean(snr[:N_NOISY])
    phase("4 clean snr", clean >= CLEAN_MIN_DB,
          f"mean {clean:.4f} dB over rows {N_NOISY}..{BATCH - 1} "
          f"(min {min(snr[N_NOISY:]):.4f}; pin >= {CLEAN_MIN_DB})")
    for row, pin in NOISY_PINS_DB.items():
        phase(f"4 noisy snr row {row}", abs(snr[row] - pin) <= NOISY_TOL_DB,
              f"{snr[row]:.4f} dB (pin {pin} +- {NOISY_TOL_DB})")
    print(f"noisy rows mean snr: {noisy:.4f} dB", flush=True)

    torch.cuda.reset_peak_memory_stats()
    steps = []
    for _ in range(5):
        t0 = time.perf_counter()
        corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    step = statistics.median(steps)
    phase("4 step", True,
          f"median {step * 1e3:.2f} ms of {[round(s * 1e3, 2) for s in steps]} "
          f"ms; {BATCH * DURATION / step:.1f} audio-sec/s; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")

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
