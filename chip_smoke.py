#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libllsm2_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero without the final
"ok" line:
  1. device: a CUDA card must be present; prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles the port's CUDA kernels from libllsm2_tpu_torch/csrc.
  3. kernels: captures every kernel's inputs on the first 2 rows of the
     path that runs it -- the six of the library-default path (denoiser
     on; K = 80, Wf = 960, plus the envelope projection), the unframed
     projection of phase 6's hm_kernel="matmul", the plain projection of
     phase 7's refine probes (K = 1) and of one harmonic_analysis with the
     mltsine window (K = 80) -- runs kernel and plain PyTorch version on
     them on the card, checks the maximum error against each tolerance,
     and times both (median of 10, CUDA events).  The denoiser kernels'
     other variants (apply without emit_resid, stats from (ampl, phse) =
     (|c|, angle c) of the captured complex track) run on the same inputs.
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
  6. hm_kernel="matmul" at the library default, all 128 rows x 8 s: the
     main harmonic pass through harmonic_project_mxu (launched), the pins
     of phase 5; prints the SNR change from phase 5, then step and peak.
  7. odd hop: create_aoptions(fs=11000, f0_floor=70, use_pallas=True) and
     create_soptions(fs=11000) on 128 rows x 8 s of the bench fixtures
     made at 11 kHz (hop 55: undecimated refine through harmonic_project,
     envelope decimation 1); harmonic_project and the six kernels of
     phase 5 launched; noisy rows 0/1 within 0.2 dB and clean row 64 at
     most 0.1 dB under the JAX package's values.  Then step and peak.
  8. an 11.025 kHz file through the public analyze -> synthesize (input
     resampled to 11000 Hz, output rendered there and resampled back), one
     noisy and one clean 1 s row made at 11025 Hz: output length
     round(nfrm thop fs), finite, y_sin SNR within 0.1 dB of the JAX
     package's.
The line before the last is the kernels' JSON summary (launches from the
phase that runs each: 5 for the six, 6 for harmonic_project_mxu, 7 for
harmonic_project); the last line is {"ok": true, "device": {...}}.  TF32
is off for every float32 matmul.
"""
import dataclasses
import functools
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
# the JAX package's own values at 11 kHz (Pallas kernels in interpret mode
# on the CPU), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py duration=8
# phase 7: batched_pipeline SNR of bench rows 0, 1 (noisy) and 64 (clean)
ODD_HOP_PINS_DB = {0: 38.74501419067383, 1: 38.651763916015625,
                   64: 54.44218826293945}
CLEAN_TOL_DB = 0.1
# phase 8: y_sin SNR of the 1 s rows of seeds 0 (noisy) and 64 (clean)
PUBLIC_11025_PINS_DB = {0: 36.86190946632691, 64: 46.70321121537888}
PUBLIC_TOL_DB = 0.1
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
    "harmonic_project_mxu": ("libllsm2_tpu_torch/csrc/harmonic_project_mxu.cu",
                             "libllsm2_tpu/ops/pallas_osc.py:786", "rel 2e-3"),
    "harmonic_project": ("libllsm2_tpu_torch/csrc/harmonic_project.cu",
                         "libllsm2_tpu/ops/pallas_osc.py:1388", 2e-3),
}
MAIN_SIX = tuple(KERNELS)[:6]     # the library-default path's kernels


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


def track_scale(torch, name, args, kw, ref):
    """Largest |track| among a denoiser call's inputs; for the unframed
    projection, the largest |re + j im| of the plain version's output."""
    if name == "harmonic_project_mxu":
        return float(torch.max(torch.hypot(ref[0], ref[1])))
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
    if name == "harmonic_project_mxu":
        # wsum and xsum count relative to their own peak, in track units
        rel = lambda g, r: float(torch.max(torch.abs(g - r))
                                 / torch.clamp(torch.max(torch.abs(r)),
                                               min=1e-30))
        return max(cplx(got, ref), scale * rel(got[2], ref[2]),
                   scale * rel(got[3], ref[3]))
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
        scale = track_scale(torch, name, args, kw, ref)
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


def run_path(torch, kernels, corpus, label, opt, sopt, data, pins, need,
             clean_min=CLEAN_MIN_DB):
    """Drive batched_pipeline once with the launch counters zeroed just
    before and read just after; check the kernels in `need` launched, the
    output and the SNR pins (noisy rows within NOISY_TOL_DB of theirs,
    clean rows at most CLEAN_TOL_DB under theirs, the clean mean >=
    clean_min unless None); then the step time (median of 5) and peak
    memory.  -> (the launch counts, the per-row SNRs)."""
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
    phase(f"{label} clean snr", clean_min is None or clean >= clean_min,
          f"mean {clean:.4f} dB over {B - n_noisy} clean rows "
          f"(min {min(snr[n_noisy:]):.4f}; pin >= {clean_min})")
    for row, pin in pins.items():
        if row < n_noisy:
            phase(f"{label} noisy snr row {row}",
                  abs(snr[row] - pin) <= NOISY_TOL_DB,
                  f"{snr[row]:.4f} dB (pin {pin} +- {NOISY_TOL_DB})")
        else:
            phase(f"{label} clean snr row {row}",
                  snr[row] >= pin - CLEAN_TOL_DB,
                  f"{snr[row]:.4f} dB (pin {pin} - {CLEAN_TOL_DB})")
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
    return launches, snr


def _utterance(i, fs=16000.0):
    from libllsm2_tpu_torch.utils import testsig
    return testsig.make_test_utterance(
        duration=DURATION, fs=fs, seed=i,
        noise_level=0.05 if i < N_NOISY else 0.0, return_parts=True)


def fixtures(torch, dev, fs=16000.0):
    """The bench fixtures at rate fs: rows [0, N_NOISY) noisy, the rest
    clean; made in worker processes (numpy, float64), which all exit
    before return."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    workers = max(1, min(8, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, multiprocessing.get_context("spawn")) \
            as pool:
        rows = list(pool.map(functools.partial(_utterance, fs=fs),
                             range(BATCH)))
    x, f0, x_ref = (torch.tensor(np.stack([r[j] for r in rows]),
                                 dtype=torch.float32, device=dev)
                    for j in range(3))
    nxv = torch.full((BATCH,), x.shape[1], dtype=torch.int64, device=dev)
    return x, f0, x_ref, nxv


def capture_kernel_inputs(kernels, names, run):
    """Run `run()` with the wrappers of `names` recording their
    arguments."""
    calls = {name: [] for name in names}
    originals = {name: getattr(kernels, name) for name in names}

    def hook(name):
        def wrapped(*args, **kw):
            calls[name].append((args, kw))
            return originals[name](*args, **kw)
        return wrapped

    for name in names:
        setattr(kernels, name, hook(name))
    try:
        run()
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    return calls


def snr_db(torch, ref, y, fs, f0_floor):
    """Phase 8's SNR (scripts/port_jax_pins.py's): y against ref over the
    common length, minus an OLA margin of min(2 fs / f0_floor, n / 4) at
    both ends, in float64."""
    n = min(ref.shape[-1], y.shape[-1])
    m = min(int(2.0 * fs / f0_floor), n // 4)
    ref = ref[m:n - m].double()
    err = ref - y[m:n - m].double()
    return float(10.0 * torch.log10(torch.sum(ref ** 2)
                                    / torch.clamp(torch.sum(err ** 2),
                                                  min=1e-12)))


def public_11025(torch, kernels, lt, dev):
    """Phase 8: one noisy and one clean 1 s row made at 11025 Hz through
    the public analyze -> synthesize."""
    from libllsm2_tpu_torch.utils import testsig
    fs = 11025.0
    opt = lt.create_aoptions(fs=fs, f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(lt.create_soptions(fs=fs), use_pallas=True)
    kernels.reset_launches()
    for seed, pin in PUBLIC_11025_PINS_DB.items():
        x, f0, x_ref = (torch.tensor(v, dtype=torch.float32, device=dev)
                        for v in testsig.make_test_utterance(
                            duration=1.0, fs=fs, seed=seed,
                            noise_level=0.05 if seed < N_NOISY else 0.0,
                            return_parts=True))
        chunk = lt.analyze(opt, x, f0)
        out = lt.synthesize(sopt, chunk)
        torch.cuda.synchronize()
        ny = int(round(chunk.nfrm * opt.conf.thop * fs))
        phase(f"8 public 11025 Hz seed {seed} output",
              all(tuple(v.shape) == (ny,) and bool(torch.isfinite(v).all())
                  for v in out[:3]),
              f"y, y_sin, y_nos {tuple(out.y.shape)} finite (expected "
              f"({ny},) = round(nfrm thop fs)); analysis at "
              f"{opt.conf.fs} Hz, hop {opt.conf.nhop}")
        snr = snr_db(torch, x_ref, out.y_sin, fs, opt.conf.f0_floor)
        phase(f"8 public 11025 Hz seed {seed} snr",
              abs(snr - pin) <= PUBLIC_TOL_DB,
              f"{snr:.4f} dB (JAX {pin:.4f} +- {PUBLIC_TOL_DB})")
    launches = dict(kernels.LAUNCHES)
    phase("8 launches", launches["harmonic_project"] > 0, str(launches))


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

    import libllsm2_tpu_torch as lt
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.ops import _build, harmonics, kernels
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
    opt_mxu = dataclasses.replace(opt, hm_kernel="matmul")
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    opt11 = create_aoptions(fs=11000.0, f0_floor=70.0, use_pallas=True)
    sopt11 = dataclasses.replace(create_soptions(fs=11000.0), use_pallas=True)
    assert opt11.conf.nhop == 55 and not opt11.fs_input
    t0 = time.perf_counter()
    data = fixtures(torch, dev)
    data11 = fixtures(torch, dev, fs=11000.0)
    print(f"fixtures: {BATCH} x {DURATION} s at 16 and 11 kHz in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # phase 3: every kernel against its plain version on the inputs of
    # the path that runs it, 2 rows
    two = lambda d: (d[0][:2], d[1][:2], d[3][:2], d[2][:2])
    conf = opt.conf

    def mltsine():
        x, f0 = data[0][:2], data[1][:2]
        cyc = harmonics.sample_cycles(f0, conf.nhop, conf.fs, x.shape[-1])
        harmonics.harmonic_analysis(
            x, f0, cyc, nhop=conf.nhop, fs=conf.fs, max_k=conf.maxnhar,
            halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
            fnyq=conf.fnyq, window="mltsine")

    captures = [
        ("", MAIN_SIX, lambda: corpus.batched_pipeline(opt, sopt, *two(data))),
        ("matmul ", ("harmonic_project_mxu",),
         lambda: corpus.batched_pipeline(opt_mxu, sopt, *two(data))),
        ("refine K=1 ", ("harmonic_project",),
         lambda: corpus.batched_pipeline(opt11, sopt11, *two(data11))),
        ("mltsine K=80 ", ("harmonic_project",), mltsine),
    ]
    cases = {name: [] for name in KERNELS}
    for prefix, names, run in captures:
        calls = capture_kernel_inputs(kernels, names, run)
        for name in names:
            tol = KERNELS[name][2]
            if not calls[name]:
                phase(f"3 {name}", False,
                      f"not called by {prefix or 'the main path'}")
            for i, (args, kw) in enumerate(calls[name]):
                cases[name].append(check_kernel(torch, kernels, name, tol,
                                                args, kw, f"{prefix}{i}"))
                for label, v_args, v_kw in variants(torch, name, args, kw):
                    cases[name].append(check_kernel(torch, kernels, name, tol,
                                                    v_args, v_kw, label))
        del calls
    summary = {name: {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces,
                      "max_abs_err": max(c["max_abs_err"]
                                         for c in cases[name]),
                      "ms": cases[name][0]["ms"],
                      "plain_ms": cases[name][0]["plain_ms"],
                      "cases": cases[name]}
               for name, (source, replaces, _) in KERNELS.items()}

    # phase 4: the denoiser-off path on 32 rows
    rows = torch.tensor(OFF_ROWS, device=dev)
    run_path(torch, kernels, corpus, "4 denoiser off", opt_off, sopt,
             tuple(d[rows] for d in data), NOISY_PINS_DB["denoiser off"],
             ("osc_bank", "harmonic_project_win", "deconv_full",
              "noise_mod_ola"))
    # phase 5: the main path, the library default, on all 128 rows
    launches, snr5 = run_path(torch, kernels, corpus, "5 library default",
                              opt, sopt, data,
                              NOISY_PINS_DB["library default"], MAIN_SIX)
    for name in MAIN_SIX:
        summary[name]["launches"] = launches[name]
    # phase 6: hm_kernel="matmul" at the library default, all 128 rows
    launches, snr6 = run_path(torch, kernels, corpus, "6 matmul", opt_mxu,
                              sopt, data, NOISY_PINS_DB["library default"],
                              ("harmonic_project_mxu",) + MAIN_SIX)
    summary["harmonic_project_mxu"]["launches"] = \
        launches["harmonic_project_mxu"]
    diff = [a - b for a, b in zip(snr6, snr5)]
    print(f"6 matmul: snr - phase 5 snr: max |diff| "
          f"{max(map(abs, diff)):.4f} dB, noisy rows 0/1 {diff[0]:+.4f} / "
          f"{diff[1]:+.4f} dB, clean mean "
          f"{statistics.fmean(diff[BATCH // 2:]):+.4f} dB", flush=True)
    # phase 7: odd hop at 11 kHz, all 128 rows
    del data
    launches, _ = run_path(torch, kernels, corpus, "7 odd hop", opt11, sopt11,
                           data11, ODD_HOP_PINS_DB,
                           ("harmonic_project",) + MAIN_SIX, clean_min=None)
    summary["harmonic_project"]["launches"] = launches["harmonic_project"]
    del data11
    # phase 8: an 11.025 kHz file through the public API
    public_11025(torch, kernels, lt, dev)
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
