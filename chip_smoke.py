#!/usr/bin/env python3
"""Smoke run of the PyTorch port (libllsm2_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py breakdown DIR

The second form runs only phase 5's breakdown (the harmonic_analysis
calls, the harmonic renders, the analysis / synthesis times and peaks and
each analysis stage's time and peak) on the
libllsm2_tpu_torch package in DIR, another checkout such as the parent
commit's, so that two versions compare on one card; it prints no result
line.  The first form's phases, one line each; any failure exits
non-zero without the final "ok" line:
  1. device: a CUDA card must be present; prints the card's name and
     power limit (nvidia-smi).
  2. build: compiles the port's CUDA kernels from libllsm2_tpu_torch/csrc
     and prints each kernel's registers, spills and static shared memory
     from the ptxas report.
  3. kernels: captures every kernel's inputs on the first 2 rows of the
     path that runs it -- the six of the library-default path (denoiser
     on; K = 80, Wf = 960, plus the K = 4 envelope projection; osc_bank's
     residual and synthesis renders), its frame-axis FIR pair (the
     spectral gate's local-noisiness blend, one launch) and its noise draw
     (noise_bins, held to its twin's bits exactly and its normals within
     1e-6), the track lowpass's FIR pair (track_lowpass_hz=30: a
     voicing column and a complex track), env_render on the envelope
     coefficients of the main path's noise_mod_ola call, the unframed
     projection of phase 6's hm_kernel="matmul", the plain projection of
     phase 7's refine probes (K = 1) and of one harmonic_analysis with the
     mltsine window (K = 80) -- runs kernel and plain PyTorch version on them on the card, checks
     the maximum error against each tolerance, and times both (median of
     10, CUDA events) and, where PyTorch computes the same function in
     one contraction or convolution, that call with the making of its
     operands from the same inputs (the dense oscillator / chirp basis,
     the banded windows, the FIR's layout) timed with it.  The denoiser
     kernels' other variants (apply without emit_resid, stats from (ampl,
     phse) = (|c|, angle c) of the captured complex track) run on the
     same inputs.
  4. denoiser off: batched_pipeline on 32 bench rows (16 noisy, 16 clean;
     ChunkConf(f0_floor=70), track_denoise=False, use_pallas=True) after
     zeroing the launch counters; its four kernels and the noise draw must
     have launched, the clean rows must reach 55.17 dB, noisy rows 0 and 1
     must lie within 0.05 dB of the JAX package's values.  Then the step
     time (median of 5).
  5. main path, the library default (create_aoptions(f0_floor=70,
     use_pallas=True): denoiser on, spectral gate at decimation 4) on all
     128 rows x 8 s after zeroing the launch counters: all six kernels,
     fir_frames and noise_bins must have launched, clean rows >= 55.17 dB,
     noisy rows 0 and 1 within 0.05 dB and clean row 64 at most 0.1 dB
     under the JAX package's values.  Then the step time (median of 5) and peak
     memory, each of the step's two harmonic_analysis calls (the K = 80
     main pass, the K = 4 envelope pass) and its two harmonic renders (the
     residual and the synthesis: one osc_bank launch each) at full batch,
     framing, window and glue included (median of 10), the analysis and
     the synthesis apart: time (median of 3) and the peak memory each
     takes above its inputs, and each analysis stage's synchronized time
     and peak.
  6. hm_kernel="matmul" at the library default, all 128 rows x 8 s: the
     main harmonic pass through harmonic_project_mxu (launched), the pins
     of phase 5; prints the SNR change from phase 5, then step and peak.
  7. odd hop: create_aoptions(fs=11000, f0_floor=70, use_pallas=True) and
     create_soptions(fs=11000) on 128 rows x 8 s of the bench fixtures
     made at 11 kHz (hop 55: undecimated refine through harmonic_project,
     envelope decimation 1); harmonic_project and the six kernels of
     phase 5 launched; noisy rows 0/1 within 0.2 dB and clean row 64 at
     most 0.1 dB under the JAX package's values.  Then step and peak.
  8. an 11.025 kHz file through the public analyze -> synthesize (numpy
     input, on the card by default; resampled to 11000 Hz, output
     rendered there and resampled back), one noisy and one clean 1 s row
     made at 11025 Hz: output length round(nfrm thop fs), finite, y_sin
     SNR within 0.1 dB of the JAX package's.
  9. layer-1 round trip on the 128 x 8 s bench rows: the library-default
     analysis, then chunk_to_layer1 -> chunk_to_layer0 -> _synthesize,
     counters zeroed before; the seven kernels of phase 5 launched; y_sin
     SNR against the clean harmonic part: noisy rows 0/1 within 0.2 dB of
     the JAX package's values, every clean row at most 0.1 dB under the
     JAX value of row 64.  Prints each stage's ms, the audio-sec/s of the
     layer-1 round trip and the peak.  Then env_render, which no library
     path runs, renders this chunk's envelopes at full batch through
     layer0._render_envelopes(use_pallas=True), counters zeroed before.
 10. pulse-by-pulse synthesis: 128 rows x 8 s of synth_lf_speech (Rd 0.4 /
     1.0 / 1.8 / 2.7 by row, make_f0_track's contour, aspiration seed =
     row), the library-default analysis -> chunk_to_layer1 ->
     pbp_synthesize, counters zeroed before: noise_mod_ola and fir_frames
     launched; each row's median voiced rd within 15% of its truth (the
     JAX suite's criterion) and rows 0 and 1 within 1% of the JAX
     package's medians; row 0's rd track, frame by frame, within 1e-3
     relative of chunk_to_layer1 on the CPU from the same layer-0 row;
     rows 0 and 1: the SNR of PbP y_sin against the layer-1 sinusoidal
     y_sin within 0.2 dB of the JAX package's.  Prints the PbP ms,
     audio-sec/s and peak.
Phases 5, 6, 7 and 9 also time every call of each of their kernels in
the counted run at full batch (median of 10, and a launch's share of a
run of 20 back-to-back launches: the device time where the host enqueues
faster than the card runs), beside its bound, and fir_frames beside its
conv1d yardstick.  The line before the last is
the kernels' JSON summary: launches from the phase that runs each (5 for
the six and fir_frames, 6 for harmonic_project_mxu, 7 for
harmonic_project, 9 for env_render); ms, plain_ms, library_ms and
bound_ms at the first 2-row call of phase 3; "full_batch" a record per
call at full batch ("analysis_calls" on harmonic_project_win and
"render_calls" on osc_bank: phase 5's two harmonic_analysis calls and two
renders).  bound_ms is the larger of the bytes the
call must move (inputs read once, outputs written once; of the
pre-windowed frames of harmonic_project only the live columns) over 3.35
TB/s and its operations: float32 ones over 67 TFLOP/s (the H100 SXM data
sheet), the noise draw's integer ones over the 16.75 TOP/s of the SM's
INT32 lanes (a quarter of the float32 rate).
The last line is {"ok": true, "device": {...}}.  TF32 is off for every
float32 matmul and convolution.

The SNR, rd and PbP pins are the JAX package's own values on the CPU, from

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py \
        [only=l0,11k,l1,pbp]

(l0: phases 4 and 5; 11k: phases 7 and 8; l1: phase 9; pbp: phase 10).
"""
import dataclasses
import json
import re
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
# phases 4-6: the card sits 0.017-0.022 dB above the JAX package on noisy
# rows 0/1 with the denoiser on, from float32 rounding in the analysis front
# end that the denoiser's gates amplify (scripts/port_card_vs_cpu.py,
# scripts/port_l0_parity.py; PERF.md section 7), within 2e-4 dB with it off
L0_NOISY_TOL_DB = 0.05
# the JAX package's own values at 16 kHz on the CPU, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=l0
# phases 4 and 5: batched_pipeline SNR of bench rows 0, 1 (noisy), and 64
# (clean) with the library default
NOISY_PINS_DB = {"denoiser off": {0: 32.69486618041992, 1: 33.14051818847656},
                 "library default": {0: 40.05961608886719,
                                     1: 40.60990905761719,
                                     64: 55.269065856933594}}
# the JAX package's own values at 11 kHz (Pallas kernels in interpret mode
# on the CPU), from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=11k
# phase 7: batched_pipeline SNR of bench rows 0, 1 (noisy) and 64 (clean)
ODD_HOP_PINS_DB = {0: 38.74501419067383, 1: 38.651763916015625,
                   64: 54.44218826293945}
CLEAN_TOL_DB = 0.1
# phase 8: y_sin SNR of the 1 s rows of seeds 0 (noisy) and 64 (clean)
PUBLIC_11025_PINS_DB = {0: 36.86190946632691, 64: 46.70321121537888}
PUBLIC_TOL_DB = 0.1
# the JAX package's own values at 16 kHz on the CPU, from
#   JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_jax_pins.py only=l1
# phase 9: layer-1 round-trip y_sin SNR of bench rows 0, 1 (noisy), 64 (clean)
LAYER1_PINS_DB = {0: 40.059172572920154, 1: 40.609634863972815,
                  64: 55.24957249760942}
# phase 10: SNR of PbP y_sin against the layer-1 sinusoidal y_sin, LF rows
# 0 and 1 (PbP renders the LF x minimum-phase pulse and drops the measured
# phase residual vsphse, so the two waveforms are near-uncorrelated: a
# regression pin, not a quality figure)
PBP_PINS_DB = {0: 2.5078524906236277, 1: -3.4844267509230527}
# phase 10: median voiced rd of LF rows 0 and 1 after the library-default
# analysis and chunk_to_layer1 (Rd 0.4 and 1.0; the same script)
RD_PINS = {0: 0.41814684867858887, 1: 0.9919065237045288}
RD_PIN_REL_TOL = 0.01
RD_CPU_REL_TOL = 1e-3                     # phase 10: card rd against the CPU
LF_RD = (0.4, 1.0, 1.8, 2.7)              # phase 10: true Rd of row i % 4
RD_REL_TOL = 0.15                         # tests/test_layer1.py's criterion
# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
# (128 lanes an SM, an FMA counted as two); the SM's 64 INT32 lanes issue a
# quarter of that in integer operations
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
INT32_OPS_PER_S = FP32_OPS_PER_S / 4
# kernel -> (source, TPU kernel it replaces, tolerance on max |error|); a
# string tolerance "rel x" is x times the largest |track| of the call's
# inputs (the denoiser's: test_pallas.py's 2e-3 x scale); a tuple is one
# absolute tolerance per output
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
    "fir_frames": ("libllsm2_tpu_torch/csrc/fir_frames.cu",
                   "libllsm2_tpu/ops/pallas_osc.py:1315", "rel 1e-6"),
    "env_render": ("libllsm2_tpu_torch/csrc/env_render.cu",
                   "libllsm2_tpu/ops/pallas_osc.py:360", (2e-5, 2e-6)),
    # not a Pallas kernel: the port's counterpart of the jax.random draw
    # that XLA makes itself (fold_in / split / normal); the bits must be
    # equal, the normals within the tolerance
    "noise_bins": ("libllsm2_tpu_torch/csrc/noise_bins.cu",
                   "libllsm2_tpu/models/layer0.py:1163", 1e-6),
}
MAIN_SIX = tuple(KERNELS)[:6]     # the library-default path's CUDA kernels
# ... and its frame-axis FIR and noise draw
MAIN = MAIN_SIX + ("fir_frames", "noise_bins")


class PhaseError(Exception):
    pass


def phase(name, ok, detail):
    print(f"phase {name}: {'ok' if ok else 'FAIL'} {detail}", flush=True)
    if not ok:
        raise PhaseError(f"{name}: {detail}")


def kernel_label(mangled):
    """'..._23proj_win_kernelILi16ELi5ELb0EEEv...' -> 'proj_win_kernel<16,5,0>'."""
    m = re.search(r"\d+([a-z_]+_kernel)(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


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
    if name == "fir_frames":
        return max(float(torch.max(torch.abs(v)))
                   for v in _tensors(torch, args[:1]))
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
    if name == "noise_bins":                 # (re, im, bits_re, bits_im)
        if not (torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])):
            return float("inf")
        got, ref = got[:2], ref[:2]
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


def _tensors(torch, ts):
    """The tensors of ts, tuples and lists flattened."""
    for t in ts:
        if torch.is_tensor(t):
            yield t
        elif isinstance(t, (tuple, list)):
            yield from _tensors(torch, t)


def _nbytes(torch, ts):
    return sum(t.numel() * t.element_size() for t in _tensors(torch, ts))


def _shapes(torch, args):
    return [tuple(t.shape) for t in _tensors(torch, args)]


def kernel_ops(torch, name, args, kw):
    """float32 operations one call needs on these inputs (a complex
    rotate-and-accumulate step counts 10; the denoiser's per-slot fit ~40),
    counting only live harmonics and columns where the inputs say so."""
    a = args
    if name == "osc_bank":                   # cyc, ampl, phse, mask, nhop
        # a sample of hop block i sums frames i and i + 1 (the last block
        # frame N - 1 alone): one rotation z^{k+1} a harmonic serves both (a
        # complex product, 6), each frame's live harmonic adds 2 FMAs (4)
        K = a[3].shape[-1]
        kslots = torch.arange(1, K + 1, device=a[3].device)
        kl = torch.amax(kslots * (a[3] > 0), dim=-1).double()  # live + 1
        kn = torch.nn.functional.pad(kl[..., 1:], (0, 1))
        return a[4] * float((6.0 * torch.maximum(kl, kn)
                             + 4.0 * (kl + kn)).sum())
    if name == "noise_bins":                 # seed, frame_base, B, N, nbin
        return 2 * 40.0 * a[3] * a[4]        # two normals of ~40 a bin
    if name in ("harmonic_project_win", "harmonic_project"):
        R, W = a[0].shape
        K = a[3] if name == "harmonic_project_win" else a[2]
        lo, hi = ((a[4], a[5]) if name == "harmonic_project_win"
                  else (a[3] if len(a) > 3 else None,
                        a[4] if len(a) > 4 else None))
        if lo is None:
            return 10.0 * R * W * K
        kl = kw.get("kl")
        live = kl.float() if kl is not None else float(K)
        return 10.0 * float(((hi - lo).float() * live).sum())
    if name == "harmonic_project_mxu":       # x, cyc, hw, K, nhop, hh
        reach = a[5] * a[4]
        span = torch.clamp(2 * torch.ceil(a[2]) + 1, max=2 * reach + 1)
        return 10.0 * a[3] * float(span.sum())
    if name == "deconv_full":                # ampl [B, N, K], eq [B, N, nq]
        B, N, K = a[0].shape
        band = 2 * a[6] + 1
        return float(B * N) * (24.0 * K * band + 10.0 * band * a[4].shape[-1])
    if name in ("noise_mod_ola", "env_render"):
        B, N, C, Ke = a[2].shape
        return float(a[0].numel()) * C * (16.0 * Ke + 13.0)
    if name == "denoise_stats":
        return float(a[0].numel()) * (4.0 * len(a[5]) + 4.0 * len(a[6]) + 40.0)
    if name == "denoise_apply":
        return float(a[0].numel()) * 40.0
    if name == "fir_frames":
        n = sum(v.numel() * (2 if v.is_complex() else 1)
                for v in _tensors(torch, a[:1]))
        return 2.0 * len(a[1]) * n
    raise KeyError(name)


def kernel_int_ops(name, args):
    """Integer operations one call needs beyond its float32 ones: the noise
    draw's threefry hashes (79 operations: 20 rounds of add, rotate and
    xor, and the key schedule), 3 a frame (fold_in and split) and one a
    normal, two normals a bin, and the 2 a normal that make its uniform;
    0 elsewhere."""
    if name == "noise_bins":                 # seed, frame_base, B, N, nbin
        N, nbin = args[3], args[4]
        return 79.0 * (3 * N + 2 * N * nbin) + 2 * 2.0 * N * nbin
    return 0.0


def kernel_bytes(torch, name, args, kw, out):
    """Bytes one call must move: every input read once (harmonic_project_
    win's x and cyc once a row, not once a frame), every output written
    once; of harmonic_project's pre-windowed [R, W] frames and cycle
    offsets only each row's live columns [lo, hi)."""
    if name == "noise_bins":                 # two [N, nbin] draws, expanded
        return 2 * 4 * args[3] * args[4]
    nbytes = _nbytes(torch, args) + _nbytes(torch, kw.values()) \
        + _nbytes(torch, (out,))
    if name == "harmonic_project" and len(args) > 4:
        lo, hi = args[3], args[4]
        R, W = args[0].shape
        nbytes -= 2 * 4 * (R * W - float((hi - lo).sum()))
    return nbytes


def bound(torch, name, args, kw, out):
    """-> (bound_ms, bound_by): the larger of the bytes the call must move
    (kernel_bytes) over the HBM rate and its operations, float32 ones over
    the float32 rate and integer ones over the INT32 rate, each taken
    alone (the two pipes issue side by side)."""
    nbytes = kernel_bytes(torch, name, args, kw, out)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(kernel_ops(torch, name, args, kw) / FP32_OPS_PER_S,
                kernel_int_ops(name, args) / INT32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_call(torch, name, args, kw):
    """The kernel's function in plain PyTorch around one library
    contraction or convolution, from the same inputs, or None where there
    is none: an einsum against the dense oscillator / chirp basis for the
    oscillator bank and the framed projections, one bmm of banded window
    rows for the unframed projection, conv1d with the fixed taps for
    fir_frames (a pair as one batch).  The making of those operands
    (frames, basis, windows, layout) is part of the returned callable, so
    it is timed with the call."""
    import math
    F = torch.nn.functional
    from libllsm2_tpu_torch.ops.harmonics import win_frames
    from libllsm2_tpu_torch.ops.windows import window_centered
    frac = lambda v: v - torch.round(v)
    if name == "osc_bank":
        from libllsm2_tpu_torch.ops.harmonics import (frame_hops,
                                                      overlap_add_half)
        cyc, ampl, phse, mask, nhop = args[:5]
        x = args[5] if len(args) > 5 else kw.get("x")
        B, N, K = ampl.shape
        T = 2 * nhop
        kh = torch.arange(1, K + 1, device=cyc.device, dtype=cyc.dtype)
        w_ola = 0.5 - 0.5 * torch.cos(2 * math.pi * (torch.arange(
            T, device=cyc.device, dtype=cyc.dtype) + 0.5) / T)

        def call():
            dc = frame_hops(cyc, N, nhop, 1, mode="edge") \
                - cyc[..., ::nhop][..., :N, None]
            osc = torch.cos(2 * math.pi * frac(kh[:, None] * dc[..., None, :])
                            + phse[..., None])
            segs = torch.einsum("bnkt,bnk->bnt", osc, ampl * mask) * w_ola
            y = overlap_add_half(segs, nhop, cyc.shape[-1])
            return y if x is None else x - y
        return call
    if name in ("harmonic_project_win", "harmonic_project"):
        win = name == "harmonic_project_win"
        W = 2 * kw["center"] if win else args[0].shape[1]
        dev = args[0].device
        col = torch.arange(W, device=dev)
        K = args[3] if win else args[2]
        kh = torch.arange(1, K + 1, device=dev, dtype=torch.float32)
        one = torch.ones((), device=dev)

        def call():
            if win:
                x, cyc, hw, _, lo, hi = args
                frames, dc = win_frames(x, cyc, hw.shape[-1], kw["nhop"],
                                        kw["center"])
                xw = frames * window_centered(
                    kw.get("window", "hanning"),
                    (col - kw["center"]).to(dc.dtype)[None],
                    hw.reshape(-1, 1))
            else:
                dc, xw = args[:2]
                lo, hi = (args[3], args[4]) if len(args) > 4 else (0, W)
                lo = torch.as_tensor(lo, device=dev)
                hi = torch.as_tensor(hi, device=dev)
            xw = xw * ((col >= lo.reshape(-1, 1)) & (col < hi.reshape(-1, 1)))
            basis = torch.polar(one, -2 * math.pi * frac(kh[None, :, None]
                                                         * dc[:, None]))
            return torch.einsum("nkw,nw->nk", basis, xw.to(basis.dtype))
        return call
    if name == "harmonic_project_mxu":
        x, cyc, hw, K, nhop, hh = args
        B, nx = x.shape
        N = hw.shape[-1]
        off = (torch.arange(nx, device=x.device)[None, :]
               - torch.arange(N, device=x.device)[:, None] * nhop)
        kh = torch.arange(1, K + 1, device=x.device, dtype=x.dtype)

        def call():
            w = window_centered(kw.get("window", "hanning"),
                                off.to(x.dtype)[None],
                                hw[..., None]) * (off.abs() <= hh * nhop)
            ang = 2 * math.pi * frac(kh * cyc[..., None])
            G = torch.cat([torch.ones_like(x)[..., None], x[..., None],
                           x[..., None] * torch.cos(ang),
                           -x[..., None] * torch.sin(ang)], dim=-1)
            return torch.bmm(w, G)
        return call
    if name == "fir_frames":
        vs, taps = list(_tensors(torch, args[:1])), args[1]
        B, N = vs[0].shape[:2]
        wt = torch.tensor(taps, dtype=torch.float32,
                          device=vs[0].device).reshape(1, 1, -1)
        cols = lambda v: (torch.view_as_real(v) if v.is_complex() else v
                          ).reshape(B, N, -1).permute(0, 2, 1).reshape(-1, N)
        return lambda: F.conv1d(torch.cat([cols(v) for v in vs])[:, None],
                                wt, padding=len(taps) // 2)
    return None


def check_kernel(torch, kernels, name, tol, args, kw, label, library=False):
    """Kernel against its plain version on one call's inputs -> case (with
    the bound and, if library, the one-call PyTorch yardstick's time)."""
    fn = getattr(kernels, name)
    ref_fn = getattr(kernels, name + "_ref")
    # the noise draw is compared on its bits too
    cmp_kw = dict(kw, bits=True) if name == "noise_bins" else kw
    got, ref = fn(*args, **cmp_kw), ref_fn(*args, **cmp_kw)
    torch.cuda.synchronize()
    if isinstance(tol, tuple):                # one tolerance per output
        errs = [float(torch.max(torch.abs(g - r))) for g, r in zip(got, ref)]
        err, ok = max(errs), all(e <= t for e, t in zip(errs, tol))
    else:
        scale = 1.0
        if isinstance(tol, str):
            scale = track_scale(torch, name, args, kw, ref)
            tol = float(tol.split()[1]) * scale
        err = max_err(torch, name, got, ref, scale)
        ok = err <= tol
    ms = cuda_ms(torch, lambda: fn(*args, **kw), 10)
    plain_ms = cuda_ms(torch, lambda: ref_fn(*args, **kw), 10)
    bound_ms, bound_by = bound(torch, name, args, kw, got)
    library_ms = None
    if library:
        call = library_call(torch, name, args, kw)
        if call is not None:
            library_ms = cuda_ms(torch, call, 10)
            del call
            torch.cuda.empty_cache()
    shapes = _shapes(torch, args)
    lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
    phase(f"3 {name}[{label}]", ok,
          f"shapes {shapes[:2]} max_abs_err {err:.3e} (tol {tol}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms library {lib} "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"call": label, "shapes": shapes[:2], "max_abs_err": err,
            "tol": tol, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def full_batch(torch, kernels, calls, label):
    """Every captured call of each kernel at full batch, timed alone
    (median of 10) beside its bound, fir_frames also beside its conv1d
    yardstick (its operands fit at full batch) -> {name: [record per
    call]}."""
    out = {}
    for name in calls:
        fn = getattr(kernels, name)
        out[name] = []
        for i, (args, kw) in enumerate(calls[name]):
            got = fn(*args, **kw)
            ms = cuda_ms(torch, lambda: fn(*args, **kw), 10)
            run = run_ms(torch, lambda: fn(*args, **kw), 20)
            bound_ms, bound_by = bound(torch, name, args, kw, got)
            del got
            library_ms = host_ms = None
            extra = ""
            if name == "fir_frames":
                library_ms = cuda_ms(torch, library_call(torch, name, args,
                                                         kw), 10)
                host_ms = host_call_ms(torch, lambda: fn(*args, **kw), 50)
                extra = (f" (host path {host_ms:.4f} ms a call) library "
                         f"{library_ms:.4f} ms")
            shapes = _shapes(torch, args)
            print(f"full batch {label} {name}[{i}]: shapes {shapes[:2]} "
                  f"kernel {ms:.4f} ms{extra} bound {bound_ms:.4f} ms "
                  f"({bound_by}); {run:.4f} ms a launch in a run of 20",
                  flush=True)
            out[name].append({"phase": label, "call": i,
                              "shapes": shapes[:2], "ms": ms, "run_ms": run,
                              "bound_ms": bound_ms, "bound_by": bound_by,
                              "library_ms": library_ms, "host_ms": host_ms})
    torch.cuda.empty_cache()
    return out


def run_ms(torch, fn, reps):
    """Milliseconds a call of fn in a run of reps back-to-back calls (CUDA
    events around the run, best of 3 runs): the device's time where the
    device, not the host's enqueue, is the slower."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def host_call_ms(torch, fn, reps):
    """Host milliseconds one call of fn takes to return (its enqueue: the
    Python wrapper and the launch, no synchronisation), mean of reps."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def peak_above(torch, fn):
    """-> (fn(), the peak device memory fn takes above what was allocated
    when it started, GiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def analysis_calls(torch, harmonics, run):
    """The harmonic_analysis calls of one run() (phase 5: the K = 80 main
    pass and the K = 4 envelope pass), each timed alone at full batch
    (median of 10), framing, window, projection and glue included, with
    the device memory it takes above what it is given -> [record]."""
    calls, _ = capture_kernel_inputs(harmonics, ("harmonic_analysis",), run)
    out = []
    for i, (args, kw) in enumerate(calls["harmonic_analysis"]):
        call = lambda: harmonics.harmonic_analysis(*args, **kw)
        ms = cuda_ms(torch, call, 10)
        extra = peak_above(torch, call)[1]
        print(f"5 analysis call {i}: harmonic_analysis K {kw['max_k']} on x "
              f"{tuple(args[0].shape)}, cyc {tuple(args[2].shape)}: "
              f"{ms:.4f} ms (framing, window, projection and glue; median "
              f"of 10), {extra:.3f} GiB above its inputs", flush=True)
        out.append({"call": i, "max_k": kw["max_k"],
                    "x": tuple(args[0].shape), "ms": ms, "extra_gib": extra})
    del calls
    torch.cuda.empty_cache()
    return out


def render_hook(harmonics, kernels):
    """(module, name) of the function that renders the harmonic part: the
    one-launch kernels.osc_bank(cyc, ..., nhop, x), or on a package whose
    osc_bank takes frame offsets (the parent's) harmonics.oscillator_bank,
    whose segments overlap_add_half adds."""
    import inspect
    if "nhop" in inspect.signature(kernels.osc_bank).parameters:
        return kernels, "osc_bank"
    return harmonics, "oscillator_bank"


def render_calls(torch, harmonics, kernels, run):
    """The harmonic renders of one run() (phase 5: the analysis residual and
    the synthesis), each timed alone at full batch (median of 10) with the
    device memory it takes above what it is given -> [record].  Each is one
    osc_bank call (one launch); on the parent's package it is
    oscillator_bank + overlap_add_half, and the residual's x - y (cyc
    standing in for x)."""
    mod, name = render_hook(harmonics, kernels)
    new = mod is kernels
    calls, _ = capture_kernel_inputs(mod, (name,), run)
    out = []
    for i, (args, kw) in enumerate(calls[name]):
        resid = (len(args) > 5 and args[5] is not None) if new else i == 0
        if new:
            call = lambda: kernels.osc_bank(*args, **kw)
        else:
            nhop, nx = kw["nhop"], args[0].shape[-1]

            def call():
                y = harmonics.overlap_add_half(
                    harmonics.oscillator_bank(*args, **kw), nhop, nx)
                return args[0] - y if resid else y
        what = "residual" if resid else "synthesis"
        ms = cuda_ms(torch, call, 10)
        extra = peak_above(torch, call)[1]
        print(f"5 render call {i} ({what}): {name} on cyc "
              f"{tuple(args[0].shape)}, K {args[1].shape[-1]}: {ms:.4f} ms "
              f"(framing, coefficients, window and OLA included; median of "
              f"10), {extra:.3f} GiB above its inputs", flush=True)
        out.append({"call": i, "what": what, "fn": name, "ms": ms,
                    "extra_gib": extra})
    del calls
    torch.cuda.empty_cache()
    return out


def run_path(torch, kernels, corpus, label, opt, sopt, data, pins, need,
             timed, clean_min=CLEAN_MIN_DB, noisy_tol=NOISY_TOL_DB):
    """Drive batched_pipeline once with the launch counters zeroed just
    before and read just after, capturing the inputs of the kernels in
    `timed`; check the kernels in `need` launched, the output and the SNR
    pins (noisy rows within noisy_tol of theirs, clean rows at most
    CLEAN_TOL_DB under theirs, the clean mean >= clean_min unless None);
    time each `timed` kernel at full batch on its first call (full_batch);
    then the step time (median of 5) and peak memory.  -> (the launch
    counts, the per-row SNRs, the full-batch records)."""
    x, f0, x_ref, nxv = data
    B = x.shape[0]
    kernels.reset_launches()
    calls, (y, snr, _) = capture_kernel_inputs(
        kernels, timed,
        lambda: corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref))
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase(f"{label} launches", all(launches[k] > 0 for k in need),
          str(launches))
    phase(f"{label} output", tuple(y.shape) == tuple(x.shape)
          and bool(torch.isfinite(y).all()), f"y {tuple(y.shape)} finite")
    snr = snr.cpu().tolist()
    check_snr(label, snr, pins, clean_min, noisy_tol)
    del y
    full = full_batch(torch, kernels, calls, label.split()[0])
    del calls
    torch.cuda.empty_cache()
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
    return launches, snr, full


def check_snr(label, snr, pins, clean_min, noisy_tol=NOISY_TOL_DB):
    """Per-row SNR checks of a bench batch (noisy rows first, then clean):
    the clean mean >= clean_min unless None, noisy pinned rows within
    noisy_tol, clean pinned rows at most CLEAN_TOL_DB under."""
    n_noisy = len(snr) // 2
    clean = statistics.fmean(snr[n_noisy:])
    phase(f"{label} clean snr", clean_min is None or clean >= clean_min,
          f"mean {clean:.4f} dB over {len(snr) - n_noisy} clean rows "
          f"(min {min(snr[n_noisy:]):.4f}; pin >= {clean_min})")
    for row, pin in pins.items():
        if row < n_noisy:
            phase(f"{label} noisy snr row {row}",
                  abs(snr[row] - pin) <= noisy_tol,
                  f"{snr[row]:.4f} dB (pin {pin} +- {noisy_tol})")
        else:
            phase(f"{label} clean snr row {row}",
                  snr[row] >= pin - CLEAN_TOL_DB,
                  f"{snr[row]:.4f} dB (pin {pin} - {CLEAN_TOL_DB})")
    print(f"{label}: noisy rows mean snr {statistics.fmean(snr[:n_noisy]):.4f}"
          f" dB over {n_noisy} rows", flush=True)


def fixtures(torch, dev, fs=16000.0):
    """The bench fixtures at rate fs (bench.py's rows): rows [0, N_NOISY)
    with breath noise 0.05, the rest clean; the harmonic part, which no
    row's seed changes, is synthesized once (numpy, float64)."""
    import numpy as np

    from libllsm2_tpu_torch.utils import testsig
    rows = testsig.make_test_utterances(
        [(i, 0.05 if i < N_NOISY else 0.0) for i in range(BATCH)],
        duration=DURATION, fs=fs)
    x, f0, x_ref = (torch.tensor(np.stack([r[j] for r in rows]),
                                 dtype=torch.float32, device=dev)
                    for j in range(3))
    nxv = torch.full((BATCH,), x.shape[1], dtype=torch.int64, device=dev)
    return x, f0, x_ref, nxv


def _lf_utterance(i):
    from libllsm2_tpu_torch.utils import testsig
    nfrm = int(round(DURATION / 0.005))
    return testsig.synth_lf_speech(testsig.make_f0_track(nfrm, 0.005),
                                   rd=LF_RD[i % len(LF_RD)], seed=i)


def lf_fixtures(torch, dev):
    """Phase 10's LF rows, made here (numpy, scipy and the port's LF model
    on the CPU: ~30 ms a row) -> (x, f0)."""
    import numpy as np
    rows = [_lf_utterance(i) for i in range(BATCH)]
    return tuple(torch.tensor(np.stack([r[j] for r in rows]),
                              dtype=torch.float32, device=dev)
                 for j in range(2))


def snr_rows(torch, ref, y, fs, f0_floor):
    """snr_db of every row of a batch -> list."""
    return [snr_db(torch, ref[b], y[b], fs, f0_floor)
            for b in range(ref.shape[0])]


def staged(torch, stages):
    """Run the (name, fn) stages in order, each fed the previous result,
    with a synchronized host timer around each -> (result, {name: ms})."""
    out, ms = None, {}
    for name, fn in stages:
        t0 = time.perf_counter()
        out = fn(out)
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
    return out, ms


def median_stages(torch, stages, reps):
    """Stage times (median of reps) and the peak memory of those runs."""
    torch.cuda.reset_peak_memory_stats()
    runs = [staged(torch, stages)[1] for _ in range(reps)]
    return ({k: statistics.median(r[k] for r in runs) for k in runs[0]},
            torch.cuda.max_memory_allocated() / 2**30)


def layer1_round_trip(torch, kernels, mods, opt, sopt, data):
    """Phase 9: the library-default analysis -> chunk_to_layer1 ->
    chunk_to_layer0 -> _synthesize on the bench rows -> (the layer-0
    chunk, launches)."""
    layer0, layer1 = mods
    x, f0, x_ref, _ = data
    B = x.shape[0]
    conf = opt.conf
    chunk0 = {}

    def analysis(_):
        chunk0["c"] = layer0._analyze(opt, x, f0)
        return chunk0["c"]

    stages = [("analyze", analysis), ("to_layer1", layer1.chunk_to_layer1),
              ("to_layer0", layer1.chunk_to_layer0),
              ("synthesize", lambda c: layer0._synthesize(sopt, c))]
    kernels.reset_launches()
    out, _ = staged(torch, stages)
    launches = dict(kernels.LAUNCHES)
    phase("9 layer1 launches", all(launches[k] > 0 for k in MAIN),
          str(launches))
    phase("9 layer1 output", tuple(out.y.shape) == tuple(x.shape)
          and bool(torch.isfinite(out.y).all()),
          f"y {tuple(out.y.shape)} finite")
    snr = snr_rows(torch, x_ref, out.y_sin, conf.fs, conf.f0_floor)
    print(f"9 layer1: y_sin snr by row (dB): {[round(v, 4) for v in snr]}",
          flush=True)
    pin_clean = LAYER1_PINS_DB[max(LAYER1_PINS_DB)]
    check_snr("9 layer1", snr, LAYER1_PINS_DB, None)
    phase("9 layer1 every clean row", min(snr[B // 2:]) >= pin_clean
          - CLEAN_TOL_DB, f"min {min(snr[B // 2:]):.4f} dB (pin {pin_clean} "
          f"- {CLEAN_TOL_DB})")
    ms, peak = median_stages(torch, stages, 3)
    g = torch.Generator(device=x.device).manual_seed(0)
    score = torch.rand((B, chunk0["c"].nfrm, layer1.RD_GRID_SIZE),
                       generator=g, device=x.device)
    voiced = chunk0["c"].f0 > 0
    vit_ms = cuda_ms(torch, lambda: layer1._rd_viterbi(score, voiced, 10.0), 3)
    print(f"9 layer1: _rd_viterbi on [{B}, {score.shape[1]}, "
          f"{score.shape[2]}] scores {vit_ms:.2f} ms a call (median of 3; "
          f"two calls in each chunk_to_layer1)", flush=True)
    del score
    l1_ms = ms["to_layer1"] + ms["to_layer0"] + ms["synthesize"]
    phase("9 layer1 step", True,
          f"{B} x {DURATION} s: " + ", ".join(f"{k} {v:.2f} ms"
                                              for k, v in ms.items())
          + f" (median of 3); layer-1 round trip {l1_ms:.2f} ms = "
          f"{B * DURATION / (l1_ms / 1e3):.1f} audio-sec/s; with the analysis "
          f"{B * DURATION / (sum(ms.values()) / 1e3):.1f} audio-sec/s; peak "
          f"{peak:.2f} GiB")
    return chunk0["c"], launches


def pbp_phase(torch, kernels, mods, opt, sopt, dev):
    """Phase 10: LF rows -> the library-default analysis -> chunk_to_layer1
    -> pbp_synthesize -> launches."""
    from libllsm2_tpu_torch.container import (chunk_from_numpy,
                                              chunk_to_numpy, index_batch)
    layer0, layer1, pbp = mods
    t0 = time.perf_counter()
    x, f0 = lf_fixtures(torch, dev)
    print(f"10 pbp fixtures: {BATCH} x {DURATION} s of synth_lf_speech in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    B = x.shape[0]
    conf = opt.conf
    chunk0 = {}

    def analysis(_):
        chunk0["c"] = layer0._analyze(opt, x, f0)
        return chunk0["c"]

    stages = [("analyze", analysis), ("to_layer1", layer1.chunk_to_layer1),
              ("pbp", lambda c: (c, pbp._pbp_synthesize(sopt, c)))]
    kernels.reset_launches()
    (l1, out), _ = staged(torch, stages)
    launches = dict(kernels.LAUNCHES)
    phase("10 pbp launches", launches["noise_mod_ola"] > 0
          and launches["fir_frames"] > 0 and launches["noise_bins"] > 0,
          str(launches))
    phase("10 pbp output", tuple(out.y.shape) == tuple(x.shape)
          and bool(torch.isfinite(out.y).all()),
          f"y {tuple(out.y.shape)} finite")
    errs = []
    for b in range(B):
        med = float(torch.median(l1.rd[b][l1.f0[b] > 0]))
        errs.append(abs(med - LF_RD[b % len(LF_RD)]) / LF_RD[b % len(LF_RD)])
    worst = max(range(B), key=errs.__getitem__)
    phase("10 pbp rd", max(errs) <= RD_REL_TOL,
          f"median voiced rd within {max(errs) * 100:.2f}% of the truth "
          f"(worst row {worst}, Rd {LF_RD[worst % len(LF_RD)]}; "
          f"limit {RD_REL_TOL * 100:.0f}%)")
    for row, pin in RD_PINS.items():
        med = float(torch.median(l1.rd[row][l1.f0[row] > 0]))
        phase(f"10 pbp rd row {row}", abs(med - pin) <= RD_PIN_REL_TOL * pin,
              f"median voiced rd {med:.6f} (JAX {pin:.6f} +- "
              f"{RD_PIN_REL_TOL * 100:.0f}%)")
    # the card's Rd fit (scores, Viterbi, IRLS pass) against the CPU's on
    # one full-length row from the same layer-0 parameters
    t0 = time.perf_counter()
    row_cpu = chunk_from_numpy(chunk_to_numpy(index_batch(chunk0["c"],
                                                          slice(0, 1))),
                               conf, device="cpu")
    rd_cpu = layer1.chunk_to_layer1(row_cpu).rd[0]
    rel = torch.abs(l1.rd[0].cpu() - rd_cpu) / rd_cpu
    phase("10 pbp rd row 0 card vs cpu", float(rel.max()) <= RD_CPU_REL_TOL,
          f"{rd_cpu.shape[0]} frames: max relative difference "
          f"{float(rel.max()):.3e}, {int((rel > RD_CPU_REL_TOL).sum())} "
          f"frames over {RD_CPU_REL_TOL} (CPU fit "
          f"{time.perf_counter() - t0:.1f} s)")
    chunk0.clear()
    y_sin = layer0._synthesize(sopt, layer1.chunk_to_layer0(l1)).y_sin
    for row, pin in PBP_PINS_DB.items():
        snr = snr_db(torch, y_sin[row], out.y_sin[row], conf.fs, conf.f0_floor)
        phase(f"10 pbp snr row {row}", abs(snr - pin) <= NOISY_TOL_DB,
              f"PbP y_sin against the sinusoidal y_sin {snr:.4f} dB "
              f"(JAX {pin:.4f} +- {NOISY_TOL_DB})")
    del y_sin, out
    ms, peak = median_stages(torch, stages, 3)
    phase("10 pbp step", True,
          f"{B} x {DURATION} s: " + ", ".join(f"{k} {v:.2f} ms"
                                              for k, v in ms.items())
          + f" (median of 3); PbP {B * DURATION / (ms['pbp'] / 1e3):.1f} "
          f"audio-sec/s; peak {peak:.2f} GiB")
    return launches


def phase5_breakdown(torch, mods, opt, sopt, data):
    """Phase 5's two harmonic_analysis calls (analysis_calls) and its two
    harmonic renders (render_calls), then its analysis and synthesis apart:
    time (median of 3) and the peak memory each takes above its inputs,
    which says which half sets the step's peak, and each analysis stage's
    synchronized time and peak -> (the analysis-call records, the
    render-call records)."""
    harmonics, layer0, corpus, kernels = mods
    x, f0, x_ref, nxv = data
    step = lambda: corpus.batched_pipeline(opt, sopt, x, f0, nxv, x_ref)
    calls = analysis_calls(torch, harmonics, step)
    renders = render_calls(torch, harmonics, kernels, step)
    stages = [("analyze", lambda _: layer0._analyze(opt, x, f0)),
              ("synthesize", lambda c: layer0._synthesize(sopt, c))]
    ms, _ = median_stages(torch, stages, 3)
    chunk, peak_a = peak_above(torch, lambda: layer0._analyze(opt, x, f0))
    peak_s = peak_above(torch, lambda: layer0._synthesize(sopt, chunk))[1]
    print(f"5 stages: analyze {ms['analyze']:.2f} ms, peak {peak_a:.3f} GiB "
          f"above its inputs; synthesize {ms['synthesize']:.2f} ms, peak "
          f"{peak_s:.3f} GiB above the chunk (median of 3)", flush=True)
    # the analysis's own stages (siblings inside _analyze): each call's
    # time, synchronized before and after (summed over a stage's calls;
    # median of 3 analyses), and its peak above the memory allocated when
    # it starts
    hooks = [(harmonics, "refine_f0"), (harmonics, "harmonic_analysis"),
             (layer0, "_deconv_correction"), (layer0, "_track_denoise"),
             render_hook(harmonics, kernels), (layer0, "_band_envelopes"),
             (layer0, "_warped_psd")]
    runs, peaks = [], {}

    def tracked(name, fn):
        def wrapped(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, gib = peak_above(torch, lambda: fn(*args, **kw))
            runs[-1][name] = runs[-1].get(name, 0.0) \
                + (time.perf_counter() - t0) * 1e3
            peaks[name] = max(peaks.get(name, 0.0), gib)
            return out
        return wrapped

    originals = [(mod, name, getattr(mod, name)) for mod, name in hooks]
    for mod, name, fn in originals:
        setattr(mod, name, tracked(name, fn))
    try:
        for _ in range(3):
            runs.append({})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layer0._analyze(opt, x, f0)
            torch.cuda.synchronize()
            runs[-1]["total"] = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    ms = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    print("5 analysis stages, ms (synchronized, median of 3) and peak GiB "
          "above each call's start: " + ", ".join(
              f"{k} {ms[k]:.2f} ms {peaks[k]:.3f} GiB" for k in peaks)
          + f"; the analysis {ms['total']:.2f} ms, of which "
          f"{ms['total'] - sum(ms[k] for k in peaks):.2f} ms outside them",
          flush=True)
    return calls, renders


def capture_kernel_inputs(kernels, names, run):
    """Run `run()` with the functions `names` of module `kernels` recording
    the arguments of each call -> ({name: [(args, kw), ...]}, run's
    result)."""
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
        result = run()
    finally:
        for name, fn in originals.items():
            setattr(kernels, name, fn)
    return calls, result


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
        x, f0, x_ref = (v.astype("float32")
                        for v in testsig.make_test_utterance(
                            duration=1.0, fs=fs, seed=seed,
                            noise_level=0.05 if seed < N_NOISY else 0.0,
                            return_parts=True))
        chunk = lt.analyze(opt, x, f0)          # numpy: on the card by default
        phase(f"8 public 11025 Hz seed {seed} device",
              chunk.ampl.device == dev, f"numpy input analyzed on "
              f"{chunk.ampl.device}")
        out = lt.synthesize(sopt, chunk)
        x_ref = torch.tensor(x_ref, device=dev)
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


def main(argv):
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 2
    if argv and (len(argv) != 2 or argv[0] != "breakdown"):
        print(__doc__, flush=True)
        return 2
    # "breakdown DIR": only phase 5's breakdown, of the package in DIR
    other = Path(argv[1]).resolve() if argv else None
    repo = other or Path(__file__).resolve().parent
    if not (repo / "libllsm2_tpu_torch" / "__init__.py").exists():
        print(f"FAIL: no libllsm2_tpu_torch package in {repo}", flush=True)
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
    from libllsm2_tpu_torch.models import layer0, layer1, pbp
    from libllsm2_tpu_torch.ops import _build, harmonics, kernels
    from libllsm2_tpu_torch.parallel import corpus

    t0 = time.perf_counter()
    _build.library()
    phase("2 build", True, f"{time.perf_counter() - t0:.1f} s "
          "(nvcc sm_90a, ctypes)")
    print("2 ptxas: " + "; ".join(
        f"{kernel_label(name)} {regs} registers, {spill} B spilled, {smem} B "
        "static smem" for name, regs, spill, smem in _build.resource_usage()),
        flush=True)

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
    if other:
        print(f"breakdown of the package in {other}", flush=True)
        phase5_breakdown(torch, (harmonics, layer0, corpus, kernels), opt,
                         sopt, data)
        return 0
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

    opt_lp = dataclasses.replace(opt, track_lowpass_hz=30.0)
    captures = [
        ("", MAIN, lambda: corpus.batched_pipeline(opt, sopt, *two(data))),
        ("lowpass ", ("fir_frames",),
         lambda: corpus.batched_pipeline(opt_lp, sopt, *two(data))),
        ("matmul ", ("harmonic_project_mxu",),
         lambda: corpus.batched_pipeline(opt_mxu, sopt, *two(data))),
        ("refine K=1 ", ("harmonic_project",),
         lambda: corpus.batched_pipeline(opt11, sopt11, *two(data11))),
        ("mltsine K=80 ", ("harmonic_project",), mltsine),
    ]
    cases = {name: [] for name in KERNELS}
    for prefix, names, run in captures:
        calls, _ = capture_kernel_inputs(kernels, names, run)
        for name in names:
            tol = KERNELS[name][2]
            if not calls[name]:
                phase(f"3 {name}", False,
                      f"not called by {prefix or 'the main path'}")
            for i, (args, kw) in enumerate(calls[name]):
                cases[name].append(check_kernel(
                    torch, kernels, name, tol, args, kw, f"{prefix}{i}",
                    library=not cases[name]))
                for label, v_args, v_kw in variants(torch, name, args, kw):
                    cases[name].append(check_kernel(torch, kernels, name, tol,
                                                    v_args, v_kw, label))
        if "noise_mod_ola" in names:
            # env_render on the main path's envelope coefficients: the
            # first five arguments of its noise_mod_ola call
            for i, (args, _) in enumerate(calls["noise_mod_ola"]):
                cases["env_render"].append(check_kernel(
                    torch, kernels, "env_render", KERNELS["env_render"][2],
                    args[:5], {}, f"noise_mod_ola {i}",
                    library=not cases["env_render"]))
        del calls
    summary = {name: {"name": name, "route": "cuda", "source": source,
                      "replaces": replaces, "launches": 0,
                      "max_abs_err": max(c["max_abs_err"]
                                         for c in cases[name]),
                      **{k: cases[name][0][k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms")},
                      "cases": cases[name]}
               for name, (source, replaces, _) in KERNELS.items()}
    full = {}

    # phase 4: the denoiser-off path on 32 rows
    rows = torch.tensor(OFF_ROWS, device=dev)
    run_path(torch, kernels, corpus, "4 denoiser off", opt_off, sopt,
             tuple(d[rows] for d in data), NOISY_PINS_DB["denoiser off"],
             ("osc_bank", "harmonic_project_win", "deconv_full",
              "noise_mod_ola", "noise_bins"), (), noisy_tol=L0_NOISY_TOL_DB)
    # phase 5: the main path, the library default, on all 128 rows
    launches, snr5, f = run_path(torch, kernels, corpus, "5 library default",
                                 opt, sopt, data,
                                 NOISY_PINS_DB["library default"], MAIN, MAIN,
                                 noisy_tol=L0_NOISY_TOL_DB)
    for name in MAIN:
        summary[name]["launches"] = launches[name]
    full.update(f)
    (summary["harmonic_project_win"]["analysis_calls"],
     summary["osc_bank"]["render_calls"]) = phase5_breakdown(
        torch, (harmonics, layer0, corpus, kernels), opt, sopt, data)
    # phase 6: hm_kernel="matmul" at the library default, all 128 rows
    launches, snr6, f = run_path(torch, kernels, corpus, "6 matmul", opt_mxu,
                                 sopt, data, NOISY_PINS_DB["library default"],
                                 ("harmonic_project_mxu",) + MAIN_SIX,
                                 ("harmonic_project_mxu",),
                                 noisy_tol=L0_NOISY_TOL_DB)
    summary["harmonic_project_mxu"]["launches"] = \
        launches["harmonic_project_mxu"]
    full.update(f)
    diff = [a - b for a, b in zip(snr6, snr5)]
    print(f"6 matmul: snr - phase 5 snr: max |diff| "
          f"{max(map(abs, diff)):.4f} dB, noisy rows 0/1 {diff[0]:+.4f} / "
          f"{diff[1]:+.4f} dB, clean mean "
          f"{statistics.fmean(diff[BATCH // 2:]):+.4f} dB", flush=True)
    # phase 7: odd hop at 11 kHz, all 128 rows
    launches, _, f = run_path(torch, kernels, corpus, "7 odd hop", opt11,
                              sopt11, data11, ODD_HOP_PINS_DB,
                              ("harmonic_project",) + MAIN_SIX,
                              ("harmonic_project",), clean_min=None)
    summary["harmonic_project"]["launches"] = launches["harmonic_project"]
    full.update(f)
    del data11
    # phase 8: an 11.025 kHz file through the public API
    public_11025(torch, kernels, lt, dev)
    # phase 9: the layer-1 round trip on the bench rows
    chunk, _ = layer1_round_trip(torch, kernels, (layer0, layer1), opt, sopt,
                                 data)
    # env_render, which no library path runs: the full-batch chunk's
    # envelopes through layer0._render_envelopes(use_pallas=True)
    nx = chunk.nfrm * conf.nhop
    cyc = harmonics.sample_cycles(chunk.f0, conf.nhop, conf.fs, nx)
    render = lambda: layer0._render_envelopes(chunk, cyc, conf.nhop,
                                              use_pallas=True)
    kernels.reset_launches()
    calls, (env, base) = capture_kernel_inputs(kernels, ("env_render",),
                                               render)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    phase("9 env_render launches", launches["env_render"] == 1
          and bool(torch.isfinite(env).all() and torch.isfinite(base).all()),
          f"env, base {tuple(env.shape)} finite; {launches}")
    summary["env_render"]["launches"] = launches["env_render"]
    full.update(full_batch(torch, kernels, calls, "9"))
    del chunk, cyc, env, base, data, calls
    # phase 10: pulse-by-pulse synthesis of LF rows
    pbp_phase(torch, kernels, (layer0, layer1, pbp), opt, sopt, dev)
    for name in KERNELS:
        summary[name]["full_batch"] = full[name]
    print(card, flush=True)

    print(json.dumps({"kernels": list(summary.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke did not complete", flush=True)
        rc = 1
    sys.exit(rc)
