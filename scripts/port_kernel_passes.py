"""Where the time of six of the port's kernels goes, by compiling passes
out: noise_mod_ola.cu (pass 1, the band iDFT; pass 2, the OLA, envelope
and band sum), deconv_full.cu (the tap build; the output pass),
harmonic_project_mxu.cu (the making of G and the window rows; the banded
product), sample_cycles.cu (the steps' lerp and divide; the output
pass) and refine_f0.cu (the decimation into shared memory; the probes),
the last two on F0 70-300 Hz with every 7th frame unvoiced, each built
four times from the sources in
libllsm2_tpu_torch/csrc with one, the other, both or neither pass skipped
(their LLSM_SKIP_PASS_A / _B), and timed at the bench shape (128 rows x
1600 frames, 16 kHz: hop 80, K 80, D 7; the projection's halfwidths 107-
458, as F0 70-300 Hz gives them, reach 480; the refine's decimation 8,
97 taps) on random inputs, a launch's share of a run of 20 (CUDA events,
best of 5).  What is left with both passes skipped is the staging: the
block's loads into shared memory and its tables (for the projection, the
chunk walk, its barriers and the epilogue).  Needs a CUDA card and nvcc;
imports no jax:

    PYTHONPATH=. python3 scripts/port_kernel_passes.py [only=name,...]
        [split=DIR,...]

(name: a source of PASSES below, viterbi, deconv_wide, denoise_wide,
noise_wide, noise_long, apply_wide, seg, cycles_long, cycles_hop,
proj_part, project_rows, env_wide, env_tiles, noise_floor, viterbi_wide
or viterbi_layouts.)

split= instead times each CUDA kernel of kernels.refine_f0_dec, by its
name in a torch.profiler trace, of the package in each DIR (a checkout,
e.g. the parent commit unpacked under build/archive/), at the bench shape
on the bench rows' x and F0 and on random x with F0 70-300 Hz (every 7th
frame unvoiced), then on the bench rows at the smaller shapes the port
also runs: 16 rows, 2 rows (chip_smoke's phase 3), row 0 alone (a one-file
analyze()), its frames 800-959 (a RTAnalyzer block of 160 frames) and
rows 0 and 1 end to end as one 3200-frame row (a frame shard's block in
chip_smoke's phase 19a): the split between a version's kernels, and its
device time at each shape.  Then, the same way, every CUDA kernel that
harmonics.refine_f0 runs at 11 kHz (hop 55: the full-rate refine, one
launch of refine_f0_full or, in a version before it, the framing glue and
harmonic_project's five K = 1 launches) on the bench rows made at 11 kHz
(all 128, 16, 2, row 0 alone, rows 0 and 1 as one 3200-frame row), and
kernels.noise_bins at the bench shape (one [1600, 81] draw a call).

only=viterbi times viterbi.cu (the two Viterbi scans, one launch) built
with and without its backtrace (LLSM_SKIP_PASS_B: the walk back along the
backpointers compiled out, the final argmax kept), at the tracker's
[64, 1600, 97] (renormalized, its transitions) and layer 1's Rd
[128, 1600, 64] (lt = -pen, lam 10) on uniform random scores, all rows and
row 0 alone: the forward and backtrace split and the cycles a step at the
SM clock; then past 256 states, where the grid kernel runs (lt mode 4:
[64, 1600, 257] and [64, 1600, 1025] renormalized, [64, 1600, 512] not,
under the tracker's transitions at S = nbins + 1, all rows and row 0
alone), also built without its candidates (LLSM_SKIP_PASS_A: the max-plus
product compiled out; the staging of the scores, the merges, the
writes, the row maxima and the grid barriers kept): a step's fixed cost;
then past 2048 states, where the stream kernel runs (lt mode 5: [64,
1600, 2049] renormalized and [64, 1600, 4097] not, all rows and row 0
alone), the same three builds (without its candidates, the chunks'
staging, the merges, the group resolve from device memory, the writes
and the barriers are kept).

only=deconv_wide times deconv_full.cu's wide path at the full-band
shapes of chip_smoke.py's phase 20e on random inputs (48 kHz at the 5 ms
hop: [128, 1600, 600], D 11, hop 240; 16 kHz at a 2 ms hop: [128, 4000,
200], D 26, hop 32; halfwidths up to the band's), all rows and row 0
alone, then built without its tap build (LLSM_SKIP_PASS_A: the first
launch left out), without its output pass (LLSM_SKIP_PASS_B: the walk
and the epilogue compiled out, the staging kept) and without both.
only=denoise_wide times denoise_stats.cu's wide path the same way at
20e's shapes ([128, 1600, 600] with 13 + 7 taps, [128, 4000, 200] with
33 + 17), 20a's K 160 and 20c's 33 + 17 taps at K 80, built without its
first launch (LLSM_SKIP_PASS_A: the rows' staging, slow tracks, outputs
and partial sums) and without its second (LLSM_SKIP_PASS_B: the fit and
the probe).  only=noise_wide times noise_mod_ola.cu's wide kernel at
chip_smoke.py's phase 20b (48 kHz at a 10 ms hop: gains [128, 800, 481],
4 bands, 4 envelope harmonics, one draw for the batch) the same way,
built without pass 1 (LLSM_SKIP_PASS_A: the band iDFT) and without pass 2
(LLSM_SKIP_PASS_B: the OLA, envelope and band sum); only=noise_long
the same for its long kernel (where the wide kernel's block would hold
fewer than 16 frames) at phases 20g and 20h (48 kHz at 20 and 50 ms:
gains [128, 400, 961] and [128, 160, 2401]) and at 96 kHz / 200 ms on 32
rows (gains [32, 40, 19201]), what is left with both the prep's staging
into device memory, the chunks' copies, e^{2 pi j cyc} and the stores;
only=apply_wide
denoise_apply.cu's wide kernel at 20e's shapes ([128, 1600, 600] and
[128, 4000, 200]) and 20a's K 160, spectral (the main path's) and at
[128, 1600, 600] polar, built without its fit sums (LLSM_SKIP_PASS_A)
and without its gate and stores (LLSM_SKIP_PASS_B).

only=seg times noise_mod_ola.cu's segment entry (noise_mod_ola_seg, the
noise_idft="fft" path) the same way at chip_smoke.py's 16c shape (segs
[128, 4, 1600, 160], 4 envelope harmonics) and at 20f's 9 channels of 9
harmonics, built without its envelope (LLSM_SKIP_PASS_A: the rotation
ladder and the coefficients' lerps, an envelope of 1) and without its
segment loads (LLSM_SKIP_PASS_B: an OLA of 1); what is left with both is
the staging, the cycle load and the stores.  only=cycles_long times
sample_cycles.cu past a 512-sample hop (48 kHz at a 20 ms hop, f0 [128,
400], and hop 2048, f0 [128, 187]; F0 70-300 Hz with every 7th frame
unvoiced), built without its steps (LLSM_SKIP_PASS_A: the lerp and the
divide) and without its output pass (LLSM_SKIP_PASS_B); what is left with
both is the in-hop scan, the hop offsets and the staging.  only=cycles_hop
times it past a 2048-sample hop (its hop kernel: phase 20h's hop 2400 at
48 kHz, f0 [128, 160], hop 19200 at 96 kHz, f0 [128, 40], and hop 60000
at 96 kHz, f0 [128, 12], whose steps overflow the block's shared memory;
F0 70-1000 Hz, every 7th frame unvoiced) the same way: without its steps
(LLSM_SKIP_PASS_A: a step is then its table read) and without its output
pass (LLSM_SKIP_PASS_B).

only=proj_part times harmonic_project_win's warp kernel (a warp a frame,
where the 16-frame tile would not leave room for two blocks an SM) at
phases 20g and 20h (48 kHz at 20 and 50 ms: x [128, 384000], hops 960 /
2400, C 1920 / 2400, halfwidths to 1372) and at 96 kHz / 200 ms (x [128,
768000], hop and C 19200, halfwidths to 4800), K 80, every frame's live
slots random, built without its harmonics (LLSM_SKIP_PASS_A: every slot
dead, so only the window and x sums walk the columns) and without its
column walk (LLSM_SKIP_PASS_B); what is left with both is the frame
records, the zero slots' stores and the launch.  only=project_rows times
harmonic_project's row kernel (K 80) on 5120 frames of 96 kHz / 200 ms
(W 38400, live spans to 9601 columns, a third of them past the block's
staged columns, and to 5487: F0 of 70 Hz or more, every span staged
once), built without its harmonics (LLSM_SKIP_PASS_A: no group in a pass)
and without its staging (LLSM_SKIP_PASS_B); what is left with both is the
walk's loop, the block sums and the stores.

only=env_wide times env_render.cu's wide kernel (past 8 envelope
harmonics) at chip_smoke.py's phase 20f shapes (cycle tracks [128,
128000] at hop 80 with 4 channels of 9 harmonics, [128, 384000] at hop
480 with 3 channels of 12) on random inputs, built without its harmonic
terms (LLSM_SKIP_PASS_A: the rotation ladder and the coefficients'
lerps) and without its coefficient staging (LLSM_SKIP_PASS_B: zeros
staged instead of the frames' coefficients); what is left with both is
the cycle loads, one sincospif a sample and the stores; only=env_tiles
times it at the same shapes built with tiles of 16, 32 and 64 frames
forced (LLSM_ENV_TILE) and with launch bounds of 2 and 3 blocks an SM
(LLSM_ENV_BLOCKS), beside the library's own.  only=noise_floor
times kernels.noise_bins at the bench shape (one [1600, 81] draw a call,
as phase 5 calls it) and a one-element torch fill, each by its kernels'
device time in a torch.profiler trace of 20 calls, in three alternated
rounds in one process: the draw beside the device time of a launch that
does almost no work.  only=viterbi_wide times kernels.viterbi_scan past
2048 states at chip_smoke.py's phase 20d shapes ([64, 1600, 2049]
renormalized, [64, 1600, 4097] not, then row 0 alone at each; seeded
scores in eighths with -inf entries under the tracker's transitions at S
= nbins + 1), a call's time (CUDA events, median of 3 after one untimed),
beside its bound, B (N - 1) S^2 adds and compares at 67 TFLOP/s.
only=viterbi_layouts times the stream kernel at 20d's 64-row shapes
under its route's layout and under others forced (row warps, parts of
the source states, chunk), each output equal to the route's.

The variants go to build/kernels/ beside the library (listed in
.gitignore), each under a hash of its source and defines.
"""
import ctypes
import importlib
import json
import math
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from port_harness import load

from libllsm2_tpu_torch.config import ChunkConf
from libllsm2_tpu_torch.ops import _build, harmonics, kernels

B, N, NHOP, C, KE, K, D = 128, 1600, 80, 4, 4, 80, 7
# source -> what its LLSM_SKIP_PASS_A and LLSM_SKIP_PASS_B compile out
PASSES = {
    "noise_mod_ola": ("pass 1 (band iDFT)",
                      "pass 2 (OLA, envelope, band sum)"),
    "deconv_full": ("the tap build", "the output pass"),
    "harmonic_project_mxu": ("G and the window rows", "the banded product"),
    "sample_cycles": ("the steps' lerp and divide", "the output pass"),
    "refine_f0": ("the decimation into shared memory", "the probes"),
}
# viterbi.cu's shapes: (label, B, N, S, renorm)
VITERBI_SHAPES = (("tracker", 64, 1600, 97, True),
                  ("tracker row 0", 1, 1600, 97, True),
                  ("Rd", 128, 1600, 64, False),
                  ("Rd row 0", 1, 1600, 64, False),
                  ("S 257", 64, 1600, 257, True),
                  ("S 257 row 0", 1, 1600, 257, True),
                  ("S 512", 64, 1600, 512, False),
                  ("S 1025", 64, 1600, 1025, True),
                  ("S 1025 row 0", 1, 1600, 1025, True),
                  ("S 2049", 64, 1600, 2049, True),
                  ("S 2049 row 0", 1, 1600, 2049, True),
                  ("S 4097", 64, 1600, 4097, False),
                  ("S 4097 row 0", 1, 1600, 4097, False))
# C entry of a source, where its name is not llsm_<source>
ENTRIES = {"refine_f0": "llsm_refine_f0_dec"}
SPLIT_REPS = 20


def build_variants(names):
    """-> {(name, skip_a, skip_b): C entry} for the kernels `names`, built
    by _build.variants (its cache under build/kernels/; the missing ones
    one nvcc each, all started together)."""
    keys = [(name, a, b) for name in names for a in (0, 1) for b in (0, 1)]
    libs = _build.variants([(name, {"LLSM_SKIP_PASS_A": a,
                                    "LLSM_SKIP_PASS_B": b})
                            for name, a, b in keys])
    return {key: getattr(lib, ENTRIES.get(key[0], "llsm_" + key[0]))
            for key, lib in zip(keys, libs)}


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


def viterbi_passes():
    """viterbi.cu with and without its backtrace at VITERBI_SHAPES, a line
    each (the docstring says how)."""
    import chip_smoke
    from libllsm2_tpu_torch.models import layer1
    from libllsm2_tpu_torch.ops import f0 as f0mod
    full = _build.library().llsm_viterbi_scan
    fwd, fixed = (lib.llsm_viterbi_scan for lib in _build.variants(
        [("viterbi", {"LLSM_SKIP_PASS_B": 1}),
         ("viterbi", {"LLSM_SKIP_PASS_A": 1})]))
    mhz, src = chip_smoke.sm_clock_mhz(torch)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    tracker_lt = f0mod._tables(f0mod.F0Config(f0_floor=70.0), dev)["lt"]
    G = 64
    dstep = (math.log(layer1.RD_MAX) - math.log(layer1.RD_MIN)) / (G - 1)
    ar = torch.arange(G, device=dev, dtype=torch.float32)
    rd_lt = -(10.0 * ((ar[:, None] - ar[None, :]) * dstep) ** 2)
    for label, B, N, S, renorm in VITERBI_SHAPES:
        obs = torch.rand((B, N, S), generator=g, device=dev)
        lt = (tracker_lt if renorm else rd_lt).contiguous()
        if S > 256:
            lt = f0mod._tables(f0mod.F0Config(nbins=S - 1), dev)["lt"]
        geo = kernels._viterbi_geometry(N, S)
        path = torch.empty((B, N), dtype=torch.int64, device=dev)
        final = torch.empty((B, S), device=dev)
        bp = kernels._viterbi_scratch(B, N, S, dev)
        args = kernels._viterbi_launch_args(obs, lt, renorm, path, final, bp)
        ms = {}
        variants = (("whole", full), ("forward", fwd)) + (
            (("fixed", fixed),) if geo[3] >= 4 else ())
        for name, fn in variants:
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"viterbi {label}: cudaError {rc}")
            ms[name] = run_ms(lambda: fn(*args), 20 if S <= 256 else 3)
        cyc = lambda t: t / (N - 1) * mhz * 1e3
        grid = (f" grid {kernels._viterbi_grid(B, S)}" if geo[3] == 4
                else f" grid {kernels._viterbi_stream(B, S)}" if geo[3] == 5
                else f" threads {geo[2]}")
        fixed_ms = "" if "fixed" not in ms else (
            f"; without its candidates {ms['fixed']:.4f} ms = "
            f"{cyc(ms['fixed']):.0f} cycles a step")
        print(f"viterbi {label} [{B}, {N}, {S}] P {geo[0]} C {geo[1]} "
              f"lt mode {geo[3]}{grid}: whole "
              f"{ms['whole']:.4f} ms a launch in a run = "
              f"{cyc(ms['whole']):.0f} cycles a step; forward (backtrace "
              f"compiled out) {ms['forward']:.4f} ms = "
              f"{cyc(ms['forward']):.0f} cycles a step; backtrace "
              f"{ms['whole'] - ms['forward']:.4f} ms{fixed_ms} (at "
              f"{mhz:.0f} MHz, {src})", flush=True)


# deconv_full's full-band shapes: (label, B, N, K, D, nhop)
DECONV_WIDE_SHAPES = (("48 kHz", 128, 1600, 600, 11, 240),
                      ("16 kHz 2 ms", 128, 4000, 200, 26, 32))
# denoise_stats's wide shapes: (label, B, N, K, n1, n2), chip_smoke.py's
# phase 20e, 20a and 20c
DENOISE_WIDE_SHAPES = (("48 kHz", 128, 1600, 600, 13, 7),
                       ("16 kHz 2 ms", 128, 4000, 200, 33, 17),
                       ("creaky K 160", 128, 1600, 160, 13, 7),
                       ("33 + 17 taps", 128, 1600, 80, 33, 17))


def with_library(lib, fn):
    """fn() with kernels' launches going to the variant library lib."""
    keep = _build.library
    _build.library = lambda: lib
    try:
        return fn()
    finally:
        _build.library = keep


def wide_variants(source, label, call, names):
    """Times call() (all rows; then row 0 alone with the whole build) with
    the library and with source's variants that leave out each pass (one
    line); names: what LLSM_SKIP_PASS_A and _B leave out."""
    libs = _build.variants([(source, {"LLSM_SKIP_PASS_A": a,
                                      "LLSM_SKIP_PASS_B": b})
                            for a, b in ((1, 0), (0, 1), (1, 1))])
    whole = run_ms(lambda: call(128))
    alone = run_ms(lambda: call(1))
    parts = [f"without {what} {run_ms(lambda: with_library(lib, lambda: call(128))):.4f} ms"
             for lib, what in zip(libs, names + (" and ".join(names),))]
    print(f"{label}: whole {whole:.4f} ms, row 0 alone {alone:.4f} ms; "
          + "; ".join(parts) + " (a launch in a run of 20)", flush=True)


def deconv_wide():
    """deconv_full.cu's wide path at DECONV_WIDE_SHAPES (the docstring
    says how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, Bw, Nw, Kw, Dw, hop in DECONV_WIDE_SHAPES:
        mask = (r(Bw, Nw, Kw) > 0.1).float()
        ampl, phse = r(Bw, Nw, Kw) * mask, (6.0 * r(Bw, Nw, Kw) - 3.0) * mask
        cyc = torch.remainder(torch.cumsum(r(Bw, Nw * hop) * 0.02, -1), 1.0)
        hw = 30.0 + r(Bw, Nw) * (Dw - 1) * hop
        geo = kernels._deconv_geometry(Dw, Kw, 2 * hop // 8)
        wide_variants(
            "deconv_full", f"deconv_wide {label} [{Bw}, {Nw}, {Kw}] D {Dw} "
            f"hop {hop}, geometry {geo}",
            lambda rows: kernels.deconv_full(
                *(t[:rows] for t in (ampl, phse, cyc, hw, mask)), Dw, hop, 8),
            ("the tap build", "the output pass"))
        del ampl, phse, mask, cyc, hw
        torch.cuda.empty_cache()


def denoise_wide():
    """denoise_stats.cu's wide path at DENOISE_WIDE_SHAPES (the docstring
    says how), a line each."""
    from libllsm2_tpu_torch.models import layer0
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, Bw, Nw, Kw, n1, n2 in DENOISE_WIDE_SHAPES:
        args = (r(Bw, Nw, Kw), (r(Bw, Nw, Kw) - 0.5) * 6.0, r(Bw, Nw) - 0.5,
                (r(Bw, Nw, Kw) > 0.1).float(), (r(Bw, Nw) > 0.3).float())
        taps = (layer0._hann_taps(n1), layer0._hann_taps(n2))
        geo = kernels._denoise_geometry(Kw, n1, n2)
        wide_variants(
            "denoise_stats", f"denoise_wide {label} [{Bw}, {Nw}, {Kw}] "
            f"{n1} + {n2} taps, geometry {geo}",
            lambda rows: kernels.denoise_stats(
                *(t[:rows] for t in args), *taps),
            ("pass 1 (the rows)", "pass 2 (the fit and the probe)"))
        del args
        torch.cuda.empty_cache()


# noise_mod_ola's wide shape: (label, B, N, nhop, C, Ke, fs, channel edges)
NOISE_WIDE_SHAPES = (("20b 48 kHz 10 ms", 128, 800, 480, 4, 4, 48000.0,
                      (0.0, 3000.0, 6000.0, 9000.0, 24000.0)),)
# the long noise kernel's shapes, the same fields
NOISE_LONG_SHAPES = (("20g 48 kHz 20 ms", 128, 400, 960, 4, 4, 48000.0,
                      (0.0, 3000.0, 6000.0, 9000.0, 24000.0)),
                     ("20h 48 kHz 50 ms", 128, 160, 2400, 4, 4, 48000.0,
                      (0.0, 3000.0, 6000.0, 9000.0, 24000.0)),
                     ("96 kHz 200 ms", 32, 40, 19200, 4, 4, 96000.0,
                      (0.0, 2000.0, 4000.0, 6000.0, 48000.0)))
# denoise_apply's wide shapes: (label, B, N, K, spectral)
APPLY_WIDE_SHAPES = (("48 kHz", 128, 1600, 600, True),
                     ("16 kHz 2 ms", 128, 4000, 200, True),
                     ("creaky K 160", 128, 1600, 160, True),
                     ("48 kHz polar", 128, 1600, 600, False))


def noise_wide(shapes=NOISE_WIDE_SHAPES, name="noise_wide"):
    """noise_mod_ola.cu's wide kernel at NOISE_WIDE_SHAPES (or its long
    kernel at NOISE_LONG_SHAPES: the docstring says how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, Bw, Nw, hop, Cw, Kw, fs, edges in shapes:
        nbin = hop + 1
        cyc = torch.remainder(torch.cumsum(r(Bw, Nw * hop) * 0.02, -1), 1.0)
        args = (cyc, r(Bw, Nw, Cw), r(Bw, Nw, Cw, Kw) - 0.5,
                r(Bw, Nw, Cw, Kw) - 0.5, r(Bw, Nw, Cw) + 0.5,
                torch.randn(1, Nw, nbin, generator=g, device=dev).expand(
                    Bw, Nw, nbin),
                torch.randn(1, Nw, nbin, generator=g, device=dev).expand(
                    Bw, Nw, nbin), r(Bw, Nw, nbin))
        bands = kernels.band_ranges(nbin, fs, edges)
        geo = kernels._noise_geometry(hop, Cw, Kw, bands)
        wide_variants(
            "noise_mod_ola", f"{name} {label} gains [{Bw}, {Nw}, {nbin}] "
            f"C {Cw} Ke {Kw}, geometry {geo}",
            lambda rows: kernels.noise_mod_ola(
                *(t[:rows] for t in args), bands),
            ("pass 1 (band iDFT)", "pass 2 (OLA, envelope, band sum)"))
        del args, cyc
        torch.cuda.empty_cache()


def apply_wide():
    """denoise_apply.cu's wide kernel at APPLY_WIDE_SHAPES (the docstring
    says how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, Bw, Nw, Kw, spectral in APPLY_WIDE_SHAPES:
        cre, cim = r(Bw, Nw, Kw) - 0.5, r(Bw, Nw, Kw) - 0.5
        args = (cre, cim, cre + 0.3 * (r(Bw, Nw, Kw) - 0.5),
                cim + 0.3 * (r(Bw, Nw, Kw) - 0.5), r(Bw, Nw),
                (r(Bw, Nw, Kw) > 0.1).float(), r(Bw, Nw) > 0.2,
                0.05 * r(Bw, Kw), r(Bw, Kw))
        geo = kernels._apply_geometry(Kw, Bw * Nw, kernels._sm_count(dev))
        wide_variants(
            "denoise_apply", f"apply_wide {label} [{Bw}, {Nw}, {Kw}] "
            f"spectral {spectral}, geometry {geo}",
            lambda rows: kernels.denoise_apply(
                *(t[:rows] for t in args[:7]),
                *(t[:rows] for t in args[7:]), 8.0, spectral=spectral),
            ("the fit sums", "the gate and stores"))
        del args, cre, cim
        torch.cuda.empty_cache()


# noise_mod_ola_seg's shapes: (label, B, C, N, nhop, Ke)
SEG_SHAPES = (("16c", 128, 4, 1600, 80, 4), ("C 9 Ke 9", 128, 9, 1600, 80, 9))
# the cycle track's long hops: (label, B, N, nhop, fs)
CYCLES_LONG_SHAPES = (("hop 960 at 48 kHz", 128, 400, 960, 48000.0),
                      ("hop 2048 at 48 kHz", 128, 187, 2048, 48000.0))
# past 2048: the hop kernel (F0 to 1000 Hz)
CYCLES_HOP_SHAPES = (("hop 2400 at 48 kHz", 128, 160, 2400, 48000.0),
                     ("hop 19200 at 96 kHz", 128, 40, 19200, 96000.0),
                     ("hop 60000 at 96 kHz", 128, 12, 60000, 96000.0))


# harmonic_project_win's warp kernel: (label, B, N, nhop, C, H the
# halfwidths' top), K 80
PROJ_PART_SHAPES = (("20g 48 kHz 20 ms", 128, 400, 960, 1920, 1372),
                    ("20h 48 kHz 50 ms", 128, 160, 2400, 2400, 1372),
                    ("96 kHz 200 ms", 128, 40, 19200, 19200, 4800))
# harmonic_project's row kernel: (label, R, W, H), K 80, frames of 96 kHz
# at a 200 ms hop with live spans 2 hw + 1 to 2 H + 1
PROJECT_ROWS_SHAPES = (("96 kHz 200 ms", 5120, 38400, 4800),
                       ("96 kHz 200 ms, F0 >= 70 Hz", 5120, 38400, 2743))


def proj_part():
    """harmonic_project_win's warp kernel at PROJ_PART_SHAPES (the
    docstring says how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, Bp, Np, hop, Cp, Hp in PROJ_PART_SHAPES:
        nx = Np * hop
        x = r(Bp, nx) - 0.5
        cyc = torch.remainder(torch.cumsum(r(Bp, nx) * 0.02, -1), 1.0)
        hw = 2.0 + (Hp - 2.0) * r(Bp, Np)
        hwi = torch.ceil(hw).to(torch.int32)
        kl = (r(Bp, Np) * 81).to(torch.int32)
        args = (x, cyc, hw, Cp - hwi, Cp + hwi + 1, kl)
        wide_variants(
            "harmonic_project_win", f"proj_part {label} x [{Bp}, {nx}] K 80 "
            f"C {Cp}, geometry {kernels._proj_win_geometry(hop, Cp, 80)}",
            lambda rows: kernels.harmonic_project_win(
                *(t[:rows] for t in args[:3]), 80,
                *(t[:rows] for t in args[3:5]), nhop=hop, center=Cp,
                kl=args[5][:rows]),
            ("the harmonics", "the column walk"))
        del args, x, cyc
        torch.cuda.empty_cache()


def project_rows():
    """harmonic_project's row kernel at PROJECT_ROWS_SHAPES (the
    docstring says how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, R, W, H in PROJECT_ROWS_SHAPES:
        C = W // 2
        hw = (2.0 + (H - 2.0) * r(R)).to(torch.int32)
        lo, hi = (C - hw).to(torch.int32), (C + hw + 1).to(torch.int32)
        args = ((r(R, W) - 0.5) * 4.0, r(R, W) - 0.5)
        S = kernels._project_geometry(W, 80)[0]
        wide_variants(
            "harmonic_project", f"project_rows {label} [{R}, {W}] K 80, "
            f"staged columns {S}, {int(((hi - lo) > S).sum())} rows chunked",
            lambda rows: kernels.harmonic_project(
                *(t[:R if rows > 1 else 1] for t in args), 80,
                lo[:R if rows > 1 else 1], hi[:R if rows > 1 else 1]),
            ("the harmonics", "the staging"))
        del args
        torch.cuda.empty_cache()


def seg():
    """noise_mod_ola.cu's segment entry at SEG_SHAPES (the docstring says
    how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, Bs, Cs, Ns, hop, Ks in SEG_SHAPES:
        cyc = torch.remainder(torch.cumsum(r(Bs, Ns * hop) * 0.02, -1), 1.0)
        args = (cyc, r(Bs, Ns, Cs), (r(Bs, Ns, Cs, Ks) - 0.5) * 0.3,
                (r(Bs, Ns, Cs, Ks) - 0.5) * 0.3, 0.5 + r(Bs, Ns, Cs),
                r(Bs, Cs, Ns, 2 * hop) - 0.5)
        wide_variants(
            "noise_mod_ola", f"seg {label} segs [{Bs}, {Cs}, {Ns}, "
            f"{2 * hop}] Ke {Ks}",
            lambda rows: kernels.noise_mod_ola_seg(*(t[:rows] for t in args)),
            ("the envelope (ladder and lerps)", "the segment loads"))
        del args, cyc
        torch.cuda.empty_cache()


def cycles_long(shapes=CYCLES_LONG_SHAPES, name="cycles_long", top=300.0):
    """sample_cycles.cu past a 512-sample hop at CYCLES_LONG_SHAPES (or
    past 2048 at CYCLES_HOP_SHAPES, F0 to `top` Hz: the docstring says
    how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    for label, Bc, Nc, hop, fs in shapes:
        f0 = 70.0 + (top - 70.0) * torch.rand(Bc, Nc, generator=g,
                                              device=dev)
        f0[:, ::7] = 0.0
        wide_variants(
            "sample_cycles", f"{name} {label} f0 [{Bc}, {Nc}]",
            lambda rows: kernels.sample_cycles(f0[:rows], hop, fs, Nc * hop),
            ("the steps (lerp and divide)", "the output pass"))


# env_render's wide shapes: (label, B, N, nhop, C, Ke), chip_smoke.py's 20f
ENV_WIDE_SHAPES = (("Ke 9", 128, 1600, 80, 4, 9),
                   ("Ke 12", 128, 800, 480, 3, 12))


def env_wide():
    """env_render.cu's wide kernel at ENV_WIDE_SHAPES (the docstring says
    how), a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    for label, Be, Ne, hop, Ce, Ke in ENV_WIDE_SHAPES:
        cyc = torch.remainder(torch.cumsum(r(Be, Ne * hop) * 0.02, -1), 1.0)
        args = (cyc, r(Be, Ne, Ce), (r(Be, Ne, Ce, Ke) - 0.5) * 0.3,
                (r(Be, Ne, Ce, Ke) - 0.5) * 0.3, 0.5 + r(Be, Ne, Ce))
        wide_variants(
            "env_render", f"env_wide {label} cyc [{Be}, {Ne * hop}] hop "
            f"{hop} C {Ce}",
            lambda rows: kernels.env_render(*(t[:rows] for t in args)),
            ("the harmonic terms (ladder and lerps)",
             "the coefficient staging"))
        del args, cyc
        torch.cuda.empty_cache()


# viterbi_scan past 2048 states: (label, B, N, S, renorm), chip_smoke's 20d
VITERBI_WIDE_SHAPES = (("S 2049", 64, 1600, 2049, True),
                       ("S 2049 row 0", 1, 1600, 2049, True),
                       ("S 4097", 64, 1600, 4097, False),
                       ("S 4097 row 0", 1, 1600, 4097, False))


def viterbi_wide():
    """viterbi_scan at VITERBI_WIDE_SHAPES (the docstring says how), a line
    each."""
    from libllsm2_tpu_torch.ops import f0 as f0mod
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    for label, Bv, Nv, S, renorm in VITERBI_WIDE_SHAPES:
        obs = torch.round(torch.rand((Bv, Nv, S), generator=g, device=dev)
                          * -96.0) / 8.0
        obs[torch.rand(obs.shape, generator=g, device=dev) < 0.1] = \
            -float("inf")
        obs[..., 0] = -1.0
        lt = f0mod._tables(f0mod.F0Config(nbins=S - 1), dev)["lt"]
        kernels.viterbi_scan(obs, lt, renorm)
        torch.cuda.synchronize()
        ms = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            kernels.viterbi_scan(obs, lt, renorm)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
        ms.sort()
        bound = 2.0 * Bv * (Nv - 1) * S * S / 67e12 * 1e3
        print(f"viterbi_wide {label} [{Bv}, {Nv}, {S}] renorm {renorm}: "
              f"{ms[1]:.4f} ms a call (of {[round(v, 4) for v in ms]}), "
              f"bound {bound:.4f} ms (ops): {ms[1] / bound:.2f}x; geometry "
              f"{kernels._viterbi_geometry(Nv, S)}", flush=True)
        del obs, lt
        torch.cuda.empty_cache()


def env_tiles():
    """env_render.cu's wide kernel at ENV_WIDE_SHAPES built with each tile
    of 16, 32 and 64 frames forced (LLSM_ENV_TILE) and 2 or 3 blocks an SM
    (LLSM_ENV_BLOCKS), beside the library's own choice, a line each."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    tiles = (16, 32, 64)
    blocks = (2, 3)
    libs = _build.variants([("env_render", {"LLSM_ENV_TILE": h})
                            for h in tiles]
                           + [("env_render", {"LLSM_ENV_BLOCKS": n})
                              for n in blocks])
    for label, Be, Ne, hop, Ce, Ke in ENV_WIDE_SHAPES:
        cyc = torch.remainder(torch.cumsum(r(Be, Ne * hop) * 0.02, -1), 1.0)
        args = (cyc, r(Be, Ne, Ce), (r(Be, Ne, Ce, Ke) - 0.5) * 0.3,
                (r(Be, Ne, Ce, Ke) - 0.5) * 0.3, 0.5 + r(Be, Ne, Ce))
        call = lambda: kernels.env_render(*args)
        parts = [f"library {run_ms(call):.4f} ms"] + [
            f"{what} {run_ms(lambda: with_library(lib, call)):.4f} ms"
            for what, lib in zip([f"{h} frames" for h in tiles]
                                 + [f"{n} blocks an SM" for n in blocks],
                                 libs)]
        print(f"env_tiles {label} cyc [{Be}, {Ne * hop}] hop {hop} C {Ce}: "
              + "; ".join(parts) + " (a launch in a run of 20)", flush=True)
        del args, cyc
        torch.cuda.empty_cache()


# viterbi_stream_kernel's layouts tried at 20d's 64-row shapes: (S, renorm,
# [(row warps, parts, chunk)])
VITERBI_LAYOUTS = ((2049, True, ((2, 2, 256), (2, 4, 256), (2, 8, 128),
                                 (2, 8, 256), (4, 2, 256), (4, 4, 256))),
                   (4097, False, ((4, 1, 256), (4, 2, 256), (4, 4, 64),
                                  (4, 4, 128), (4, 4, 256), (2, 8, 256))))


def viterbi_layouts():
    """viterbi_scan at VITERBI_LAYOUTS: the stream kernel's route (its
    _viterbi_stream geometry) beside each layout forced by monkeypatching
    _viterbi_stream, every output equal to the route's, a line each."""
    from libllsm2_tpu_torch.ops import f0 as f0mod
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    route = kernels._viterbi_stream
    for S, renorm, layouts in VITERBI_LAYOUTS:
        obs = torch.round(torch.rand((64, 1600, S), generator=g, device=dev)
                          * -96.0) / 8.0
        obs[torch.rand(obs.shape, generator=g, device=dev) < 0.1] = \
            -float("inf")
        obs[..., 0] = -1.0
        lt = f0mod._tables(f0mod.F0Config(nbins=S - 1), dev)["lt"]
        ref = kernels.viterbi_scan(obs, lt, renorm, scores=True)
        call = lambda: kernels.viterbi_scan(obs, lt, renorm)
        parts = [f"route {route(64, S)} {run_ms(call, 3):.2f} ms"]
        _, dw, _, ra, slices, _, _, _ = route(64, S)
        J = 32 * dw
        for rw, P, kc in layouts:
            rows = 4 * ra * rw
            nbytes = max(8 * (kc * J + rows * (kc + 4)), 8 * P * rows * J)
            geo = (dw * rw * P, dw, rw, ra, slices,
                   min(-(-64 // rows), 132 // slices), kc, nbytes)
            kernels._viterbi_stream = lambda *a, geo=geo: geo
            try:
                got = kernels.viterbi_scan(obs, lt, renorm, scores=True)
                same = all(torch.equal(x, y) for x, y in zip(got, ref))
                parts.append(f"row warps {rw} parts {P} chunk {kc}: "
                             f"{run_ms(call, 3):.2f} ms, equal {same}")
            finally:
                kernels._viterbi_stream = route
        print(f"viterbi_layouts [64, 1600, {S}] renorm {renorm}: "
              + "; ".join(parts) + " (a launch in a run of 3)", flush=True)
        del obs, lt, ref
        torch.cuda.empty_cache()


def noise_floor():
    """noise_bins' device time beside a one-element fill's (the docstring
    says how), a line each, three rounds."""
    dev = torch.device("cuda")
    one = torch.empty(1, device=dev)
    for i in range(3):
        report(f"round {i}", "noise_bins", "bench shape", (B, N, NHOP + 1),
               lambda: kernels.noise_bins(0, 0, B, N, NHOP + 1, dev))
        report(f"round {i}", "a one-element fill", "launch floor", (1,),
               lambda: one.fill_(1.0))


def refine_args(nx):
    """-> (taps, keyword arguments) of the bench shape's decimated refine
    (16 kHz, hop 80, f0_floor 70: the main path's)."""
    conf = ChunkConf(f0_floor=70.0)
    D, taps, g, pass_hz = harmonics.refine_decimation(conf.nhop, nx, conf.fs,
                                                      conf.f0_ceil)
    return taps, dict(D=D, g=g, nhop=conf.nhop, fs=conf.fs,
                      halfwin_max=conf.halfwin_max,
                      rel_winsize=conf.rel_winsize, window="hanning",
                      iters=2, max_rel_dev=0.05, pass_hz=pass_hz)


def split(dirs, f0_rand):
    """Each refine_f0_dec kernel's device time of the packages in dirs,
    SPLIT_REPS calls traced by utils.profiling.device_trace, on the bench
    rows and on random x with F0 f0_rand; then the full-rate refine's
    kernels and noise_bins' (the docstring says at which shapes)."""
    from libllsm2_tpu_torch.utils import testsig
    dev = torch.device("cuda")
    rows = testsig.make_test_utterances(
        [(i, 0.05 if i < B // 2 else 0.0) for i in range(B)], duration=8.0)
    bench = tuple(torch.tensor(np.stack([r[j] for r in rows]),
                               dtype=torch.float32, device=dev)
                  for j in range(2))
    g = torch.Generator(device=dev).manual_seed(1)
    rand = (torch.randn(B, N * NHOP, generator=g, device=dev), f0_rand)
    x, f0 = bench
    shapes = (("bench rows", bench), ("F0 70-300 Hz", rand),
              ("16 bench rows", (x[:16], f0[:16])),
              ("2 bench rows", (x[:2], f0[:2])),
              ("bench row 0 alone", (x[:1], f0[:1])),
              ("160 frames of row 0", (x[:1, 800 * NHOP:960 * NHOP],
                                       f0[:1, 800:960])),
              ("rows 0-1 as one 3200-frame row",
               (x[:2].reshape(1, -1), f0[:2].reshape(1, -1))))
    rows11 = testsig.make_test_utterances(
        [(i, 0.05 if i < B // 2 else 0.0) for i in range(B)], duration=8.0,
        fs=11000.0)
    x11, f11 = (torch.tensor(np.stack([r[j] for r in rows11]),
                             dtype=torch.float32, device=dev)
                for j in range(2))
    shapes11 = (("bench rows at 11 kHz", (x11, f11)),
                ("16 rows at 11 kHz", (x11[:16], f11[:16])),
                ("2 rows at 11 kHz", (x11[:2], f11[:2])),
                ("row 0 alone at 11 kHz", (x11[:1], f11[:1])),
                ("rows 0-1 as one 3200-frame row at 11 kHz",
                 (x11[:2].reshape(1, -1), f11[:2].reshape(1, -1))))
    conf11 = ChunkConf(fs=11000.0, f0_floor=70.0)
    rkw11 = dict(nhop=conf11.nhop, fs=conf11.fs,
                 halfwin_max=conf11.halfwin_max,
                 rel_winsize=conf11.rel_winsize, f0_ceil=conf11.f0_ceil)
    for i, d in enumerate(dirs):
        pkg = load(Path(d).resolve(), f"port_split{i}")
        kmod = importlib.import_module(pkg.__name__ + ".ops.kernels")
        hmod = importlib.import_module(pkg.__name__ + ".ops.harmonics")
        for label, (xs, fs) in shapes:
            xs, fs = xs.contiguous(), fs.contiguous()
            taps, kw = refine_args(xs.shape[1])
            report(d, "refine_f0_dec", label, fs.shape,
                   lambda: kmod.refine_f0_dec(xs, fs, taps, **kw))
        for label, (xs, fs) in shapes11:
            xs, fs = xs.contiguous(), fs.contiguous()
            report(d, "refine_f0 (full rate)", label, fs.shape,
                   lambda: hmod.refine_f0(xs, fs, **rkw11))
        report(d, "noise_bins", "bench shape", (B, N, NHOP + 1),
               lambda: kmod.noise_bins(0, 0, B, N, NHOP + 1, dev))


def report(d, what, label, shape, call):
    """Each CUDA kernel's device time in SPLIT_REPS calls of call(), by its
    name in a utils.profiling.device_trace of them, printed a line."""
    from libllsm2_tpu_torch.utils import profiling
    call()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.device_trace(tmp):
            for _ in range(SPLIT_REPS):
                call()
        with open(Path(tmp) / "trace.json") as fh:
            events = json.load(fh)["traceEvents"]
    us = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            name = e["name"].replace("(anonymous namespace)::", "")
            m = re.search(r"(\w+(?:<[^()]*>)?)\(", name)
            name = m.group(1) if m else name
            us[name] = us.get(name, 0.0) + e["dur"]
    total = sum(us.values())
    parts = "; ".join(f"{name}: {v / SPLIT_REPS / 1e3:.4f} ms "
                      f"({100 * v / max(total, 1e-30):.1f}%)"
                      for name, v in sorted(us.items()))
    print(f"split {d} {what} on the {label} {tuple(shape)}: "
          f"{total / SPLIT_REPS / 1e3:.4f} ms a call of kernel time: "
          f"{parts}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    if "split" in kw:
        g = torch.Generator(device="cuda").manual_seed(0)
        f0 = 70.0 + 230.0 * torch.rand(B, N, generator=g, device="cuda")
        f0[:, ::7] = 0.0
        split(kw["split"].split(","), f0)
        return 0
    names = kw["only"].split(",") if "only" in kw else [*PASSES, "viterbi"]
    if "viterbi" in names:
        viterbi_passes()
        names.remove("viterbi")
    if "deconv_wide" in names:
        deconv_wide()
        names.remove("deconv_wide")
    if "denoise_wide" in names:
        denoise_wide()
        names.remove("denoise_wide")
    if "noise_wide" in names:
        noise_wide()
        names.remove("noise_wide")
    if "noise_long" in names:
        noise_wide(NOISE_LONG_SHAPES, "noise_long")
        names.remove("noise_long")
    if "apply_wide" in names:
        apply_wide()
        names.remove("apply_wide")
    if "seg" in names:
        seg()
        names.remove("seg")
    if "cycles_long" in names:
        cycles_long()
        names.remove("cycles_long")
    if "cycles_hop" in names:
        cycles_long(CYCLES_HOP_SHAPES, "cycles_hop", 1000.0)
        names.remove("cycles_hop")
    if "proj_part" in names:
        proj_part()
        names.remove("proj_part")
    if "project_rows" in names:
        project_rows()
        names.remove("project_rows")
    if "env_wide" in names:
        env_wide()
        names.remove("env_wide")
    if "noise_floor" in names:
        noise_floor()
        names.remove("noise_floor")
    if "env_tiles" in names:
        env_tiles()
        names.remove("env_tiles")
    if "viterbi_wide" in names:
        viterbi_wide()
        names.remove("viterbi_wide")
    if "viterbi_layouts" in names:
        viterbi_layouts()
        names.remove("viterbi_layouts")
    if not names:
        return 0
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
    taps, rk = refine_args(N * NHOP)
    f0_r = torch.empty_like(f0)
    refine = kernels._refine_launch_args(x, f0, taps, f0_r, **rk)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {
        "noise_mod_ola": lambda fn: fn(
            cyc.data_ptr(), edc.data_ptr(), ar.data_ptr(), ai.data_ptr(),
            base.data_ptr(), re.data_ptr(), im.data_ptr(), 0,
            gain.data_ptr(), ctypes.addressof(ranges), None, y.data_ptr(),
            B, N, NHOP, C, KE, 0, 0, stream),
        "deconv_full": lambda fn: fn(
            ampl.data_ptr(), phse.data_ptr(), cyc.data_ptr(), hw.data_ptr(),
            mask.data_ptr(), o_a.data_ptr(), o_b.data_ptr(), None, B, N, K,
            D, NHOP, 8, 0, 64, 0, stream),
        "harmonic_project_mxu": lambda fn: fn(
            x.data_ptr(), cyc.data_ptr(), hw_p.data_ptr(), p_re.data_ptr(),
            p_im.data_ptr(), p_ws.data_ptr(), p_xs.data_ptr(), B, N * NHOP,
            N, K, NHOP, 6 * NHOP, 0.5, -0.5, 0.0, 0.0, stream),
        "sample_cycles": lambda fn: fn(
            f0.data_ptr(), cyc_o.data_ptr(), words.data_ptr(), None, 0, B,
            N, NHOP, N * NHOP, 16000.0, stream),
        "refine_f0": lambda fn: fn(*refine),
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
