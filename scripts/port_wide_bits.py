"""The wide paths of deconv_full and denoise_stats (the full-band
deconvolution and the track denoiser's pass A past the first kernels'
limits), noise_mod_ola and denoise_apply (past hop 256, 8 bands or 8
envelope harmonics; past K 128) of this checkout against another
checkout's (e.g. the parent
commit unpacked under build/archive/), both loaded into one process on
one card, on uniform random inputs from seed 0: every output bit for
bit at the full-band shapes of chip_smoke.py's phase 20e ([128, 1600,
600] D 11 and [128, 4000, 200] D 26; 13 + 7 and 33 + 17 taps), 20a's K
160, 20c's wide taps and edge shapes (D 57 / 128, K 1, N 5, 101 + 51
taps, a one-tap probe), both output forms of each; at full batch a row
alone against its row of the batch, and each side's time (median of 10,
CUDA events, twice).  Then this checkout's wide paths forced onto
shapes the first kernels take, by monkeypatching the geometry functions
with whole tuples: the deconvolution at output tiles of 64-8 frames,
chunks of 2-64 columns and tap-build tiles of 64-8 frames with the
quadrature field staged or not, every output the first kernel's bits;
the denoiser with one chunk walked 32 columns at a time, every output
the first kernel's bits but pp (the wide path's r_inc products round
otherwise; its largest difference printed).  what=noise: noise_mod_ola
at phase 20b's, 20g's and 20h's gains [128, 800, 481], [128, 400, 961]
and [128, 160, 2401] (4 bands, 4 envelope harmonics, one draw for the
batch, and a draw a row; rows 0, 1 and 64 alone against their rows of
the batch), the card tests' (480, 9, 9),
(80, 9, 9) and (882, 4, 12), odd hops (481, 333), a row of 5 frames,
fewer than a block's; then the wide kernel forced onto hop 80, 4 bands
and 4 harmonics (frames and threads a block by monkeypatching
_noise_geometry) against the first kernel, the other checkout's wide
kernel first (where it differs, this one must be no further off; the
largest difference printed).  what=apply: denoise_apply at 20e's [128,
1600, 600] and [128, 4000, 200] and 20a's K 160, spectral and polar, K
129 and 203, one row of 301 frames; then the wide kernel forced onto K
100, 127 and 128 (warps, blocks, pairs a warp and staging by
monkeypatching _apply_geometry) against the first kernel's scalar
layout, the other checkout's wide kernel first (its source built with
nvcc into build/dev/ with its C entry's K > 128 test made K > 0: where it
differs from the first kernel, this one must equal it and be no further
off; the largest difference printed).  what=seg: noise_mod_ola_seg (the
noise_idft="fft" path) on its call in chip_smoke.py's phase 16c (the
library default's analysis of the bench rows, synthesized with
noise_idft="fft"), at 20f's 9 channels of 9 envelope harmonics, hops 55,
160, 480 and 882 (the scalar path and the 16-byte one), Ke 0, 1, 8, 9, 12
and 16, 9 channels, N 5; rows 0, 1 and 64 alone against their rows of the
batch, and each side's time at 16c's and 20f's shapes.  what=cycles:
sample_cycles past a 512-sample hop (the long-hop kernel) at hops 600,
882 (44.1 kHz), 960 and 2048 and at 513, 1024 and 1025 (the lane counts'
edges), 128 rows of 8 s, on F0 70-300 Hz with every 7th frame unvoiced
and, at hops 882 and 960, on the bench rows' F0 at a 20 ms hop; each also
with base= and start= (start 37, -2 (a first shard's halo) and 17400 /
6950, whose hops cross 2^24 samples at hop 960 / 2400); past a 2048-sample
hop (the hop kernel) at hop 2400 on random F0 and on the bench rows' F0
at a 50 ms hop (phase 20h's analysis call), 2205 (44.1 kHz), 4000 (16
kHz), 19200 (96 kHz) and 60000 (96 kHz at 625 ms: a hop's steps past
the block's shared memory, evaluated again in the output pass); rows 0, 1
and 64 alone against their rows of the batch, and each side's time at
hops 960, 2048, 2400, 19200 and 60000.
what=noise also forces the long noise kernel (where the wide kernel's
16-frame block would not leave room for two an SM) onto 20b's two shapes
and (480, 9, 9) with chunks of 64, 48, 16 and 32 slots, against the other
side's wide kernel.  what=proj:
harmonic_project_win at shapes the 16-frame tile takes (16 kHz's main
and envelope passes, K 160, 48 kHz at 10 ms, full band's K 600) and
where the warp kernel runs (20g, 48 kHz at 20 ms with f0_floor 40, 96 kHz
at 12.5 ms, 20h at K 80 and 160, 96 kHz at 200 ms), rows 0 / 1 / 64
alone, and this side's warp kernel forced onto every case in each of its
layouts (chunks of 32, 96, 512, 1792 and 2048 columns), each against the
other side's output there (its 16-frame tile, or its own layout past
it); harmonic_project at K 1, 4, 12, 24, 44, 72 and 80 on
[20000, 631] and at K 80 on 96 kHz / 200 ms frames [5120, 38400], its
row kernel forced onto 256, 512, 768 and 6144 staged columns at 2 and 5
groups of harmonics a pass.  what=env: env_render past 8 envelope
harmonics (its wide kernel) at chip_smoke.py's 20f shapes ([128, 1600]
frames at hop 80, 4 channels of 9 harmonics; [128, 800] at hop 480, 3 of
12), the card tests' edge shapes, 1 and 9 channels, 16 and 24 harmonics,
40 channels of 21 (the most the wrapper admits: 16-frame tiles), hops 55
and 333 (single loads), cut renders, one partial tile and a track off the
16-byte boundary; rows 0 / 1 / 64 alone and each side's time at 20f's
shapes.  what=viterbi: viterbi_scan past 2048 states at chip_smoke.py's
20d shapes ([64, 1600, 2049] renormalized, [64, 1600, 4097] not, each
row 0 alone too), 5 rows, 2 frames, 3200 frames, 8193 states on 40
frames, 29024 on 3 (a row, and 64 rows), 2050-2055 states and one
frame, on scores in eighths with -inf entries under an lt in eighths with
-inf off its diagonal, then the F0 tracker's own call at nbins 2048 on
the first 64 bench rows: paths and last scores; each side's time at 20d's
two shapes.  Prints a
line a case and, last, the cases that failed; exits 1 if any did.
Imports no jax:

    python3 scripts/port_wide_bits.py OTHER_DIR
        [what=deconv,denoise,noise,apply,seg,cycles,proj,env,viterbi]
"""
import ctypes
import importlib
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from port_harness import load

ROOT = Path(__file__).resolve().parents[1]

DECONV_CASES = (("48k", 128, 1600, 600, 11, 240),
                ("16k2ms", 128, 4000, 200, 26, 32),
                ("small", 3, 301, 342, 16, 96),
                ("D57", 2, 300, 80, 57, 80),
                ("D128", 2, 300, 80, 128, 16),
                ("D128f", 2, 300, 120, 128, 480),
                ("K1", 2, 70, 1, 128, 480))
# (FT, KC, TT, stage) forced onto K 80, D 7, hop 80
DECONV_FORCED = ((64, 16, 64, 1), (32, 24, 32, 0), (16, 18, 16, 1),
                 (8, 64, 8, 0), (64, 2, 64, 0), (64, 64, 8, 1))
DENOISE_CASES = (("48k", 128, 1600, 600, 13, 7),
                 ("16k2ms", 128, 4000, 200, 33, 17),
                 ("20a", 128, 1600, 160, 13, 7),
                 ("20c33", 128, 1600, 80, 33, 17),
                 ("20c41", 128, 1600, 80, 41, 21),
                 ("big", 2, 301, 200, 101, 51),
                 ("tiny", 2, 5, 150, 13, 17),
                 ("h0", 2, 130, 140, 13, 1))
DENOISE_FORCED = ((80, 13, 7), (128, 13, 7), (37, 31, 15), (80, 3, 31))
# (label, B, N, nhop, C, Ke, per-row draws); bands of equal width up to
# fs / 2 (fs = 100 nhop) but for 20b, whose are its channel edges'
NOISE_CASES = (("20b", 128, 800, 480, 4, 4, False),
               ("20b draw a row", 128, 800, 480, 4, 4, True),
               ("20g", 128, 400, 960, 4, 4, False),
               ("20g draw a row", 128, 400, 960, 4, 4, True),
               ("20h", 128, 160, 2400, 4, 4, False),
               ("20h draw a row", 128, 160, 2400, 4, 4, True),
               ("480 9 9", 2, 47, 480, 9, 9, False),
               ("80 9 9", 2, 301, 80, 9, 9, True),
               ("882 4 12", 2, 31, 882, 4, 12, False),
               ("odd 481", 2, 130, 481, 4, 4, True),
               ("odd 333", 3, 77, 333, 5, 3, False),
               ("5 frames", 2, 5, 480, 4, 4, False))
NOISE_20B_EDGES = (0.0, 3000.0, 6000.0, 9000.0, 24000.0)   # 20b, 20g, 20h
# the wide kernels forced onto hop 80, C 4, Ke 4: frames a block (the
# other checkout's 16, 8, 4; this one's 16 with 64, 32 or 96 threads)
NOISE_FORCED_OTHER = (16, 8, 4)
NOISE_FORCED = ((16, 64), (16, 32), (16, 96))
# the long kernel forced onto the first shapes: (frames a block, slots a
# chunk)
NOISE_LONG = ((16, 64), (16, 48), (16, 16), (16, 32))
# harmonic_project_win: (label, rows of x, frames, hop, center C, K, x rows a
# cycle row, halfwidths' top or None for C - 1): shapes the 16-frame tile
# takes (16 kHz's main and envelope passes, K 160: groups of 80, 48 kHz at
# 10 ms, full band's K 600) and the warp kernel's (20g: 48 kHz at 20 ms with
# f0_floor 70, hop 960, C 1920; 48 kHz at 20 ms with f0_floor 40, C 2880;
# 96 kHz at 12.5 ms; 20h: hop 2400, C 2400; K 160 there; 96 kHz at 200 ms,
# hop and C 19200, on 32 rows)
PROJ_CASES = (("16k main", 128, 1600, 80, 480, 80, 1, None),
              ("16k envelope", 512, 1600, 20, 120, 4, 4, None),
              ("K 160", 128, 1600, 80, 480, 160, 1, None),
              ("48k 10 ms", 128, 800, 480, 1920, 80, 1, 1372),
              ("48k K 600", 128, 1600, 240, 2400, 600, 1, None),
              ("20g", 128, 400, 960, 1920, 80, 1, 1372),
              ("48k 20 ms", 128, 400, 960, 2880, 80, 1, None),
              ("96k 12.5 ms", 128, 640, 1200, 4800, 80, 1, None),
              ("20h", 128, 160, 2400, 2400, 80, 1, 1372),
              ("20h K 160", 128, 160, 2400, 2400, 160, 1, 1372),
              ("96k 200 ms", 32, 40, 19200, 19200, 80, 1, 4800))
# the warp kernel's layouts (frames a block 0, columns a chunk, bytes)
# forced onto every case: chunks of 32, 96, 512 (the route's at K <= 8),
# 1792 (the route's past it) and 2048
PROJ_FORCED = ((0, 32, 1024), (0, 96, 3072), (0, 512, 16384),
               (0, 1792, 57344), (0, 2048, 65536))
# harmonic_project's row kernel: staged columns a block forced, each at 1, 2
# and 5 groups a pass
PROJECT_FORCED = (256, 512, 768, 6144)
# (label, B, N, K)
APPLY_CASES = (("20e 48k", 128, 1600, 600), ("20e 16k2ms", 128, 4000, 200),
               ("20a", 128, 1600, 160), ("K129", 2, 301, 129),
               ("K203", 2, 301, 203), ("B1", 1, 301, 160))
# (warps, pairs a warp, stage) forced onto K 100, 127, 128
APPLY_FORCED = ((1, 3, 1), (2, 1, 1), (4, 7, 1), (4, 2, 0))


def cuda_ms(fn, reps=10):
    """Median of reps timed calls (CUDA events), after one untimed."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def equal(a, b):
    return [torch.equal(x, y) for x, y in zip(a, b)]


def deconv(kt, ko, r, bad):
    """The wide deconvolution against the other side's, then forced onto
    the first kernel's shape against the first kernel."""
    def inputs(B, N, K, D, hop):
        mask = (r(B, N, K) > 0.1).float()
        ampl, phse = r(B, N, K) * mask, (6.0 * r(B, N, K) - 3.0) * mask
        cyc = torch.remainder(torch.cumsum(r(B, N * hop) * 0.02, -1), 1.0)
        return ampl, phse, cyc, 30.0 + r(B, N) * (D - 1) * hop, mask

    for label, B, N, K, D, hop in DECONV_CASES:
        args = inputs(B, N, K, D, hop)
        geo = kt._deconv_geometry(D, K, 2 * hop // 8)
        for polar in (False, True):
            kw = dict(return_complex=not polar)
            ok = all(equal(kt.deconv_full(*args, D, hop, 8, **kw),
                           ko.deconv_full(*args, D, hop, 8, **kw)))
            print(f"deconv {label} polar {polar} geometry {geo}: equal "
                  f"{ok}", flush=True)
            if not ok:
                bad.append(("deconv", label, polar))
        if B > 3:
            row = kt.deconv_full(*(a[1:2] for a in args), D, hop, 8)
            full = kt.deconv_full(*args, D, hop, 8)
            ok = all(torch.equal(x[0], y[1]) for x, y in zip(row, full))
            print(f"deconv {label} row alone equal {ok}", flush=True)
            if not ok:
                bad.append(("deconv row alone", label))
            for _ in range(2):
                tt = cuda_ms(lambda: kt.deconv_full(*args, D, hop, 8))
                to = cuda_ms(lambda: ko.deconv_full(*args, D, hop, 8))
                print(f"deconv {label} ms this {tt:.4f} other {to:.4f}",
                      flush=True)
        del args
        torch.cuda.empty_cache()
    args = inputs(2, 300, 80, 7, 80)
    keep = kt._deconv_geometry
    for polar in (False, True):
        kw = dict(return_complex=not polar)
        ref = kt.deconv_full(*args, 7, 80, 8, **kw)
        for FT, KC, TT, stage in DECONV_FORCED:
            kt._deconv_geometry = lambda *a, g=(FT, KC, 0, 0, TT, stage): g
            try:
                got = kt.deconv_full(*args, 7, 80, 8, **kw)
            finally:
                kt._deconv_geometry = keep
            ok = all(equal(got, ref))
            print(f"deconv forced (FT, KC, TT, stage) {(FT, KC, TT, stage)} "
                  f"polar {polar}: the first kernel's bits {ok}", flush=True)
            if not ok:
                bad.append(("deconv forced", FT, KC, TT, stage, polar))


def denoise(kt, ko, layer0, r, bad):
    """The wide denoiser against the other side's, then forced onto the
    first kernel's shapes against the first kernel."""
    def inputs(B, N, K, ci):
        a = r(B, N, K) - 0.5 if ci else r(B, N, K)
        return (a, (r(B, N, K) - 0.5) * 6.0, r(B, N) - 0.5,
                (r(B, N, K) > 0.1).float(), (r(B, N) > 0.3).float())

    for label, B, N, K, n1, n2 in DENOISE_CASES:
        taps = tuple(layer0._hann_taps(n1)), tuple(layer0._hann_taps(n2))
        for ci in (False, True):
            args = inputs(B, N, K, ci)
            got = kt.denoise_stats(*args, *taps, complex_input=ci)
            eq = equal(got, ko.denoise_stats(*args, *taps, complex_input=ci))
            print(f"denoise {label} complex_input {ci} geometry "
                  f"{kt._denoise_geometry(K, n1, n2)}: equal {all(eq)} {eq}",
                  flush=True)
            if not all(eq):
                bad.append(("denoise", label, ci))
            if B > 2 and not ci:
                row = kt.denoise_stats(*(a[1:2] for a in args), *taps)
                ok = all(torch.equal(x[0], y[1]) for x, y in zip(row, got))
                print(f"denoise {label} row alone equal {ok}", flush=True)
                if not ok:
                    bad.append(("denoise row alone", label))
                for _ in range(2):
                    tt = cuda_ms(lambda: kt.denoise_stats(*args, *taps))
                    to = cuda_ms(lambda: ko.denoise_stats(*args, *taps))
                    print(f"denoise {label} ms this {tt:.4f} other "
                          f"{to:.4f}", flush=True)
            del args, got
            torch.cuda.empty_cache()
    keep = kt._denoise_geometry
    for K, n1, n2 in DENOISE_FORCED:
        taps = tuple(layer0._hann_taps(n1)), tuple(layer0._hann_taps(n2))
        kc = -(-K // 16) * 16
        for ci in (False, True):
            args = inputs(2, 301, K, ci)
            ref = kt.denoise_stats(*args, *taps, complex_input=ci)
            kt._denoise_geometry = lambda *a, g=(kc, 32, 0, 0): g
            try:
                got = kt.denoise_stats(*args, *taps, complex_input=ci)
            finally:
                kt._denoise_geometry = keep
            eq = equal(got, ref)
            d = float((got[0] - ref[0]).abs().max())
            print(f"denoise forced K {K} {n1} + {n2} complex_input {ci}: "
                  f"the first kernel's bits {eq}; pp within {d:.3e} of it",
                  flush=True)
            if not all(eq[1:]):
                bad.append(("denoise forced", K, n1, n2, ci))


def noise(kt, ko, r, bad):
    """The wide noise kernel against the other side's, then forced onto
    the first kernel's shape against the first kernel."""
    def inputs(B, N, nhop, C, Ke, per_row, seed=None):
        nbin = nhop + 1
        cyc = torch.remainder(torch.cumsum(r(B, N * nhop) * 0.02, -1), 1.0)
        draw = lambda: (torch.randn(B, N, nbin, device="cuda") if per_row
                        else torch.randn(1, N, nbin, device="cuda").expand(
                            B, N, nbin))
        return (cyc, r(B, N, C), r(B, N, C, Ke) - 0.5, r(B, N, C, Ke) - 0.5,
                r(B, N, C) + 0.5, draw(), draw(), r(B, N, nbin))

    def bands_of(nhop, C, label):
        at48 = label[:3] in ("20b", "20g", "20h")
        fs = 48000.0 if at48 else 100.0 * nhop
        edges = NOISE_20B_EDGES if at48 else tuple(
            fs / 2 * c / C for c in range(C)) + (fs / 2 + 1.0,)
        return kt.band_ranges(nhop + 1, fs, edges)

    torch.manual_seed(1)
    for label, B, N, nhop, C, Ke, per_row in NOISE_CASES:
        args = inputs(B, N, nhop, C, Ke, per_row)
        bands = bands_of(nhop, C, label)
        got = kt.noise_mod_ola(*args, bands)
        ok = torch.equal(got, ko.noise_mod_ola(*args, bands))
        print(f"noise {label} geometry "
              f"{kt._noise_geometry(nhop, C, Ke, bands)}: equal {ok}",
              flush=True)
        if not ok:
            bad.append(("noise", label))
        if B > 3:
            for i in (0, 1, 64) if B > 64 else (1,):
                row = kt.noise_mod_ola(*(a[i:i + 1] for a in args), bands)
                ok = torch.equal(row[0], got[i])
                print(f"noise {label} row {i} alone equal {ok}", flush=True)
                if not ok:
                    bad.append(("noise row alone", label, i))
            if not per_row:
                for _ in range(2):
                    tt = cuda_ms(lambda: kt.noise_mod_ola(*args, bands))
                    to = cuda_ms(lambda: ko.noise_mod_ola(*args, bands))
                    print(f"noise {label} ms this {tt:.4f} other {to:.4f}",
                          flush=True)
        del args, got
        torch.cuda.empty_cache()
    args = inputs(2, 301, 80, 4, 4, True)
    bands = bands_of(80, 4, "")
    ref = kt.noise_mod_ola(*args, bands)
    assert kt._noise_geometry(80, 4, 4, bands)[0] == 0
    keep_o, keep_t = ko._noise_geometry, kt._noise_geometry
    worst = 0.0
    for F in NOISE_FORCED_OTHER:
        ko._noise_geometry = lambda *a, F=F: (F,) + keep_t(*a)[1:3] + (64,
                                                                       0)
        try:
            got = ko.noise_mod_ola(*args, bands)
        finally:
            ko._noise_geometry = keep_o
        d = float((got - ref).abs().max())
        worst = max(worst, d)
        print(f"noise forced, the other checkout's wide kernel at {F} "
              f"frames: the first kernel's bits {torch.equal(got, ref)}; "
              f"within {d:.3e}", flush=True)
    for F, threads in NOISE_FORCED:
        kt._noise_geometry = lambda *a, g=(F, threads): (
            g[0], *keep_t(*a)[1:3], g[1], 0)
        try:
            got = kt.noise_mod_ola(*args, bands)
        finally:
            kt._noise_geometry = keep_t
        d = float((got - ref).abs().max())
        ok = torch.equal(got, ref)
        print(f"noise forced (frames, threads) {(F, threads)}: the first "
              f"kernel's bits {ok}; within {d:.3e}", flush=True)
        if not ok and d > worst:
            bad.append(("noise forced", F, threads))
    # the long kernel (where the wide kernel's block would hold fewer than
    # 16 frames) forced onto shapes the other side's wide kernel takes at
    # 16 frames: its bits
    for label, B, N, nhop, C, Ke, per_row in (NOISE_CASES[:2]
                                              + NOISE_CASES[6:7]):
        args = inputs(min(B, 8), N, nhop, C, Ke, per_row)
        bands = bands_of(nhop, C, label)
        ref = ko.noise_mod_ola(*args, bands)
        geo = keep_t(nhop, C, Ke, bands)
        for F, chunk in NOISE_LONG:
            nbytes = (16 * chunk * (F + 1) + 12 * (F - 1) * 4 * 128
                      + 8 * F * C * (Ke + 1) + 20 * C)
            kt._noise_geometry = lambda *a, g=(F, geo[1], nbytes, 128,
                                               chunk): g
            try:
                got = kt.noise_mod_ola(*args, bands)
            finally:
                kt._noise_geometry = keep_t
            ok = torch.equal(got, ref)
            print(f"noise {label} long kernel forced (frames, slots a "
                  f"chunk) {(F, chunk)}: the other side's bits {ok}",
                  flush=True)
            if not ok:
                bad.append(("noise long forced", label, F, chunk))
        del args, ref
        torch.cuda.empty_cache()


def other_apply_wide(other: Path, build):
    """The other checkout's denoise_apply.cu with its wide kernel launched
    at every K (its C entry's K > 128 test made K > 0), built by nvcc
    (build: this checkout's ops._build) -> its llsm_denoise_apply, bound
    with the other checkout's argument types."""
    csrc = other / "libllsm2_tpu_torch" / "csrc"
    src = (csrc / "denoise_apply.cu").read_text()
    test = "if (K > 8 * kLanes) {"
    if src.count(test) != 1:
        sys.exit("port_wide_bits.py: the other checkout's denoise_apply.cu "
                 "has no single wide-kernel test to force")
    out = ROOT / "build" / "dev"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "apply_wide_other.cu", out / "apply_wide_other.so"
    cu.write_text(src.replace(test, "if (K > 0) {"))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc),
                    "-shared", "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = ctypes.CDLL(str(so)).llsm_denoise_apply
    fn.argtypes = (P,) * 11 + (I, I, I, ctypes.c_float, I, P)
    fn.restype = I
    return fn


def apply(kt, ko, r, bad, other, build):
    """The wide denoise_apply against the other side's, then forced onto
    the first kernel's shapes against the first kernel."""
    def inputs(B, N, K):
        cre, cim = r(B, N, K) - 0.5, r(B, N, K) - 0.5
        return (cre, cim, cre + 0.3 * (r(B, N, K) - 0.5),
                cim + 0.3 * (r(B, N, K) - 0.5), r(B, N),
                (r(B, N, K) > 0.1).float(), r(B, N) > 0.2,
                0.05 * r(B, K), r(B, K))

    for label, B, N, K in APPLY_CASES:
        args = inputs(B, N, K)
        for spectral in (True, False):
            got = kt.denoise_apply(*args, 8.0, spectral=spectral)
            eq = equal(got, ko.denoise_apply(*args, 8.0, spectral=spectral))
            print(f"apply {label} spectral {spectral} geometry "
                  f"{kt._apply_geometry(K, B * N)}: equal {all(eq)} {eq}",
                  flush=True)
            if not all(eq):
                bad.append(("apply", label, spectral))
            if B > 3:
                row = kt.denoise_apply(*(a[1:2] for a in args), 8.0,
                                       spectral=spectral)
                ok = all(torch.equal(x[0], y[1]) for x, y in zip(row, got))
                print(f"apply {label} spectral {spectral} row alone equal "
                      f"{ok}", flush=True)
                if not ok:
                    bad.append(("apply row alone", label, spectral))
            if B > 3 and spectral:
                for _ in range(2):
                    tt = cuda_ms(lambda: kt.denoise_apply(*args, 8.0,
                                                          spectral=True))
                    to = cuda_ms(lambda: ko.denoise_apply(*args, 8.0,
                                                          spectral=True))
                    print(f"apply {label} ms this {tt:.4f} other {to:.4f}",
                          flush=True)
            del got
        del args
        torch.cuda.empty_cache()
    keep = kt._apply_geometry
    wide_other = other_apply_wide(other, build)
    for K in (100, 127, 128):
        args = inputs(2, 301, K)
        pairs = 301
        for spectral in (True, False):
            ref = kt.denoise_apply(*args, 8.0, spectral=spectral)
            kind = torch.complex64 if spectral else torch.float32
            theirs = [torch.empty((2, 301, K), dtype=kind, device="cuda")
                      for _ in range(2)]
            rc = wide_other(*(t.data_ptr() for t in (args[7], args[8])
                              + args[:6] + (args[6],) + tuple(theirs)),
                            2, 301, K, 8.0, int(not spectral),
                            torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"the other wide kernel: cudaError {rc}")
            d_other = max(float((x - y).abs().max())
                          for x, y in zip(theirs, ref))
            print(f"apply forced K {K} spectral {spectral}, the other "
                  f"checkout's wide kernel: the first kernel's bits "
                  f"{all(equal(theirs, ref))}; within {d_other:.3e}",
                  flush=True)
            for W, per, stage in APPLY_FORCED:
                odd16 = lambda n: (n + 15) // 32 * 32 + 16
                nbytes = stage * W * 4 * (10 * odd16(K + 3) + 4 * odd16(K))
                g = (W, -(-pairs // (W * per)), per, stage, nbytes)
                kt._apply_geometry = lambda *a, g=g: g
                try:
                    got = kt.denoise_apply(*args, 8.0, spectral=spectral)
                finally:
                    kt._apply_geometry = keep
                eq = equal(got, ref)
                same = all(equal(got, theirs))
                d = max(float((x - y).abs().max()) for x, y in zip(got, ref))
                print(f"apply forced K {K} spectral {spectral} geometry {g}: "
                      f"the first kernel's bits {all(eq)}; within {d:.3e}; "
                      f"the other wide kernel's bits {same}", flush=True)
                if not all(eq) and not (same and d <= d_other):
                    bad.append(("apply forced", K, spectral, g))


# (label, B, C, N, nhop, Ke)
SEG_CASES = (("C 9 Ke 9", 128, 9, 1600, 80, 9),
             ("hop 55", 2, 4, 301, 55, 4), ("hop 160 C 3", 2, 3, 47, 160, 4),
             ("hop 480", 2, 4, 130, 480, 4),
             ("hop 882 Ke 12", 2, 4, 31, 882, 12),
             ("Ke 0", 2, 3, 47, 80, 0), ("Ke 1 C 1", 2, 1, 301, 80, 1),
             ("Ke 8", 2, 5, 77, 80, 8), ("Ke 16", 2, 2, 50, 80, 16),
             ("Ke 9 hop 55", 2, 9, 61, 55, 9), ("N 5", 2, 4, 5, 80, 4))


def proj_geometry(kmod, nhop, C, K):
    """kmod._proj_win_geometry at (nhop, C, K), or (nhop, C) in a checkout
    whose geometry does not take K."""
    try:
        return kmod._proj_win_geometry(nhop, C, K)
    except TypeError:
        return kmod._proj_win_geometry(nhop, C)


def proj(kt, ko, r, bad):
    """harmonic_project_win against the other side's at PROJ_CASES (rows
    0, 1 and 64 alone too, where a case has 65 rows), then this side's
    warp kernel forced onto every case in each layout of PROJ_FORCED,
    against the other side's output (its 16-frame tile, or past it its own
    layout); harmonic_project at K 1, 4, 12, 24, 44, 72 and 80 on
    [20000, 631] and at K 80 on 96 kHz / 200 ms frames ([5120, 38400],
    live spans to 9601), its row kernel forced onto PROJECT_FORCED's
    staged columns at 2 and 5 groups a pass."""
    for label, B, N, nhop, C, K, rep, H in PROJ_CASES:
        nx = N * nhop
        x = r(B, nx) - 0.5
        cyc = torch.remainder(torch.cumsum(r(B // rep, nx) * 0.02, -1), 1.0)
        hw = 2.0 + ((H or C - 1) - 2.0) * r(B, N)
        hw_int = torch.ceil(hw).to(torch.int32)
        kl = (r(B, N) * (K + 1)).to(torch.int32)
        args = (x, cyc, hw, K, C - hw_int, C + hw_int + 1)
        kw = dict(nhop=nhop, center=C, kl=kl)
        got = kt.harmonic_project_win(*args, **kw)
        ok = all(equal(got, ko.harmonic_project_win(*args, **kw)))
        geo, other = (proj_geometry(m, nhop, C, K) for m in (kt, ko))
        print(f"proj {label} x {tuple(x.shape)} K {K} geometry {geo}, "
              f"other's {other}: equal {ok}", flush=True)
        if not ok:
            bad.append(("proj", label))
        if rep == 1 and B > 64:
            for row in (0, 1, 64):
                one = kt.harmonic_project_win(
                    *(a[row:row + 1] if torch.is_tensor(a) else a
                      for a in args), nhop=nhop, center=C,
                    kl=kl[row:row + 1])
                ok = all(torch.equal(o[0], g[row]) for o, g in zip(one, got))
                print(f"proj {label} row {row} alone equal {ok}", flush=True)
                if not ok:
                    bad.append(("proj row alone", label, row))
        keep = kt._proj_win_geometry
        for forced in PROJ_FORCED:
            kt._proj_win_geometry = lambda *a, g=forced: g
            try:
                one = kt.harmonic_project_win(*args, **kw)
            finally:
                kt._proj_win_geometry = keep
            ok = all(equal(one, got))
            print(f"proj {label} forced {forced}: the other side's bits "
                  f"{ok}", flush=True)
            if not ok:
                bad.append(("proj forced", label, forced))
            del one
        if label in ("16k main", "20g", "20h", "96k 200 ms"):
            for _ in range(2):
                tt = cuda_ms(lambda: kt.harmonic_project_win(*args, **kw))
                to = cuda_ms(lambda: ko.harmonic_project_win(*args, **kw))
                print(f"proj {label} ms this {tt:.4f} other {to:.4f}",
                      flush=True)
        del x, cyc, args, got
        torch.cuda.empty_cache()
    for R, W, H in ((20000, 631, None), (5120, 38400, 4800)):
        dc = (r(R, W) - 0.5) * 4.0
        if H is None:
            lo = (r(R) * (W // 3)).to(torch.int32)
            hi = (W // 2 + r(R) * (W // 2)).to(torch.int32)
        else:
            hwr = (2.0 + (H - 2.0) * r(R)).to(torch.int32)
            lo, hi = W // 2 - hwr, W // 2 + hwr + 1
        col = torch.arange(W, device="cuda")[None, :]
        xw = (r(R, W) - 0.5) * ((col >= lo[:, None]) & (col < hi[:, None]))
        del col
        keep = kt._project_geometry
        # K 12, 24, 44, 72, 80: 2, 3, 6, 9, 10 groups of 8 harmonics; each K
        # at the route's geometry and forced to 2 and 5 groups a pass
        for K in ((1, 4, 12, 24, 44, 72, 80) if H is None else (80,)):
            ref = ko.harmonic_project(dc, xw, K, lo, hi)
            got = kt.harmonic_project(dc, xw, K, lo, hi)
            ok = all(equal(got, ref))
            print(f"project [{R}, {W}] K {K} geometry "
                  f"{kt._project_geometry(W, K)}, other's "
                  f"{ko._project_geometry(W, K)}: equal {ok}", flush=True)
            if not ok:
                bad.append(("project", W, K))
            S = keep(W, K)[0]
            for G in ((2, 5) if K > 8 else ()):
                kt._project_geometry = lambda *a, g=(S, 8 * S, G): g
                try:
                    ok = all(equal(kt.harmonic_project(dc, xw, K, lo, hi),
                                   ref))
                finally:
                    kt._project_geometry = keep
                print(f"project [{R}, {W}] K {K} forced {G} groups a pass: "
                      f"equal {ok}", flush=True)
                if not ok:
                    bad.append(("project groups", W, K, G))
            del ref
        for S, G in ((S, G) for S in PROJECT_FORCED for G in (2, 5)):
            kt._project_geometry = lambda *a, g=(S, 8 * S, G): g
            try:
                one = kt.harmonic_project(dc, xw, 80, lo, hi)
            finally:
                kt._project_geometry = keep
            ok = all(equal(one, got))
            print(f"project [{R}, {W}] K 80 forced {S} staged columns, {G} "
                  f"groups a pass: the other side's bits {ok}", flush=True)
            if not ok:
                bad.append(("project forced", W, S, G))
        if H is not None:
            for _ in range(2):
                tt = cuda_ms(lambda: kt.harmonic_project(dc, xw, 80, lo, hi))
                to = cuda_ms(lambda: ko.harmonic_project(dc, xw, 80, lo, hi))
                print(f"project [{R}, {W}] K 80 ms this {tt:.4f} other "
                      f"{to:.4f}", flush=True)
        del dc, xw, got
        torch.cuda.empty_cache()


def rows_alone(label, fn, args, got, bad, what):
    """Rows 0, 1 and 64 each alone (a batch of one) against their rows of
    the batch's output got."""
    for row in (0, 1, 64):
        one = fn(*(a[row:row + 1] if torch.is_tensor(a) else a
                   for a in args))
        ok = torch.equal(one[0], got[row])
        print(f"{what} {label} row {row} alone equal {ok}", flush=True)
        if not ok:
            bad.append((f"{what} row alone", label, row))


def seg(kt, ko, r, bad):
    """noise_mod_ola_seg against the other side's on 16c's call and on
    random inputs at SEG_CASES."""
    import dataclasses
    import chip_smoke
    pkg = sys.modules["p_this"]
    layer0 = importlib.import_module("p_this.models.layer0")
    x, f0 = chip_smoke.fixtures(torch, torch.device("cuda"))[:2]
    opt = pkg.create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(pkg.create_soptions(), use_pallas=True,
                               noise_idft="fft")
    chunk = layer0._analyze(opt, x, f0)
    calls, _ = chip_smoke.capture_kernel_inputs(
        kt, ("noise_mod_ola_seg",), lambda: layer0._synthesize(sopt, chunk))
    del chunk, x, f0
    cases = [("16c", calls["noise_mod_ola_seg"][0][0])]
    for label, B, C, N, nhop, Ke in SEG_CASES:
        cyc = torch.remainder(torch.cumsum(r(B, N * nhop) * 0.02, -1), 1.0)
        cases.append((label, (cyc, r(B, N, C), (r(B, N, C, Ke) - 0.5) * 0.3,
                              (r(B, N, C, Ke) - 0.5) * 0.3, 0.5 + r(B, N, C),
                              r(B, C, N, 2 * nhop) - 0.5)))
    for label, args in cases:
        got = kt.noise_mod_ola_seg(*args)
        ok = torch.equal(got, ko.noise_mod_ola_seg(*args))
        print(f"seg {label} segs {tuple(args[5].shape)} Ke "
              f"{args[2].shape[-1]}: equal {ok}", flush=True)
        if not ok:
            bad.append(("seg", label))
        if args[0].shape[0] > 64:
            rows_alone(label, kt.noise_mod_ola_seg, args, got, bad, "seg")
            for _ in range(2):
                tt = cuda_ms(lambda: kt.noise_mod_ola_seg(*args))
                to = cuda_ms(lambda: ko.noise_mod_ola_seg(*args))
                print(f"seg {label} ms this {tt:.4f} other {to:.4f}",
                      flush=True)
        del got
    del cases, calls
    torch.cuda.empty_cache()


# (label, nhop, fs, F0 tracks: "rand" or the bench rows' every k-th frame)
CYCLE_CASES = (("hop 600", 600, 48000.0, "rand"),
               ("hop 882 at 44.1 kHz", 882, 44100.0, "rand"),
               ("hop 882 bench F0", 882, 44100.0, 4),
               ("hop 960", 960, 48000.0, "rand"),
               ("hop 960 bench F0", 960, 48000.0, 4),
               ("hop 2048", 2048, 48000.0, "rand"),
               ("hop 513", 513, 48000.0, "rand"),
               ("hop 1024", 1024, 48000.0, "rand"),
               ("hop 1025", 1025, 48000.0, "rand"),
               ("hop 2400", 2400, 48000.0, "rand"),
               ("hop 2400 bench F0", 2400, 48000.0, 10),
               ("hop 2205 at 44.1 kHz", 2205, 44100.0, "rand"),
               ("hop 4000 at 16 kHz", 4000, 16000.0, "rand"),
               ("hop 19200 at 96 kHz", 19200, 96000.0, "rand"),
               ("hop 60000 at 96 kHz", 60000, 96000.0, "rand"))
CYCLE_STARTS = (37, -2)
# a start whose hops cross 2^24 samples (positions divided past it)
CYCLE_CROSS = {960: 17400, 2400: 6950}


def cycles(kt, ko, r, bad):
    """sample_cycles past a 512-sample hop against the other side's at
    CYCLE_CASES, with and without base= and start=."""
    import chip_smoke
    bench_f0 = chip_smoke.fixtures(torch, torch.device("cuda"))[1]
    g = torch.Generator(device="cuda").manual_seed(25)
    for label, nhop, fs, src in CYCLE_CASES:
        N = int(8.0 * fs) // nhop
        if src == "rand":
            f0 = 70.0 + 230.0 * torch.rand(128, N, generator=g,
                                           device="cuda")
            f0[:, ::7] = 0.0
        else:
            f0 = bench_f0[:, ::src][:, :N].contiguous()
            N = f0.shape[-1]
        nx = N * nhop
        base = 1000.0 * torch.rand(128, generator=g, device="cuda",
                                   dtype=torch.float64)
        cross = (CYCLE_CROSS[nhop],) if nhop in CYCLE_CROSS else ()
        for start in (None,) + CYCLE_STARTS + cross:
            kw = {} if start is None else dict(base=base, start=start)
            got = kt.sample_cycles(f0, nhop, fs, nx, **kw)
            ok = torch.equal(got, ko.sample_cycles(f0, nhop, fs, nx, **kw))
            tag = f"{label} start {start}"
            print(f"cycles {tag} f0 {tuple(f0.shape)}: equal {ok}",
                  flush=True)
            if not ok:
                bad.append(("cycles", tag))
            for row in (0, 1, 64):
                kw1 = {} if start is None else dict(
                    base=base[row:row + 1], start=start)
                one = kt.sample_cycles(f0[row:row + 1], nhop, fs, nx, **kw1)
                ok = torch.equal(one[0], got[row])
                print(f"cycles {tag} row {row} alone equal {ok}",
                      flush=True)
                if not ok:
                    bad.append(("cycles row alone", tag, row))
            if start is None and src == "rand" and nhop in (960, 2048, 2400,
                                                            19200, 60000):
                for _ in range(2):
                    tt = cuda_ms(lambda: kt.sample_cycles(f0, nhop, fs, nx))
                    to = cuda_ms(lambda: ko.sample_cycles(f0, nhop, fs, nx))
                    print(f"cycles {label} ms this {tt:.4f} other "
                          f"{to:.4f}", flush=True)


# env_render past 8 envelope harmonics (its wide kernel): (label, B, N,
# nhop, C, Ke, samples cut off the render's end, offset of the cycle track
# in its buffer); 20f's two shapes, the card tests' edges, C 1 / 9, Ke 16 /
# 24, the shared memory's largest C (Ke + 1) (16-frame tiles), odd hops
# (single loads), a cut render, one partial tile and a misaligned track
ENV_CASES = (("20f Ke 9", 128, 1600, 80, 4, 9, 0, 0),
             ("20f Ke 12", 128, 800, 480, 3, 12, 0, 0),
             ("card Ke 9", 2, 130, 80, 4, 9, 0, 0),
             ("card Ke 12 cut", 1, 70, 480, 3, 12, 5, 0),
             ("C 1 Ke 9", 3, 130, 80, 1, 9, 0, 0),
             ("C 9 Ke 9", 3, 130, 80, 9, 9, 0, 0),
             ("C 4 Ke 16", 3, 130, 80, 4, 16, 0, 0),
             ("C 2 Ke 24", 3, 130, 160, 2, 24, 0, 0),
             ("C 40 Ke 21", 2, 70, 80, 40, 21, 0, 0),
             ("hop 55 C 5 Ke 10", 2, 130, 55, 5, 10, 0, 0),
             ("hop 333 cut", 2, 41, 333, 4, 9, 17, 0),
             ("cut by 44", 2, 301, 80, 4, 9, 44, 0),
             ("one partial tile", 2, 2, 80, 4, 9, 0, 0),
             ("misaligned track", 2, 130, 80, 4, 9, 0, 1))


def env(kt, ko, r, bad):
    """env_render's wide kernel against the other side's at ENV_CASES,
    rows 0, 1 and 64 alone at full batch, each side's time there."""
    for label, B, N, nhop, C, Ke, cut, off in ENV_CASES:
        nx = N * nhop - cut
        cyc = torch.remainder(torch.cumsum(r(B, N * nhop + off) * 0.02, -1),
                              1.0)[:, off:off + nx]
        args = (cyc, r(B, N, C), (r(B, N, C, Ke) - 0.5) * 0.3,
                (r(B, N, C, Ke) - 0.5) * 0.3, 0.5 + r(B, N, C))
        fn = lambda *a, k=kt, h=nhop: k.env_render(*a, nhop=h)
        got = fn(*args)
        ok = equal(got, ko.env_render(*args, nhop=nhop))
        print(f"env {label} [{B}, {N}, {C}, {Ke}] hop {nhop} nx {nx}: env "
              f"equal {ok[0]}, base equal {ok[1]}", flush=True)
        if not all(ok):
            bad.append(("env", label))
        if B > 64:
            for row in (0, 1, 64):
                one = fn(*(a[row:row + 1] for a in args))
                ok = all(torch.equal(o[0], g[row]) for o, g in zip(one, got))
                print(f"env {label} row {row} alone equal {ok}", flush=True)
                if not ok:
                    bad.append(("env row alone", label, row))
            for _ in range(2):
                tt = cuda_ms(lambda: fn(*args))
                to = cuda_ms(lambda: ko.env_render(*args, nhop=nhop))
                print(f"env {label} ms this {tt:.4f} other {to:.4f}",
                      flush=True)
        del got, args, cyc
    torch.cuda.empty_cache()


# viterbi_scan past 2048 states: (label, B, N, S, renorm); 20d's two
# shapes and row 0 alone, rows of 5 (a partial row warp) and 2, 2 frames,
# 3200 frames, 8193 states, S = 29024 on a few frames, paddings of 1-7
# states
VITERBI_CASES = (("20d S 2049", 64, 1600, 2049, True),
                 ("20d S 2049 row 0", 1, 1600, 2049, True),
                 ("20d S 4097", 64, 1600, 4097, False),
                 ("20d S 4097 row 0", 1, 1600, 4097, False),
                 ("5 rows", 5, 60, 4097, True),
                 ("2 rows 2 frames", 2, 2, 2049, False),
                 ("3200 frames", 1, 3200, 2049, True),
                 ("S 8193", 64, 40, 8193, True),
                 ("S 29024", 1, 3, 29024, True),
                 ("S 29024 64 rows", 64, 3, 29024, False),
                 ("S 2050", 3, 50, 2050, True),
                 ("S 2055", 3, 50, 2055, False),
                 ("S 2051 one frame", 3, 1, 2051, True))


def viterbi(kt, ko, bad):
    """viterbi_scan past 2048 states against the other side's at
    VITERBI_CASES (scores in eighths with -inf entries, lt in eighths with
    -inf off its diagonal), paths and last scores; then the tracker's own
    call at nbins 2048 on the first 64 bench rows; each side's time at
    20d's two shapes."""
    import chip_smoke
    f0m = importlib.import_module("p_this.ops.f0")
    g = torch.Generator(device="cuda").manual_seed(29)
    cases = []
    for label, B, N, S, renorm in VITERBI_CASES:
        obs = torch.round(torch.rand((B, N, S), generator=g, device="cuda")
                          * -96.0) / 8.0
        obs[torch.rand(obs.shape, generator=g, device="cuda") < 0.1] = \
            -float("inf")
        obs[..., 0] = -1.0
        lt = torch.round(torch.rand((S, S), generator=g, device="cuda")
                         * -32.0) / 8.0
        lt[(torch.rand((S, S), generator=g, device="cuda") < 0.1)
           & ~torch.eye(S, dtype=torch.bool, device="cuda")] = -float("inf")
        cases.append((label, (obs, lt, renorm)))
    x = chip_smoke.fixtures(torch, torch.device("cuda"))[0][:64]
    cfg = f0m.F0Config(fs=16000.0, nhop=80, f0_floor=70.0, nbins=2048)
    calls, _ = chip_smoke.capture_kernel_inputs(
        kt, ("viterbi_scan",), lambda: f0m.track_batch(cfg, x))
    del x
    cases.append(("tracker nbins 2048", calls["viterbi_scan"][0][0]))
    for label, args in cases:
        got = kt.viterbi_scan(*args, scores=True)
        ok = equal(got, ko.viterbi_scan(*args, scores=True))
        print(f"viterbi {label} {tuple(args[0].shape)} renorm {args[2]}: "
              f"path equal {ok[0]}, last scores equal {ok[1]}", flush=True)
        if not all(ok):
            bad.append(("viterbi", label))
        if label in ("20d S 2049", "20d S 4097"):
            tt = cuda_ms(lambda: kt.viterbi_scan(*args), 2)
            to = cuda_ms(lambda: ko.viterbi_scan(*args), 1)
            print(f"viterbi {label} ms this {tt:.4f} other {to:.4f}",
                  flush=True)
        del got
    del cases, calls
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        sys.exit("port_wide_bits.py: needs a CUDA card")
    argv = [a for a in sys.argv[1:] if "=" not in a]
    opts = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    if len(argv) != 1:
        sys.exit(__doc__)
    sys.path.insert(0, str(ROOT))     # chip_smoke (what=seg,cycles,viterbi)
    load(ROOT, "p_this")
    load(Path(argv[0]).resolve(), "p_other")
    kt = importlib.import_module("p_this.ops.kernels")
    build = importlib.import_module("p_this.ops._build")
    ko = importlib.import_module("p_other.ops.kernels")
    layer0 = importlib.import_module("p_this.models.layer0")
    g = torch.Generator(device="cuda").manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device="cuda")
    what = opts.get("what", "deconv,denoise").split(",")
    bad = []
    if "deconv" in what:
        deconv(kt, ko, r, bad)
    if "denoise" in what:
        denoise(kt, ko, layer0, r, bad)
    if "noise" in what:
        noise(kt, ko, r, bad)
    if "apply" in what:
        apply(kt, ko, r, bad, Path(argv[0]).resolve(), build)
    if "seg" in what:
        seg(kt, ko, r, bad)
    if "cycles" in what:
        cycles(kt, ko, r, bad)
    if "proj" in what:
        proj(kt, ko, r, bad)
    if "env" in what:
        env(kt, ko, r, bad)
    if "viterbi" in what:
        viterbi(kt, ko, bad)
    print("failed:", bad, flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
