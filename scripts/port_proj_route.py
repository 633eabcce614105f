"""harmonic_project_win where its 16-frame tile would not leave room for
two blocks an SM, and harmonic_project past K = 8: this checkout's
projection as it routes itself, its warp kernel forced (by monkeypatching
_proj_win_geometry) onto chunks of `chunks` columns, at the chunk its rule
picks and its 16-frame tile where that fits a block, and another
checkout's projection as it routes itself (e.g. the parent commit
unpacked under build/archive/), in one process on one card.  Shapes: the
main and envelope passes' calls of the analysis of the bench rows (128 x
8 s, F0 taken from the 5 ms track at the nearest frame) resampled to fs
at hop thop with the windows sized for f0_floor (PATHS: chip_smoke.py's
20g and 20h options, and the shapes whose frames overlap most, 2C / nhop
6 to 20, where the tile fits one block an SM or none), captured from this
checkout's analysis; 96 kHz at a 200 ms hop (x [128, 768000], hop and C
19200, K 80, random live slots, halfwidths uniform to 4800 and to 2743,
which F0 of 70 Hz or more gives) and random frames at 20g's and 20h's
hops and centres (halfwidths uniform to 1372, live slots uniform); then
harmonic_project at K 80 on the frames of a window outside the cosine
series at 96 kHz / 200 ms ([5120, 38400], live spans to 9601 and to
5487) and at 16 kHz with a 5 ms hop ([204800, 960], spans to 917, at K
80 and at K 24, which leaves 3 of a pass's 5 groups live), and between
them at 48 kHz with a 20 ms hop and f0_floor 40 ([51200, 5760]), at 10
ms ([102400, 2880]) and at 16 kHz with f0_floor 40 ([204800, 1600]),
this checkout's as it routes itself and at 2 and 5 groups of
harmonics a pass, and the other's.  Each option's output is compared bit for
bit with the other checkout's; then `pairs` rounds of one step each (10
calls, CUDA events; scripts/port_harness.py), the options' order rotated
a place each round and reversed every other cycle.  Prints each option's
median and quartiles a call, its ratio to chip_smoke.bound, how many
rounds the first option beat each other one, and harmonic_project's
one-call library yardstick (chip_smoke.library_full: an einsum against
the dense chirp basis, timed on the first rows and scaled where its
operands do not fit the card).  Inputs from seed 0.  Imports no jax:

    python3 scripts/port_proj_route.py OTHER_DIR [pairs=10]
        [only=win,random,project] [paths=20g,20h,...] [chunks=512,1024]
"""
import importlib
import math
import sys
from pathlib import Path

import numpy as np
import torch

from port_harness import load, rounds, same_bits

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the warp kernel's chunks (columns) forced onto every projection shape
CHUNKS = (512, 1024, 1536, 1792, 2048)
# analyses: (label, fs, thop, f0_floor); 2C / nhop in the comments
PATHS = (("20g", 48000.0, 0.02, 70.0),                   # 4
         ("20h", 48000.0, 0.05, 70.0),                   # 2
         ("48 kHz 20 ms floor 40", 48000.0, 0.02, 40.0),  # 6
         ("96 kHz 5 ms", 96000.0, 0.005, 40.0),          # 20
         ("96 kHz 10 ms", 96000.0, 0.01, 40.0),          # 10
         ("96 kHz 12.5 ms", 96000.0, 0.0125, 40.0),      # 8
         ("96 kHz 15 ms", 96000.0, 0.015, 40.0),         # 8, no tile fits
         ("96 kHz 20 ms", 96000.0, 0.02, 40.0))          # 6, no tile fits
# random frames: (label, B, N, nhop, C, halfwidths' top)
RANDOM = (("96 kHz 200 ms", 128, 40, 19200, 19200, 4800),
          ("96 kHz 200 ms, F0 >= 70 Hz", 128, 40, 19200, 19200, 2743),
          ("20g random frames", 128, 400, 960, 1920, 1372),
          ("20h random frames", 128, 160, 2400, 2400, 1372))
# harmonic_project: (label, R, W, halfwidths' top, K)
PROJECT = (("96 kHz 200 ms frames", 5120, 38400, 4800, 80),
           ("96 kHz 200 ms frames, F0 >= 70 Hz", 5120, 38400, 2743, 80),
           ("48 kHz 20 ms frames, f0_floor 40", 51200, 5760, 2400, 80),
           ("48 kHz 10 ms frames", 102400, 2880, 1372, 80),
           ("16 kHz 5 ms frames, f0_floor 40", 204800, 1600, 800, 80),
           ("16 kHz 5 ms frames", 204800, 960, 458, 80),
           ("16 kHz 5 ms frames, K 24", 204800, 960, 458, 24))
# harmonic_project's row kernel: groups of 8 harmonics a pass forced
GROUPS = (2, 5)


def forced(kt, geo, fn):
    """fn() with kt._proj_win_geometry returning geo."""
    keep = kt._proj_win_geometry
    kt._proj_win_geometry = lambda *a: geo
    try:
        return fn()
    finally:
        kt._proj_win_geometry = keep


def forced_project(kt, geo, args):
    """kt.harmonic_project(*args) with kt._project_geometry returning geo."""
    keep = kt._project_geometry
    kt._project_geometry = lambda *a: geo
    try:
        return kt.harmonic_project(*args)
    finally:
        kt._project_geometry = keep


def compare(label, opts, name, args, kw, pairs, bad):
    """Bits of each option against opts["other"], then `pairs` rotated
    rounds; a line each option and each comparison with the first."""
    import chip_smoke
    ref = opts["other"]()
    same_bits(label, opts, ref, bad)
    bound = chip_smoke.bound(torch, name, args, kw, ref)
    del ref
    rounds(label, opts, pairs, bound)


def win_options(kt, ko, args, kw, chunks):
    """this (its route), this's warp kernel at each of chunks and at the
    chunk its rule picks, this's 16-frame tile where it fits a block,
    other (its route)."""
    call = lambda: kt.harmonic_project_win(*args, **kw)
    opts = {"this": call}
    nhop, C, K = kw["nhop"], kw["center"], args[3]
    Qr = kt._PROJ_CHUNK_FEW if K <= 8 else kt._PROJ_CHUNK
    for Q in sorted(set(chunks) | {Qr}):
        opts[f"this warp kernel, chunks {Q}"] = (
            lambda Q=Q: forced(kt, (0, Q, 32 * Q), call))
    tile = 8 * (15 * nhop + 2 * C)
    if tile + kt._PROJ_STATIC <= kt._SMEM_MAX:
        opts["this 16-frame tile"] = lambda: forced(kt, (16, 0, tile), call)
    opts["other"] = lambda: ko.harmonic_project_win(*args, **kw)
    return opts


def path_calls(pkg, kt, fs, thop, f0_floor, dev="cuda", rows=128,
               duration=8.0):
    """The analysis's harmonic_project_win calls on the bench rows
    resampled to fs at hop thop, windows sized for f0_floor, F0 taken
    from the 5 ms track at the nearest frame -> [(args, kw), ...] (main
    pass, envelope pass)."""
    import chip_smoke
    testsig = importlib.import_module(pkg.__name__ + ".utils.testsig")
    resample = importlib.import_module(pkg.__name__ + ".ops.resample")
    layer0 = importlib.import_module(pkg.__name__ + ".models.layer0")
    sig = testsig.make_test_utterances(
        [(i, 0.05 if i < rows // 2 else 0.0) for i in range(rows)],
        duration=duration)
    x, f0 = (torch.tensor(np.stack([r[j] for r in sig]),
                          dtype=torch.float32, device=dev)
             for j in range(2))
    N = int(round(duration / thop))
    idx = torch.clamp(torch.round(torch.arange(N, dtype=torch.float64)
                                  * (thop / 0.005)).long(),
                      max=f0.shape[1] - 1).to(dev)
    opt = pkg.create_aoptions(fs=fs, thop=thop, fnyq=12000.0,
                              chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                              f0_floor=f0_floor, use_pallas=True)
    xr = resample.resample_to(x, 16000.0, fs)
    calls, _ = chip_smoke.capture_kernel_inputs(
        kt, ("harmonic_project_win",),
        lambda: layer0._analyze(opt, xr, f0[:, idx].contiguous()))
    return calls["harmonic_project_win"]


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("port_proj_route.py: needs a CUDA card")
    if len(argv) < 2:
        sys.exit(__doc__)
    kw = dict(a.split("=", 1) for a in argv[2:])
    pairs = int(kw.get("pairs", 10))
    only = kw.get("only", "win,random,project").split(",")
    paths = kw.get("paths", ",".join(p[0] for p in PATHS)).split(",")
    chunks = tuple(int(q) for q in kw.get("chunks", ",".join(
        map(str, CHUNKS))).split(",") if q)
    pkg = load(ROOT, "llsm_this")
    load(Path(argv[1]).resolve(), "llsm_other")
    kt = importlib.import_module("llsm_this.ops.kernels")
    ko = importlib.import_module("llsm_other.ops.kernels")
    import chip_smoke
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    bad = []
    for label, fs, thop, floor in (p for p in PATHS if p[0] in paths
                                   and "win" in only):
        calls = path_calls(pkg, kt, fs, thop, floor)
        for i, (args, kwc) in enumerate(calls):
            what = f"{label} {('main', 'envelope')[i]} pass"
            nhop, C = kwc["nhop"], kwc["center"]
            print(f"{what}: x {tuple(args[0].shape)} K {args[3]} hop {nhop} "
                  f"C {C} (2C / nhop {2 * C / nhop:g}); this checkout routes "
                  f"{kt._proj_win_geometry(nhop, C, args[3])}", flush=True)
            compare(what, win_options(kt, ko, args, kwc, chunks),
                    "harmonic_project_win", args, kwc, pairs, bad)
        del calls
        torch.cuda.empty_cache()
    for label, B, N, nhop, C, H in (RANDOM if "random" in only else ()):
        nx = N * nhop
        hw = 2.0 + (H - 2.0) * r(B, N)
        hwi = torch.ceil(hw).to(torch.int32)
        args = (r(B, nx) - 0.5,
                torch.remainder(torch.cumsum(r(B, nx) * 0.02, -1), 1.0),
                hw, 80, C - hwi, C + hwi + 1)
        kwc = dict(nhop=nhop, center=C, kl=(r(B, N) * 81).to(torch.int32))
        print(f"{label}: x [{B}, {nx}] K 80 hop {nhop} C {C}; this "
              f"checkout routes {kt._proj_win_geometry(nhop, C, 80)}",
              flush=True)
        compare(label, win_options(kt, ko, args, kwc, chunks),
                "harmonic_project_win", args, kwc, pairs, bad)
        del args
        torch.cuda.empty_cache()
    for label, R, W, H, K in (PROJECT if "project" in only else ()):
        C = W // 2
        hw = (2.0 + (H - 2.0) * r(R)).to(torch.int32)
        lo, hi = (C - hw).to(torch.int32), (C + hw + 1).to(torch.int32)
        d = torch.arange(W, device=dev)[None, :] - C
        xw = (r(R, W) - 0.5) * torch.where(
            d.abs() <= hw[:, None],
            0.5 + 0.5 * torch.cos(math.pi * d / hw[:, None]), 0.0)
        del d
        args = ((r(R, W) - 0.5) * 4.0, xw, K, lo, hi)
        S, nbytes, G = kt._project_geometry(W, K)
        print(f"{label}: [{R}, {W}] K {K}, staged columns {S}, {G} groups a "
              f"pass: {int(((hi - lo) > S).sum())} of {R} rows in chunks",
              flush=True)
        opts = {"this": lambda: kt.harmonic_project(*args)}
        for Gf in GROUPS:
            opts[f"this at {Gf} groups a pass"] = (
                lambda Gf=Gf: forced_project(kt, (S, nbytes, Gf), args))
        opts["other"] = lambda: ko.harmonic_project(*args)
        compare(label, opts, "harmonic_project", args, {}, pairs, bad)
        lib, scale = chip_smoke.library_full(torch, "harmonic_project",
                                             args, {})
        print(f"{label} library yardstick: "
              + ("its operands do not fit the card at one row"
                 if lib is None else f"{lib:.4f} ms"
                 + (f" (timed on 1/{scale} of the rows, x{scale})"
                    if scale > 1 else "")), flush=True)
        del args, xw
        torch.cuda.empty_cache()
    print(f"failed: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
