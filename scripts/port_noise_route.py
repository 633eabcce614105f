"""noise_mod_ola where the envelope coefficients leave no room for two of
the long kernel's 16-frame blocks an SM at chunks of 64 slots (C (Ke + 1)
past ~46): this checkout's noise_mod_ola as it routes itself (its long
kernel at 16 frames a block with the first chunk of 64, 48, 32 or 16
slots that leaves room for two blocks an SM) and with chunks of 64 (one
block an SM there; by monkeypatching _noise_geometry), and another
checkout's noise_mod_ola as it routes itself
(e.g. the parent commit unpacked under build/archive/, whose wide kernel
there holds 8 frames a block), in one process on one card.  Shapes (hop,
C, Ke): (480, 9, 9) at 48 kHz and (882, 4, 12) at 44.1 kHz, 128 rows of 8
s, one draw for the batch, C bands of equal width to fs / 2, uniform
random inputs from seed 0.  Each option's output is compared bit for bit
with the other checkout's; then `pairs` rounds of one step each (10
calls, CUDA events), the options' order rotated a place each round and
reversed every other cycle.  Prints each round, each option's median and
quartiles a call, its ratio to chip_smoke.bound, and how many rounds the
first option beat each other one.  Imports no jax:

    python3 scripts/port_noise_route.py OTHER_DIR [pairs=16]
"""
import importlib
import sys
from pathlib import Path

import torch

from port_harness import load, rounds, same_bits

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (label, B, N, nhop, C, Ke, fs)
SHAPES = (("480 9 9 at 48 kHz", 128, 800, 480, 9, 9, 48000.0),
          ("882 4 12 at 44.1 kHz", 128, 400, 882, 4, 12, 44100.0))


def forced64(kt, args, bands):
    """kt.noise_mod_ola with its long kernel at chunks of 64 slots."""
    keep = kt._noise_geometry
    B, N, C, Ke = args[2].shape
    geo = keep(args[-1].shape[-1] - 1, C, Ke, bands)
    nbytes = geo[2] + 16 * 17 * (64 - geo[4])
    kt._noise_geometry = lambda *a: geo[:2] + (nbytes, 128, 64)
    try:
        return kt.noise_mod_ola(*args, bands)
    finally:
        kt._noise_geometry = keep


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("port_noise_route.py: needs a CUDA card")
    if len(argv) < 2:
        sys.exit(__doc__)
    kw = dict(a.split("=", 1) for a in argv[2:])
    pairs = int(kw.get("pairs", 16))
    load(ROOT, "llsm_this")
    load(Path(argv[1]).resolve(), "llsm_other")
    kt = importlib.import_module("llsm_this.ops.kernels")
    ko = importlib.import_module("llsm_other.ops.kernels")
    import chip_smoke
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g, device=dev)
    bad = []
    for label, B, N, nhop, C, Ke, fs in SHAPES:
        nbin = nhop + 1
        cyc = torch.remainder(torch.cumsum(r(B, N * nhop) * 0.02, -1), 1.0)
        args = (cyc, r(B, N, C), r(B, N, C, Ke) - 0.5, r(B, N, C, Ke) - 0.5,
                r(B, N, C) + 0.5,
                torch.randn(1, N, nbin, generator=g, device=dev).expand(
                    B, N, nbin),
                torch.randn(1, N, nbin, generator=g, device=dev).expand(
                    B, N, nbin), r(B, N, nbin))
        edges = tuple(fs / 2 * c / C for c in range(C)) + (fs / 2 + 1.0,)
        bands = kt.band_ranges(nbin, fs, edges)
        opts = {"this": lambda: kt.noise_mod_ola(*args, bands),
                "this at 64": lambda: forced64(kt, args, bands),
                "other": lambda: ko.noise_mod_ola(*args, bands)}
        print(f"{label}: gains [{B}, {N}, {nbin}] C {C} Ke {Ke}; this "
              f"checkout routes {kt._noise_geometry(nhop, C, Ke, bands)}, "
              f"the other {ko._noise_geometry(nhop, C, Ke, bands)}",
              flush=True)
        ref = opts["other"]()
        same_bits(label, opts, ref, bad)
        bound = chip_smoke.bound(torch, "noise_mod_ola", args + (bands,), {},
                                 ref)
        del ref
        rounds(label, opts, pairs, bound, each_round=True)
        del args, cyc, opts
        torch.cuda.empty_cache()
    print(f"failed: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
