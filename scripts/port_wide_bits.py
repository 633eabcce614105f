"""The wide paths of deconv_full and denoise_stats (the full-band
deconvolution and the track denoiser's pass A past the first kernels'
limits) of this checkout against another checkout's (e.g. the parent
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
otherwise; its largest difference printed).  Prints a line
a case and, last, the cases that failed; exits 1 if any did.  Imports
no jax:

    python3 scripts/port_wide_bits.py OTHER_DIR [what=deconv,denoise]
"""
import importlib
import importlib.util
import statistics
import sys
from pathlib import Path

import torch

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


def load(root: Path, alias: str):
    """The libllsm2_tpu_torch package under root, imported as `alias`."""
    pkg = root / "libllsm2_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


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


def main():
    if not torch.cuda.is_available():
        sys.exit("port_wide_bits.py: needs a CUDA card")
    argv = [a for a in sys.argv[1:] if "=" not in a]
    opts = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    if len(argv) != 1:
        sys.exit(__doc__)
    load(ROOT, "p_this")
    load(Path(argv[0]).resolve(), "p_other")
    kt = importlib.import_module("p_this.ops.kernels")
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
    print("failed:", bad, flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
