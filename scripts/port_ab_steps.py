"""Steps of this checkout's port against the port in another checkout
(e.g. the parent commit unpacked under build/archive/), both loaded into
one process on one card and run in alternating pairs, so that both see
the same card, host and moment.  The cells (chip_smoke.py's phases):
batched_pipeline on the bench rows x 8 s with the library default
(phase 5, `batch` rows), with hm_kernel="matmul" (phase 6) and with the
library's own default, use_pallas=False (phase 16a: `plain`), the
denoiser off on 32 of them (phase 4: rows 0-15 and 64-79), the public
analyze() of one 8 s file (row 0, a batch of one), harmonics.refine_f0
alone on the bench rows' x and F0 (`refine`: all of them and row 0 alone,
the main path's decimated refine, one kernel launch), the same bench
rows made at 11 kHz (hop 55, the full-rate refine) through
batched_pipeline at fs 11000 (phase 7: `11k`) and through
harmonics.refine_f0 alone (`refine11`: all of them and row 0 alone),
the analysis of one
RTAnalyzer block (`rta`: layer0._analyze on row 0's frames 800-959, a
batch of one, as RTAnalyzer runs each 160-frame block), the layer-1
round trip chunk_to_layer1 -> chunk_to_layer0 -> synthesis of the bench
rows' chunk
(phase 9) and its chunk_to_layer1 alone (`to_layer1`), pbp_synthesize of
the LF rows' layer-1 chunk (phase 10) and
the edit chain pitch_shift(2.0) -> time_stretch(1.5) -> synthesize_batch
on it (phase 12), chunk_to_layer1 with and without phase 14's sections on
its nasal rows (`nasal`), the F0 tracker on the first 64 bench rows
(`tracker`, phase 11's tracker alone) and the two Viterbis alone on
uniform random scores from seed 0, as phases 9 and 11 time them
(`rdviterbi`: layer1._rd_viterbi on [batch, 1600, 64] with the chunk's
voicing; `viterbi`: f0.viterbi on [64, 1600, 97]; each all rows, then
row 0 alone), kernels.viterbi_scan past 256 states as chip_smoke's phase
20d runs it (`wide257`, `wide512`, `wide1025`, `wide2049`, `wide4097`,
any `wide<S>` or `wide<S>x<N>` at N frames: seeded scores in eighths
with -inf entries under the tracker's transitions at S = nbins + 1 (past
8193 states an lt in eighths from seed 0: the tracker's float64 table is
6.7 GB at 29024), renormalized but at 512 and 4097; [64, N, S], row 0
alone, then rows 0 and 1 joined into one row of 2 N frames, or the rows
`widerows=` lists, -1 the joined row) and the tracker at nbins 384 on the
first 64 bench rows (`tracker384`; `tracker<nbins>` at any nbins, e.g.
`tracker2048`, past 2048 states), and full-band analysis as
chip_smoke.py's phase 20e runs it (`full48`: batched_pipeline at 48 kHz
with the 5 ms hop, maxnhar 600, f0_floor 40, on the bench rows resampled
to 48 kHz on the card; `full16`: 16 kHz at a 2 ms hop, maxnhar 200, fnyq
8000, f0_floor 40, on the bench rows made at that hop) and 48 kHz at a
10 ms hop as chip_smoke.py's phase 20b runs it (`h10_48`: fnyq 12000,
noise channels at 3 / 6 / 9 kHz, f0_floor 70, the bench rows resampled to
48 kHz on the card, every other F0 frame): for these three the sides'
analysis chunks are compared field by field once, and each pair's
outputs (y and the SNRs) bit for bit, a line a pair; `kern48` and
`kern16` time the three kernels whose wide paths the full band runs,
deconv_full, denoise_stats and denoise_apply, alone on the inputs of
their calls in that analysis (captured once from this checkout's, at full
batch), ten calls a step, each pair's outputs compared bit for bit;
`kernnoise48` the same for noise_mod_ola (its wide kernel) on its call in
h10_48's synthesis, `kern160` for denoise_apply on its call in the
analysis of phase 20a's creaky-voice conf (maxnhar 160, fnyq 6000, the
bench rows); `h20_48` is h10_48 at a 20 ms hop (hop 960, every fourth F0
frame: chip_smoke.py's phase 20g, where the cycle track runs its long-hop
kernel), compared as the three above, and `h50_48` at a 50 ms hop (hop
2400, every tenth F0 frame: phase 20h, where the noise runs its long
kernel and the cycle track its hop kernel); `kernnoise960` and
`kernnoise2400` time noise_mod_ola (its long kernel) alone on its call in
h20_48's and h50_48's synthesis and `kerncyc2400` sample_cycles (its hop
kernel) on its first call in h50_48's analysis, as the kern cells
below; `fft16` the synthesis of phase
16c (layer0._synthesize with noise_idft="fft" and the kernels on, of each
side's own analysis of the bench rows with the library default), each
pair's y compared bit for bit; `kernseg` noise_mod_ola_seg alone on its
call in fft16's synthesis, `kerncyc960` sample_cycles alone on its first
call in h20_48's analysis and `kerncyc2048` on 20f's hop 2048 at 48 kHz
(F0 [128, 187], 70-300 Hz from seed 0, every 7th frame unvoiced), ten
calls a step, as the kern cells above; `kernproj960` and
`kernproj2400` harmonic_project_win alone on its first call (the main
pass) in h20_48's and h50_48's analysis, `kernproj19200` on chip_smoke.py's
96 kHz / 200 ms shape (x [batch, 768000], hop and C 19200, halfwidths to
4800, K 80) and `kernproject` harmonic_project on its frames of a window
outside the cosine series ([40 batch, 38400], K 80, live spans to 9601),
`kernenv9` and `kernenv12` env_render past 8 envelope harmonics on
chip_smoke.py's 20f shapes (cycle tracks [batch, 128000] at hop 80 with
4 channels of 9 harmonics, [batch, 384000] at hop 480 with 3 of 12,
from seed 22), ten calls a step, as the kern cells above; each side analyzes
(and fits layer 1) once, untimed, with its own package.  One untimed step of
each first, then `pairs` pairs whose order alternates (other first in
even pairs), each step timed by the host clock around work that ends in
torch.cuda.synchronize().  Prints every step, each side's median and
quartiles, and how many pairs each side won.  Imports no jax:

    python3 scripts/port_ab_steps.py OTHER_DIR [pairs=20] [batch=128]
        [widerows=64,1,-1]
        [cells=default,matmul,off32,one,refine,rta,layer1,pbp,edits,plain,
               11k,refine11,to_layer1,nasal,tracker,rdviterbi,viterbi,
               wide257,wide512,wide1025,wide2049,wide4097,tracker384,
               tracker2048,full48,full16,
               kern48,kern16,h10_48,kernnoise48,kern160,h20_48,fft16,
               kernseg,kerncyc960,kerncyc2048,h50_48,kernnoise960,
               kernnoise2400,kerncyc2400,kernproj960,kernproj2400,
               kernproj19200,kernproject,kernenv9,kernenv12]
"""
import dataclasses
import importlib
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from port_harness import load

ROOT = Path(__file__).resolve().parents[1]
# the kernels whose wide paths full-band analysis runs (kern48, kern16)
KERN_WIDE = ("deconv_full", "denoise_stats", "denoise_apply")


def main(argv):
    if not argv or not torch.cuda.is_available():
        print(__doc__ if argv else "FAIL: no CUDA card", flush=True)
        return 2
    kw = dict(a.split("=", 1) for a in argv[1:])
    pairs, B = int(kw.get("pairs", 20)), int(kw.get("batch", 128))
    cells = kw.get("cells", "default,matmul,off32,one,layer1,pbp,edits"
                   ).split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    sides = {"this": load(ROOT, "port_this"),
             "other": load(Path(argv[0]).resolve(), "port_other")}
    testsig = importlib.import_module("port_this.utils.testsig")
    rows = testsig.make_test_utterances(
        [(i, 0.05 if i < B // 2 else 0.0) for i in range(B)], duration=8.0)
    x, f0, x_ref = (torch.tensor(np.stack([r[j] for r in rows]),
                                 dtype=torch.float32, device="cuda")
                    for j in range(3))
    nxv = torch.full((B,), x.shape[1], dtype=torch.int64, device="cuda")
    if {"11k", "refine11"} & set(cells):
        rows11 = testsig.make_test_utterances(
            [(i, 0.05 if i < B // 2 else 0.0) for i in range(B)],
            duration=8.0, fs=11000.0)
        x11, f011, xr11 = (torch.tensor(np.stack([r[j] for r in rows11]),
                                        dtype=torch.float32, device="cuda")
                           for j in range(3))
        nxv11 = torch.full((B,), x11.shape[1], dtype=torch.int64,
                           device="cuda")
    off_rows = torch.tensor([r for r in list(range(16))
                             + list(range(B // 2, B // 2 + 16)) if r < B],
                            device="cuda")
    if {"pbp", "edits"} & set(cells):
        nfrm = x.shape[1] // 80
        lf = [testsig.synth_lf_speech(testsig.make_f0_track(nfrm, 0.005),
                                      rd=(0.4, 1.0, 1.8, 2.7)[i % 4], seed=i)
              for i in range(B)]
        lx, lf0 = (torch.tensor(np.stack([r[j] for r in lf]),
                                dtype=torch.float32, device="cuda")
                   for j in range(2))
    if "nasal" in cells:
        nas = [testsig.synth_nasal_utterance(
            duration=8.0, seed=i, zero=(900.0, 60.0),
            f0_base=(120.0, 182.0, 200.0)[i % 3]) for i in range(B)]
        nx_, nf0 = (torch.tensor(np.stack([r[j] for r in nas]),
                                 dtype=torch.float32, device="cuda")
                    for j in range(2))
    full = {}
    if {"full48", "kern48", "h10_48", "kernnoise48", "h20_48",
            "kerncyc960", "h50_48", "kernnoise960", "kernnoise2400",
            "kerncyc2400", "kernproj960", "kernproj2400"} & set(cells):
        rs = importlib.import_module("port_this.ops.resample")
        x48, r48 = (rs.resample_to(v, 16000.0, 48000.0) for v in (x, x_ref))
        nxv48 = torch.full_like(nxv, x48.shape[1])
        full["full48"] = (dict(fs=48000.0, f0_floor=40.0, maxnhar=600),
                          (x48, f0, nxv48, r48))
        full["h10_48"] = (dict(fs=48000.0, thop=0.01, fnyq=12000.0,
                               chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                               f0_floor=70.0),
                          (x48, f0[:, ::2].contiguous(), nxv48, r48))
        full["h20_48"] = (dict(fs=48000.0, thop=0.02, fnyq=12000.0,
                               chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                               f0_floor=70.0),
                          (x48, f0[:, ::4].contiguous(), nxv48, r48))
        full["h50_48"] = (dict(fs=48000.0, thop=0.05, fnyq=12000.0,
                               chanfreq=(3000.0, 6000.0, 9000.0), nspec=513,
                               f0_floor=70.0),
                          (x48, f0[:, ::10].contiguous(), nxv48, r48))
    if {"full16", "kern16"} & set(cells):
        rows16 = testsig.make_test_utterances(
            [(i, 0.05 if i < B // 2 else 0.0) for i in range(B)],
            duration=8.0, thop=0.002)
        x16, f016, xr16 = (torch.tensor(np.stack([r[j] for r in rows16]),
                                        dtype=torch.float32, device="cuda")
                           for j in range(3))
        full["full16"] = (dict(thop=0.002, f0_floor=40.0, maxnhar=200,
                               fnyq=8000.0),
                          (x16, f016, torch.full_like(nxv, x16.shape[1]),
                           xr16))
    g = torch.Generator(device="cuda").manual_seed(0)
    if "rdviterbi" in cells:
        rd_score = torch.rand((B, 1600, 64), generator=g, device="cuda")
    if "viterbi" in cells:
        logobs = torch.rand((64, 1600, 97), generator=g, device="cuda")
    wide = {}
    wide_rows = [int(v) for v in kw.get("widerows", "64,1,-1").split(",")]
    for cell in cells:
        m = re.fullmatch(r"wide(\d+)(?:x(\d+))?", cell)
        if m:
            S, Nw = int(m[1]), int(m[2] or 1600)
            o = torch.round(torch.rand((64, Nw, S), generator=g,
                                       device="cuda") * -96.0) / 8.0
            o[torch.rand(o.shape, generator=g, device="cuda") < 0.1] = \
                -float("inf")
            o[..., 0] = -1.0
            wide[cell] = (o, S not in (512, 4097))
    # (cell, rows): refine, refine11 and the two Viterbis run the batch,
    # then one row alone; the wide Viterbis also rows 0 and 1 joined (-1)
    # the kern cells: the wide kernels' calls in this checkout's full-band
    # analysis (kernnoise48: in its 48 kHz / 10 ms synthesis), captured once
    captured = {}
    kern_cells = {"kern48": ("full48", KERN_WIDE), "kern16": ("full16",
                                                              KERN_WIDE),
                  "kernnoise48": ("h10_48", ("noise_mod_ola",)),
                  "kern160": ("creaky", ("denoise_apply",)),
                  "kernseg": ("fft16", ("noise_mod_ola_seg",)),
                  "kerncyc960": ("h20_48", ("sample_cycles",)),
                  "kernnoise960": ("h20_48", ("noise_mod_ola",)),
                  "kernnoise2400": ("h50_48", ("noise_mod_ola",)),
                  "kerncyc2400": ("h50_48", ("sample_cycles",)),
                  "kerncyc2048": (None, ("sample_cycles",)),
                  "kernproj960": ("h20_48", ("harmonic_project_win",)),
                  "kernproj2400": ("h50_48", ("harmonic_project_win",)),
                  "kernproj19200": (None, ("harmonic_project_win",)),
                  "kernproject": (None, ("harmonic_project",)),
                  "kernenv9": (None, ("env_render",)),
                  "kernenv12": (None, ("env_render",))}
    if "kern160" in cells:
        full["creaky"] = (dict(f0_floor=70.0, maxnhar=160, fnyq=6000.0),
                          (x, f0, nxv, x_ref))
    if "kerncyc2048" in cells:
        gc = torch.Generator(device="cuda").manual_seed(0)
        fc = 70.0 + 230.0 * torch.rand(B, 187, generator=gc, device="cuda")
        fc[:, ::7] = 0.0
        captured["kerncyc2048 sample_cycles"] = (
            (fc, 2048, 48000.0, 187 * 2048), {})
    for cell, (Ne, hop, Ce, Ke) in (("kernenv9", (1600, 80, 4, 9)),
                                    ("kernenv12", (800, 480, 3, 12))):
        if cell in cells:
            # chip_smoke.py's 20f envelopes: [B, N] frames, C channels of Ke
            # harmonics, a cycle track of small random steps
            ge = torch.Generator(device="cuda").manual_seed(22)
            re_ = lambda *s: torch.rand(s, generator=ge, device="cuda")
            cyc = torch.remainder(torch.cumsum(re_(B, Ne * hop) * 0.02, -1),
                                  1.0)
            captured[f"{cell} env_render"] = (
                (cyc, re_(B, Ne, Ce), (re_(B, Ne, Ce, Ke) - 0.5) * 0.3,
                 (re_(B, Ne, Ce, Ke) - 0.5) * 0.3, 0.5 + re_(B, Ne, Ce)), {})
    if {"kernproj19200", "kernproject"} & set(cells):
        # chip_smoke.py's 20h shapes at 96 kHz / 200 ms: x [B, 768000] (hop
        # and C 19200, halfwidths to 4800, random live slots) and the
        # [40 B, 38400] Hann-windowed frames of a window outside the cosine
        # series (live spans 2 hw + 1 to 9601)
        gp = torch.Generator(device="cuda").manual_seed(26)
        rp = lambda *s: torch.rand(s, generator=gp, device="cuda")
        Np, hop, H = 40, 19200, 4800
        if "kernproj19200" in cells:
            hw = 2.0 + (H - 2.0) * rp(B, Np)
            hwi = torch.ceil(hw).to(torch.int32)
            captured["kernproj19200 harmonic_project_win"] = (
                (rp(B, Np * hop) - 0.5,
                 torch.remainder(torch.cumsum(rp(B, Np * hop) * 0.02, -1),
                                 1.0), hw, 80, hop - hwi, hop + hwi + 1),
                dict(nhop=hop, center=hop,
                     kl=(rp(B, Np) * 81).to(torch.int32)))
        if "kernproject" in cells:
            R, W = B * Np, 2 * hop
            hwr = (2.0 + (H - 2.0) * rp(R)).to(torch.int32)
            d = torch.arange(W, device="cuda")[None, :] - hop
            xw = (rp(R, W) - 0.5) * torch.where(
                d.abs() <= hwr[:, None],
                0.5 + 0.5 * torch.cos(np.pi * d / hwr[:, None]), 0.0)
            del d
            captured["kernproject harmonic_project"] = (
                ((rp(R, W) - 0.5) * 4.0, xw, 80, (hop - hwr).int(),
                 (hop + hwr + 1).int()), {})
    for cell, (source, names) in kern_cells.items():
        if cell in cells and source is not None:
            sys.path.insert(0, str(ROOT))          # chip_smoke
            import chip_smoke
            kw, args = full[source] if source in full else (
                dict(f0_floor=70.0), (x, f0, nxv, x_ref))    # fft16
            pkg = sides["this"]
            kmod = importlib.import_module(pkg.__name__ + ".ops.kernels")
            l0 = importlib.import_module(pkg.__name__ + ".models.layer0")
            corpus = importlib.import_module(pkg.__name__
                                             + ".parallel.corpus")
            opt = pkg.create_aoptions(use_pallas=True, **kw)
            sopt = dataclasses.replace(pkg.create_soptions(fs=opt.conf.fs),
                                       use_pallas=True)
            run = ((lambda: corpus.batched_pipeline(opt, sopt, *args))
                   if cell.startswith("kernnoise") else
                   (lambda: l0._synthesize(
                       dataclasses.replace(sopt, noise_idft="fft"),
                       l0._analyze(opt, args[0], args[1])))
                   if cell == "kernseg" else
                   (lambda: l0._analyze(opt, args[0], args[1])))
            calls, _ = chip_smoke.capture_kernel_inputs(kmod, names, run)
            for name, recs in calls.items():
                captured[f"{cell} {name}"] = recs[0]
    runs = [r for cell in cells for r in (
        [(f"{cell} {k}", None) for k in kern_cells[cell][1]]
        if cell in kern_cells else
        [(cell, min(B, 64) if cell == "viterbi" else B), (cell, 1)]
        if cell in ("refine", "refine11", "viterbi", "rdviterbi")
        else [(cell, r) for r in wide_rows] if cell in wide
        else [(cell, None)])]
    for cell, rows in runs:
        label = cell if rows is None else (
            f"{cell} {tuple(wide[cell][0].shape)} rows {rows} (-1: rows 0 "
            "and 1 joined)" if cell in wide else f"{cell} 1 x 16 s"
            if rows < 0 else f"{cell} {rows} x 8 s")
        steps, chunks = {}, {}
        for name, pkg in sides.items():
            opt = pkg.create_aoptions(f0_floor=70.0, use_pallas=True)
            sopt = dataclasses.replace(pkg.create_soptions(), use_pallas=True)
            corpus = importlib.import_module(pkg.__name__
                                             + ".parallel.corpus")
            mod = lambda m: importlib.import_module(f"{pkg.__name__}.models."
                                                    + m)
            l0, l1 = mod("layer0"), mod("layer1")
            if cell == "layer1":
                ch = l0._analyze(opt, x, f0)
                steps[name] = (lambda l0=l0, l1=l1, c=ch, s=sopt:
                               l0._synthesize(s, l1.chunk_to_layer0(
                                   l1.chunk_to_layer1(c))))
            elif cell == "to_layer1":
                ch = l0._analyze(opt, x, f0)
                steps[name] = lambda l1=l1, c=ch: l1.chunk_to_layer1(c)
            elif cell == "nasal":
                ch = l0._analyze(opt, nx_, nf0)
                sections = ((250.0, 70.0, -1.0), (900.0, 60.0, 1.0))
                steps[name] = (lambda l1=l1, c=ch, sec=sections:
                               (l1.chunk_to_layer1(c, None, sec),
                                l1.chunk_to_layer1(c)))
            elif cell == "rdviterbi":
                voiced = l0._analyze(opt, x, f0).f0 > 0
                steps[name] = (lambda l1=l1, v=voiced, r=rows:
                               l1._rd_viterbi(rd_score[:r], v[:r], 10.0))
            elif cell in wide:
                f0m = importlib.import_module(pkg.__name__ + ".ops.f0")
                kern = importlib.import_module(pkg.__name__ + ".ops.kernels")
                o, renorm = wide[cell]
                S = o.shape[-1]
                if S <= 8193:
                    lt = f0m._tables(f0m.F0Config(nbins=S - 1), "cuda")["lt"]
                else:        # the tracker's float64 table: 6.7 GB at 29024
                    gl = torch.Generator(device="cuda").manual_seed(0)
                    lt = torch.round(torch.rand((S, S), generator=gl,
                                                device="cuda") * -32.0) / 8.0
                o = (o[:2].reshape(1, 2 * o.shape[1], -1) if rows < 0
                     else o[:rows])
                steps[name] = (lambda k=kern, o=o, lt=lt, rn=renorm:
                               k.viterbi_scan(o, lt, rn))
            elif cell in captured:
                kern = importlib.import_module(pkg.__name__ + ".ops.kernels")
                fn = getattr(kern, cell.split()[1])
                a, k = captured[cell]
                steps[name] = (lambda fn=fn, a=a, k=k:
                               [fn(*a, **k) for _ in range(10)][-1])
            elif cell in full:
                kw, args = full[cell]
                opt = pkg.create_aoptions(use_pallas=True, **kw)
                sopt = dataclasses.replace(
                    pkg.create_soptions(fs=opt.conf.fs), use_pallas=True)
                chunks[name] = l0._analyze(opt, args[0], args[1])
                steps[name] = (lambda c=corpus, o=opt, s=sopt, a=args:
                               c.batched_pipeline(o, s, *a))
            elif cell == "fft16":
                ch = l0._analyze(opt, x, f0)
                so = dataclasses.replace(sopt, noise_idft="fft")
                steps[name] = lambda l0=l0, c=ch, s=so: l0._synthesize(s, c)
            elif re.fullmatch(r"tracker\d+", cell):
                f0m = importlib.import_module(pkg.__name__ + ".ops.f0")
                cfg = f0m.F0Config(fs=16000.0, nhop=80, f0_floor=70.0,
                                   nbins=int(cell[7:]))
                steps[name] = lambda f0m=f0m, c=cfg: f0m.track_batch(c, x[:64])
            elif cell in ("tracker", "viterbi"):
                f0m = importlib.import_module(pkg.__name__ + ".ops.f0")
                cfg = f0m.F0Config(fs=16000.0, nhop=80, f0_floor=70.0)
                lt = f0m._tables(cfg, "cuda")["lt"]
                steps[name] = (
                    (lambda f0m=f0m, c=cfg: f0m.track_batch(c, x[:64]))
                    if cell == "tracker" else
                    (lambda f0m=f0m, lt=lt, r=rows:
                     f0m.viterbi(logobs[:r], lt)))
            elif cell in ("pbp", "edits"):
                c1 = l1.chunk_to_layer1(l0._analyze(opt, lx, lf0))
                pbp, edits = mod("pbp"), mod("edits")
                steps[name] = (
                    (lambda p=pbp, c=c1, s=sopt: p._pbp_synthesize(s, c))
                    if cell == "pbp" else
                    (lambda e=edits, l0=l0, c=c1, s=sopt: l0.synthesize_batch(
                        s, e.time_stretch(e.pitch_shift(c, 2.0), 1.5))))
            elif cell == "one":
                steps[name] = (lambda p=pkg, o=opt: p.analyze(o, x[0], f0[0]))
            elif cell == "rta":
                steps[name] = (lambda l0=l0, o=opt: l0._analyze(
                    o, x[:1, 800 * 80:960 * 80], f0[:1, 800:960]))
            elif cell in ("refine", "refine11"):
                hm = importlib.import_module(pkg.__name__ + ".ops.harmonics")
                xs, fs0 = (x, f0) if cell == "refine" else (x11, f011)
                c = (opt if cell == "refine" else pkg.create_aoptions(
                    fs=11000.0, f0_floor=70.0, use_pallas=True)).conf
                steps[name] = (lambda hm=hm, c=c, r=rows, xs=xs, fs0=fs0:
                               hm.refine_f0(
                                   xs[:r], fs0[:r], nhop=c.nhop, fs=c.fs,
                                   halfwin_max=c.halfwin_max,
                                   rel_winsize=c.rel_winsize,
                                   f0_ceil=c.f0_ceil))
            else:
                args = (x, f0, nxv, x_ref)
                if cell == "matmul":
                    opt = dataclasses.replace(opt, hm_kernel="matmul")
                elif cell == "plain":
                    opt = pkg.create_aoptions(f0_floor=70.0)
                    sopt = pkg.create_soptions()
                elif cell == "off32":
                    opt = dataclasses.replace(opt, track_denoise=False)
                    args = tuple(a[off_rows] for a in args)
                elif cell == "11k":
                    opt = pkg.create_aoptions(fs=11000.0, f0_floor=70.0,
                                              use_pallas=True)
                    sopt = dataclasses.replace(
                        pkg.create_soptions(fs=11000.0), use_pallas=True)
                    args = (x11, f011, nxv11, xr11)
                steps[name] = (lambda c=corpus, o=opt, s=sopt, a=args:
                               c.batched_pipeline(o, s, *a))
            steps[name]()                  # build, warm, fill the cache
        torch.cuda.synchronize()
        if chunks:
            fields = [f.name for f in dataclasses.fields(chunks["this"])
                      if torch.is_tensor(getattr(chunks["this"], f.name))]
            diff = [f for f in fields if not torch.equal(
                getattr(chunks["this"], f), getattr(chunks["other"], f))]
            print(f"{label}: analysis chunks equal bit for bit in "
                  f"{len(fields) - len(diff)} of {len(fields)} fields; "
                  f"differ: {diff}", flush=True)
            chunks.clear()
        ms = {name: [] for name in sides}
        for i in range(pairs):
            order = ("other", "this") if i % 2 == 0 else ("this", "other")
            outs = {}
            for name in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = steps[name]()
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
            if cell == "fft16":
                print(f"{label} pair {i}: y equal bit for bit "
                      f"{torch.equal(outs['this'].y, outs['other'].y)}",
                      flush=True)
            if cell in full or cell in captured:
                n = 2 if cell in full else None
                same = all(torch.equal(a, b) for a, b in
                           zip(outs["this"][:n], outs["other"][:n]))
                what = "y and SNRs" if cell in full else "outputs"
                print(f"{label} pair {i}: {what} equal bit for bit {same}",
                      flush=True)
            del outs
        wins = sum(a < b for a, b in zip(ms["this"], ms["other"]))
        nd = 4 if cell.startswith("refine") or cell.endswith("viterbi") \
            or cell in wide or cell in captured else 2  # ~0.1-1 ms steps
        for name in sides:
            q = statistics.quantiles(ms[name], n=4)
            print(f"{label} {name}: median "
                  f"{statistics.median(ms[name]):.{nd}f} ms, quartiles "
                  f"{q[0]:.{nd}f} / {q[2]:.{nd}f} ms; steps "
                  f"{[round(v, nd) for v in ms[name]]}", flush=True)
        print(f"{label}: this checkout faster in {wins} of {pairs} pairs",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
