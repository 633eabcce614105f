"""The row-group size (layer0._group_rows) of the three analysis stages
that run in groups of a fixed row count, by measurement: on the card, at
16 kHz and `seconds` a row (8 s: nx 128000, N 1600, K 80), for batches of
B rows and each group size G (and G = B, one call over the batch: the
code before the groups),
the time of each stage -- _band_envelopes (D = 4), the denoiser's floor
statistics and its spectral gate (D = 4) -- and of the three together
(CUDA events, median of 10), and, at the largest batch, whether rows 0, 1
and 64 alone (each a batch of one, in the same groups, or in one call of
its own where G = B) equal the same rows of the batch bit for bit.  The inputs are random, of the shapes and types the analysis
gives these stages.

Imports neither jax nor libllsm2_tpu; needs a CUDA card:

    python scripts/port_row_groups.py [groups=1,8,16,32,64,128]
        [batches=1,32,128] [seconds=8]
"""
import statistics
import subprocess
import sys

import torch

from libllsm2_tpu_torch.config import ChunkConf, create_aoptions
from libllsm2_tpu_torch.models import layer0

ROWS = (0, 1, 64)


def stage_inputs(B, N, K, nx, gen):
    """Random inputs of the three stages for B rows -> (residual, the floor
    statistics' arguments, the spectral gate's tensor arguments)."""
    r = lambda *s: torch.rand(s, generator=gen).cuda()
    n = lambda *s: torch.randn(s, generator=gen).cuda()
    residual = n(B, nx)
    mask = (r(B, N, K) > 0.1).float()
    guard = r(B, N) > 0.2
    ok = guard[..., None] & (mask > 0)
    pp, cs2, amp2 = (r(B, N, K) for _ in range(3))
    r2 = 0.1 * r(B, N, K)             # a slow track that keeps most power
    c_s = torch.complex(n(B, N, K), n(B, N, K))
    full = c_s + 0.3 * torch.complex(n(B, N, K), n(B, N, K))
    v = r(B, K)                       # floors that engage the gate
    return (residual, (pp, cs2 * mask, r2, amp2 * mask, ok),
            (c_s, full, pp, guard[..., None], v, mask))


def stages(conf, opt, args, G):
    """The three stages on one batch's inputs in groups of G rows."""
    residual, stats, gate = args
    return {
        "envelopes": lambda: layer0._band_envelopes(residual, conf, 4,
                                                    rows=G),
        "floor stats": lambda: layer0._denoise_floor_stats(*stats, rows=G),
        "spectral gate": lambda: layer0._spectral_gate(
            *gate, conf.thop, opt.track_denoise_hz,
            opt.track_spectral_strength, opt.track_spectral_decimate,
            rows=G),
    }


def cuda_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main():
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    groups = [int(g) for g in kw.get("groups", "1,8,16,32,64,128").split(",")]
    batches = [int(b) for b in kw.get("batches", "1,32,128").split(",")]
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    conf = ChunkConf()
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    nx = int(float(kw.get("seconds", 8)) * conf.fs)
    N, K = nx // conf.nhop, conf.maxnhar
    print(f"{nx / conf.fs:g} s a row, N {N}: the analysis groups "
          f"{layer0._group_rows(N)} rows a call", flush=True)
    gen = torch.Generator().manual_seed(0)
    for B in batches:
        args = stage_inputs(B, N, K, nx, gen)
        for G in sorted(set(groups) | {B}):
            fns = stages(conf, opt, args, G)
            ms = {name: cuda_ms(fn) for name, fn in fns.items()}
            ms["all three"] = cuda_ms(lambda: [fn() for fn in fns.values()])
            line = (f"B {B} groups of {G}{' (one call)' if G == B else ''}: "
                    + "; ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
            if B == max(batches):
                rows = [r for r in ROWS if r < B]
                whole = {k: fn() for k, fn in fns.items()}
                same = {}
                for r in rows:
                    one = (args[0][r:r + 1],
                           tuple(t[r:r + 1] for t in args[1]),
                           tuple(t[r:r + 1] for t in args[2]))
                    # alone: one call over its own batch where G = B
                    alone = stages(conf, opt, one, 1 if G == B else G)
                    for k, fn in alone.items():
                        got, ref = fn(), whole[k]
                        if isinstance(got, tuple):
                            eq = all(torch.equal(g[0], w[r])
                                     for g, w in zip(got, ref))
                        else:
                            eq = torch.equal(got[0], ref[r])
                        same[k] = same.get(k, True) and eq
                line += (f"; rows {rows} alone = in the batch: "
                         + ", ".join(f"{k} {v}" for k, v in same.items()))
                del whole
            print(line, flush=True)
        del args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
