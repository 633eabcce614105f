"""Benchmark of the PyTorch port on one CUDA card: batched analyze +
resynthesis throughput, the counterpart of bench.py on the same fixtures.

    python scripts/port_bench.py [batch=128] [duration=8.0] [iters=3] \
        [repeats=16] [mxu=0]

Prints ONE JSON line with bench.py's keys:
  {"metric": ..., "value": N, "unit": "audio-sec/sec/gpu", "vs_baseline": N,
   "detail": {...}}
vs_baseline is value over BASELINE.json's north-star 500x realtime per
chip, as bench.py computes it.

Method: half the batch is bench.py's noisy fixtures (breath noise 0.05),
half clean (utils.testsig.make_test_utterances; one harmonic part).  The
library default (create_aoptions(f0_floor=70, use_pallas=True); mxu=1 sets
hm_kernel="matmul") runs once to build the kernels and warm the
allocator; then each of `iters` timings runs `repeats` batched_pipeline
steps back to back, the input perturbed by 1e-7 (i + 1) at step i as
bench.py perturbs it, with torch.cuda.synchronize() before the first and
after the last; the step time is the best timing over repeats.  The SNRs
are the per-row means over the steps of the last timing: clean rows
against their input, noisy rows against their clean harmonic part.  The
port imports no jax.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

BASELINE_X_REALTIME = 500.0


def main(batch=128, duration=8.0, iters=3, repeats=16, mxu=0):
    import torch

    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.parallel import corpus
    from libllsm2_tpu_torch.utils import testsig

    if not torch.cuda.is_available():
        raise SystemExit("port_bench.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    if mxu:
        opt = dataclasses.replace(opt, hm_kernel="matmul")
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)

    n_noisy = batch // 2           # rows [0, n_noisy) noisy, rest clean
    rows = testsig.make_test_utterances(
        [(i, 0.05 if i < n_noisy else 0.0) for i in range(batch)],
        duration=duration)
    x, f0, x_ref = (torch.tensor(np.stack([r[j] for r in rows]),
                                 dtype=torch.float32, device=dev)
                    for j in range(3))
    nxv = torch.full((batch,), x.shape[1], dtype=torch.int64, device=dev)

    def run():
        s = torch.zeros((batch,), dtype=torch.float64, device=dev)
        for i in range(repeats):
            _, snr, _ = corpus.batched_pipeline(
                opt, sopt, x + 1e-7 * (i + 1), f0, nxv, x_ref)
            s += snr
        return s / repeats

    run()                          # build the kernels, warm the allocator
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snr_rows = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    snr_rows = snr_rows.cpu().numpy()
    dt = min(times) / repeats
    value = batch * duration / dt
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(json.dumps({
        "metric": "batched analyze+resynth throughput",
        "value": round(value, 2),
        "unit": "audio-sec/sec/gpu",
        "vs_baseline": round(value / BASELINE_X_REALTIME, 3),
        "detail": {
            "batch": batch, "duration_s": duration,
            "best_step_s": round(dt, 6), "pallas": True,
            "steps_per_dispatch": repeats,
            "clean_roundtrip_snr_db": round(float(snr_rows[n_noisy:].mean()),
                                            2),
            "noisy_estimation_snr_db": round(float(snr_rows[:n_noisy].mean()),
                                             2),
            # bench.py's static constant (scripts/headroom.py, a CPU
            # experiment on the fixtures), not recomputed here
            "noisy_oracle_bound_db_static": 40.9,
            "device": torch.cuda.get_device_name(0),
            "card": smi.stdout.strip().splitlines()[0]
            if smi.returncode == 0 else "",
            "hm_kernel": opt.hm_kernel,
        },
    }))


if __name__ == "__main__":
    kw = {}
    for a in sys.argv[1:]:
        k, v = a.split("=")
        kw[k] = float(v) if "." in v else int(v)
    main(**kw)
