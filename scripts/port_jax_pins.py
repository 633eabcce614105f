"""The JAX package's own SNRs on the configurations that chip_smoke.py
drives through the PyTorch port (its phases 7 to 10), on the CPU with the
Pallas kernels in interpret mode:

  odd hop   batched_pipeline, create_aoptions(fs=11000, f0_floor=70,
            use_pallas=True) with create_soptions(fs=11000, use_pallas=True),
            on the bench seeds of noisy rows 0 and 1 and clean row 64
            (noise level 0.05 / 0), made at fs = 11000;
  11025 Hz  the public analyze -> synthesize at fs = 11025 (input and
            output resampled) on one noisy (seed 0) and one clean (seed 64)
            1 s row made at 11025 Hz: the SNR of y_sin against the clean
            harmonic part, OLA edges excluded;
  layer 1   create_aoptions(f0_floor=70, use_pallas=True) analysis of the
            bench rows 0, 1 (noisy) and 64 (clean) at 16 kHz, then
            chunk_to_layer1 -> chunk_to_layer0 -> synthesize: the SNR of
            y_sin against the clean harmonic part, OLA edges excluded;
  PbP       the same analysis of LF rows 0 and 1 (synth_lf_speech, Rd 0.4
            and 1.0, seeds 0 and 1, make_f0_track's default contour), then
            chunk_to_layer1 -> pbp_synthesize: the SNR of PbP y_sin against
            the layer-1 sinusoidal y_sin (synthesize(chunk_to_layer0(l1))).

    JAX_PLATFORMS=cpu python scripts/port_jax_pins.py [duration=8.0] \
        [only=11k,l1,pbp]
"""
import dataclasses
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from libllsm2_tpu import create_aoptions, create_soptions  # noqa: E402
from libllsm2_tpu.models import layer0, layer1, pbp  # noqa: E402
from libllsm2_tpu.parallel import corpus  # noqa: E402
from libllsm2_tpu.utils import testsig  # noqa: E402

ROWS = {0: 0.05, 1: 0.05, 64: 0.0}      # bench row -> noise level
LF_RD = (0.4, 1.0, 1.8, 2.7)            # chip_smoke.py phase 10: Rd of row i % 4


def snr_db(ref, y, fs, f0_floor):
    """chip_smoke.py's phase-8 SNR: y against ref over the common length,
    minus an OLA margin of min(2 fs / f0_floor, n / 4) at both ends."""
    n = min(len(ref), len(y))
    m = min(int(2.0 * fs / f0_floor), n // 4)
    err = ref[m:n - m] - y[m:n - m]
    return 10.0 * np.log10(np.sum(ref[m:n - m] ** 2) / max(np.sum(err ** 2),
                                                           1e-12))


def odd_hop(duration):
    opt = create_aoptions(fs=11000.0, f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(fs=11000.0), use_pallas=True)
    rows = [testsig.make_test_utterance(duration=duration, fs=11000.0,
                                        seed=i, noise_level=nl,
                                        return_parts=True)
            for i, nl in ROWS.items()]
    x, f0, x_ref = (np.stack([r[j] for r in rows]).astype(np.float32)
                    for j in range(3))
    nxv = np.full((len(rows),), x.shape[1], np.int32)
    _, snr, _ = corpus.batched_pipeline(opt, sopt, jnp.asarray(x),
                                        jnp.asarray(f0), jnp.asarray(nxv),
                                        jnp.asarray(x_ref))
    return dict(zip(ROWS, np.asarray(snr).tolist()))


def public_11025():
    fs = 11025.0
    opt = create_aoptions(fs=fs, f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(fs=fs), use_pallas=True)
    out = {}
    for seed, nl in ((0, 0.05), (64, 0.0)):
        x, f0, x_ref = testsig.make_test_utterance(
            duration=1.0, fs=fs, seed=seed, noise_level=nl, return_parts=True)
        chunk = layer0.analyze(opt, x.astype(np.float32), f0.astype(np.float32))
        res = layer0.synthesize(sopt, chunk)
        y_sin = np.asarray(res.y_sin, np.float64)
        out[seed] = dict(len=len(y_sin),
                         snr=snr_db(x_ref, y_sin, fs, opt.conf.f0_floor))
    return out


def _opts16():
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    return opt, dataclasses.replace(create_soptions(), use_pallas=True)


def layer1_round_trip(duration):
    opt, sopt = _opts16()
    out = {}
    for i, nl in ROWS.items():
        x, f0, x_ref = testsig.make_test_utterance(
            duration=duration, seed=i, noise_level=nl, return_parts=True)
        ch = layer0.analyze(opt, x.astype(np.float32), f0.astype(np.float32))
        back = layer1.chunk_to_layer0(layer1.chunk_to_layer1(ch))
        y_sin = np.asarray(layer0.synthesize(sopt, back).y_sin, np.float64)
        out[i] = snr_db(x_ref, y_sin, opt.conf.fs, opt.conf.f0_floor)
    return out


def pbp_rows(duration):
    opt, sopt = _opts16()
    nfrm = int(round(duration / opt.conf.thop))
    out = {}
    for i in (0, 1):
        f0 = testsig.make_f0_track(nfrm, opt.conf.thop)
        x, f0 = testsig.synth_lf_speech(f0, rd=LF_RD[i % 4], seed=i)
        l1 = layer1.chunk_to_layer1(layer0.analyze(
            opt, x.astype(np.float32), f0.astype(np.float32)))
        y_sin = np.asarray(layer0.synthesize(
            sopt, layer1.chunk_to_layer0(l1)).y_sin, np.float64)
        y_pbp = np.asarray(pbp.pbp_synthesize(sopt, l1).y_sin, np.float64)
        v = np.asarray(l1.rd)[np.asarray(l1.f0) > 0]
        out[i] = dict(snr=snr_db(y_sin, y_pbp, opt.conf.fs, opt.conf.f0_floor),
                      rd_median=float(np.median(v)))
    return out


def main():
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    duration = float(kw.get("duration", 8.0))
    only = kw.get("only", "11k,l1,pbp").split(",")
    if "11k" in only:
        t0 = time.perf_counter()
        print("11025 Hz public analyze -> synthesize:", public_11025(),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        print(f"odd hop batched_pipeline at {duration} s:", odd_hop(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "l1" in only:
        t0 = time.perf_counter()
        print(f"layer-1 round trip at {duration} s:",
              layer1_round_trip(duration),
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "pbp" in only:
        t0 = time.perf_counter()
        print(f"PbP against the layer-1 sinusoidal render at {duration} s:",
              pbp_rows(duration), f"({time.perf_counter() - t0:.1f} s)",
              flush=True)

if __name__ == "__main__":
    main()
