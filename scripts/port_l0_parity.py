"""The PyTorch port on the CPU against the JAX package on the CPU (Pallas
kernels in interpret mode) on the 16 kHz bench rows that chip_smoke.py
pins (phases 4 and 5), stage by stage:

  snr     batched_pipeline SNRs of rows 0, 1 (noisy) and 64 (clean) with the
          library default (create_aoptions(f0_floor=70, use_pallas=True))
          and of rows 0 and 1 with the denoiser off, from the port: on its
          own cycle track (sample_cycles, a float64 prefix sum), on the
          JAX package's (a float32 mod-1 scan, which drifts), and on the
          input scaled by 1 + 2^-22 (how far rounding alone moves them);
  stages  on one row, each analysis stage of both packages fed the SAME
          inputs (the JAX package's output of the stage before): refine_f0,
          harmonic_analysis, _deconv_correction, _track_denoise (its time
          gate and the spectral gate), the residual render; prints the
          largest difference of each stage's outputs, relative to their
          peak.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/port_l0_parity.py \
        [duration=8.0] [only=snr,stages] [row=0]
"""
import dataclasses
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import libllsm2_tpu as jpkg  # noqa: E402
from libllsm2_tpu.models import layer0 as jl0  # noqa: E402
from libllsm2_tpu.ops import harmonics as jhm  # noqa: E402
from libllsm2_tpu.utils import testsig  # noqa: E402

import libllsm2_tpu_torch as tpkg  # noqa: E402
from libllsm2_tpu_torch.models import layer0 as tl0  # noqa: E402
from libllsm2_tpu_torch.ops import harmonics as thm  # noqa: E402
from libllsm2_tpu_torch.parallel import corpus as tcorpus  # noqa: E402

ROWS = {0: 0.05, 1: 0.05, 64: 0.0}      # bench row -> noise level


def _rows(duration, rows):
    data = [testsig.make_test_utterance(duration=duration, seed=i,
                                        noise_level=ROWS[i], return_parts=True)
            for i in rows]
    return tuple(np.stack([d[j] for d in data]).astype(np.float32)
                 for j in range(3))


def _opts(pkg, **change):
    opt = dataclasses.replace(pkg.create_aoptions(f0_floor=70.0,
                                                  use_pallas=True), **change)
    return opt, dataclasses.replace(pkg.create_soptions(), use_pallas=True)


def _jax_cycles(f0, nhop, fs, nx):
    """The JAX package's own sample_cycles (its float32 mod-1 scan) on each
    row, in place of the port's float64 prefix sum."""
    return torch.stack([torch.tensor(np.asarray(jhm.sample_cycles(
        jnp.asarray(r.numpy()), nhop, fs, nx))) for r in f0])


def port_snr(duration, jax_cycles=False, nudge=0.0):
    """The port's SNRs; with jax_cycles, on the JAX package's cycle track;
    with nudge, on x scaled by (1 + nudge) (a rounding-level change)."""
    x, f0, x_ref = _rows(duration, list(ROWS))
    x = (x * np.float32(1.0 + nudge)).astype(np.float32)
    out = {}
    own = thm.sample_cycles
    if jax_cycles:
        thm.sample_cycles = _jax_cycles
    try:
        for label, change, n in (("library default", {}, 3),
                                 ("denoiser off", dict(track_denoise=False),
                                  2)):
            opt, sopt = _opts(tpkg, **change)
            nxv = torch.full((n,), x.shape[1], dtype=torch.int64)
            _, snr, _ = tcorpus.batched_pipeline(
                opt, sopt, *(torch.tensor(a[:n]) for a in (x, f0)), nxv,
                torch.tensor(x_ref[:n]))
            out[label] = dict(zip(list(ROWS)[:n], snr.tolist()))
    finally:
        thm.sample_cycles = own
    return out


def _rel(a, b):
    a, b = np.asarray(a).astype(complex), np.asarray(b).astype(complex)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def stages(duration, row):
    """Each stage of the analysis, both packages on the JAX package's inputs
    to it -> {stage: max |port - JAX| / max |JAX|}."""
    x, f0, _ = _rows(duration, [row])
    x, f0 = x[0], f0[0]
    jopt, _ = _opts(jpkg)
    topt, _ = _opts(tpkg)
    conf = jopt.conf
    nhop = conf.nhop
    N = len(f0)
    nx = N * nhop
    T = lambda a: torch.tensor(np.asarray(a))[None]
    out = {}
    # refine_f0
    jf = jhm.refine_f0(jnp.asarray(x), jnp.asarray(f0),
                       jnp.arange(N, dtype=jnp.int32) * nhop, nhop=nhop,
                       fs=conf.fs, halfwin_max=conf.halfwin_max,
                       rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil,
                       use_pallas=True)
    tf = thm.refine_f0(T(x), T(f0), nhop=nhop, fs=conf.fs,
                       halfwin_max=conf.halfwin_max,
                       rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    out["refine_f0"] = _rel(tf[0], jf)
    # the JAX analysis's own intermediates from here on
    jc = jl0._analyze_jit(jopt, jnp.asarray(x), jnp.asarray(f0))
    tc = tl0._analyze(topt, T(x), T(f0))
    for f in ("f0", "ampl", "psd", "edc", "eenv_a"):
        out[f"chunk {f}"] = _rel(getattr(tc, f)[0], getattr(jc, f))
    z = lambda a, p: np.asarray(a) * np.exp(1j * np.asarray(p))
    out["chunk ampl e^{j phse}"] = _rel(
        z(tc.ampl[0], tc.phse[0]), z(jc.ampl, jc.phse))
    # harmonic_analysis on the JAX chunk's f0
    jf0 = np.asarray(jc.f0)
    cyc = thm.sample_cycles(T(jf0), nhop, conf.fs, nx)
    jcyc_own = np.asarray(jhm.sample_cycles(jnp.asarray(jf0), nhop, conf.fs,
                                            nx))
    d = np.asarray(cyc[0], np.float64) - jcyc_own
    out["sample_cycles (cycles)"] = float(np.max(np.abs(d - np.round(d))))
    kw = dict(nhop=nhop, fs=conf.fs, max_k=conf.maxnhar,
              halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
              fnyq=conf.fnyq)
    ta, tp, tm = thm.harmonic_analysis(T(x), T(jf0), cyc, **kw)
    ja, jp, jm = jhm.harmonic_analysis(
        jnp.asarray(x), jnp.asarray(jf0), jnp.arange(N, dtype=jnp.int32) * nhop,
        jnp.asarray(cyc[0].numpy()), use_pallas=True, **kw)
    out["harmonic_analysis"] = _rel(z(ta[0], tp[0]), z(ja, jp))
    # deconvolution on the JAX tracks
    ja_, jp_, jm_ = (np.asarray(v) for v in (ja, jp, jm))
    tcx = tl0._deconv_correction(topt, T(jf0), cyc, T(ja_), T(jp_), T(jm_),
                                 return_complex=True)
    centers = jnp.arange(N, dtype=jnp.int32) * nhop
    jcyc = jnp.asarray(cyc[0].numpy())
    jcx = jl0._deconv_correction(jopt, jnp.asarray(jf0), centers, jcyc,
                                 jnp.asarray(ja_), jnp.asarray(jp_),
                                 jnp.asarray(jm_), return_complex=True)
    out["_deconv_correction"] = _rel(
        tcx[0][0].numpy() + 1j * tcx[1][0].numpy(),
        np.asarray(jcx[0]) + 1j * np.asarray(jcx[1]))
    # the denoiser on the JAX complex track
    cyc_c = cyc[..., ::nhop][..., :N]
    jre, jim = (np.asarray(v) for v in jcx)
    dn = dict(cutoff_hz=jopt.track_denoise_hz,
              strength=jopt.track_denoise_strength)
    for label, spectral in (("time gate", False), ("spectral gate", True)):
        ta2, tp2 = tl0._track_denoise(
            topt.conf, T(jf0), cyc_c, T(ja_), T(jp_), T(jm_), **dn,
            spectral=spectral, a_spec=topt.track_spectral_strength,
            spec_decimate=topt.track_spectral_decimate,
            c_complex=(T(jre), T(jim)))
        ja2, jp2 = jl0._track_denoise(
            jopt.conf, jnp.asarray(jf0), jcyc, centers, jnp.asarray(ja_),
            jnp.asarray(jp_), jnp.asarray(jm_), **dn,
            use_pallas=True, spectral=spectral,
            a_spec=jopt.track_spectral_strength,
            spec_decimate=jopt.track_spectral_decimate,
            c_complex=(jnp.asarray(jre), jnp.asarray(jim)))
        out[f"_track_denoise ({label})"] = _rel(z(ta2[0], tp2[0]),
                                               z(ja2, jp2))
    return out


def main():
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    duration = float(kw.get("duration", 8.0))
    only = kw.get("only", "snr,stages").split(",")
    torch.set_num_threads(4)
    if "snr" in only:
        for jc, nudge, what in (
                (False, 0.0, ""),
                (True, 0.0, " on the JAX package's cycle track"),
                (False, 2.0 ** -22, " on x (1 + 2^-22)")):
            t0 = time.perf_counter()
            print(f"port on the CPU, 16 kHz batched_pipeline at {duration} s"
                  f"{what}:", port_snr(duration, jc, nudge),
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if "stages" in only:
        t0 = time.perf_counter()
        row = int(kw.get("row", 0))
        for k, v in stages(duration, row).items():
            print(f"row {row} {k}: max |port - JAX| / max |JAX| = {v:.3e}",
                  flush=True)
        print(f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
