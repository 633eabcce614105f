"""The port's two remaining projection kernels and the paths that run
them, against the JAX package's Pallas branch (interpret mode on the
CPU): harmonic_project (the non-decimated F0 refine at an odd hop, the
non-cosine-window analysis), harmonic_project_mxu (hm_kernel="matmul"),
the resampler, the layer-0 round trip at 11 kHz and the public
analyze -> synthesize at 11.025 kHz.  Inputs are made with numpy from a
seed; each tolerance is stated where it is used."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu import config as jconfig
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.ops import harmonics as jhm
from libllsm2_tpu.ops import pallas_osc
from libllsm2_tpu.ops import resample as jrs
from libllsm2_tpu.parallel import corpus as jcorpus
from libllsm2_tpu.utils import testsig

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import (LAYER0_FIELDS, chunk_from_numpy,
                                          chunk_to_numpy)
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.ops import _build, kernels
from libllsm2_tpu_torch.ops import harmonics as thm
from libllsm2_tpu_torch.ops import resample as trs
from libllsm2_tpu_torch.parallel import corpus as tcorpus

from test_torch_layer0 import _jax_bins

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))


def _proj_rows(N, W, seed, lohi):
    """Random dc in +-2 cycles and windowed frames, zero outside [lo, hi)
    (test_pallas.py:35-47)."""
    rng = np.random.default_rng(seed)
    dc = rng.uniform(-2, 2, (N, W)).astype(np.float32)
    xw = rng.standard_normal((N, W)).astype(np.float32)
    if not lohi:
        return dc, xw, None, None
    lo = rng.integers(0, W // 3, N).astype(np.int32)
    hi = (lo + rng.integers(1, W - lo)).astype(np.int32)
    col = np.arange(W)[None, :]
    xw = np.where((col >= lo[:, None]) & (col < hi[:, None]), xw, 0.0)
    return dc, xw.astype(np.float32), lo, hi


@pytest.mark.parametrize("K,lohi", [(16, False), (16, True), (1, True),
                                    (1, False)])
def test_harmonic_project_plain_matches_pallas(K, lohi):
    """2e-3 absolute (test_pallas.py:46): the Pallas kernel rotates from
    cos/sin of the unreduced dc, the twin reduces k dc mod 1."""
    dc, xw, lo, hi = _proj_rows(9, 321, K, lohi)
    jkw = {} if lo is None else dict(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    re_j, im_j = pallas_osc.harmonic_project_pallas(jnp.asarray(dc),
                                                    jnp.asarray(xw), K, **jkw)
    tkw = {} if lo is None else dict(lo=T(lo), hi=T(hi))
    re, im = kernels.harmonic_project(T(dc), T(xw), K, **tkw)
    assert re.shape == (9, K) and im.shape == (9, K)
    np.testing.assert_allclose(re.numpy(), np.asarray(re_j), atol=2e-3)
    np.testing.assert_allclose(im.numpy(), np.asarray(im_j), atol=2e-3)


# the three conf shapes of test_pallas.py:56-58: default (hh = 10), a
# small window with an unvoiced tail (hh = 5), N below one frame block
MXU_SHAPES = [(0.6, 40.0, 0.0, True), (0.6, 90.0, 0.3, False),
              (0.12, 40.0, 0.0, True)]


def _analysis_inputs(dur, floor, tail, fs=16000.0):
    """Two utterances (seeds 8 and 9, noise 0.03) at create_aoptions(fs,
    f0_floor=floor) -> conf, x [2, nx], f0 [2, N], cyc [2, nx]."""
    conf = jpkg.create_aoptions(fs=fs, f0_floor=floor).conf
    rows = [testsig.make_test_utterance(duration=dur, fs=fs, seed=s,
                                        noise_level=0.03,
                                        unvoiced_tail_frac=tail)
            for s in (8, 9)]
    nfrm = len(rows[0][1])
    nx = nfrm * conf.nhop
    x = np.stack([r[0][:nx] for r in rows]).astype(np.float32)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    cyc = thm.sample_cycles(T(f0), conf.nhop, conf.fs, nx)
    return conf, x, f0, cyc


@pytest.mark.parametrize("dur,floor,tail,with_dc", MXU_SHAPES)
def test_harmonic_project_mxu_plain_matches_pallas(dur, floor, tail, with_dc):
    """The twin, which returns the sums at the frame centres, against the
    Pallas kernel per utterance rotated to the centres as the JAX
    harmonic_analysis rotates it (harmonics.py:206-210), on the main pass's
    inputs (halfwidths of harmonic_analysis); 2e-3 x the largest
    |re + j im| (test_pallas.py:79-85 in relative form: raw window sums
    scale with the window), the window sums to 1e-5 relative."""
    conf, x, f0, cyc = _analysis_inputs(dur, floor, tail)
    H, nhop, K = conf.halfwin_max, conf.nhop, conf.maxnhar
    f0s = np.where(f0 > 0, f0, 100.0)
    hw = np.clip(conf.rel_winsize * conf.fs / (2.0 * f0s), 2.0, float(H))
    if not with_dc:
        hw = np.where(f0 > 0, hw, 2.0)
    hw = hw.astype(np.float32)
    hh = -(-H // nhop)
    N = len(f0[0])
    re, im, ws, xs = kernels.harmonic_project_mxu(T(x), cyc, T(hw), K, nhop,
                                                  hh)
    assert re.shape == (2, N, K) and ws.shape == (2, N)
    kharm = jnp.arange(1, K + 1, dtype=jnp.float32)
    for b in range(2):
        cyc_j = jnp.asarray(cyc[b].numpy())
        rj, ij, wj, xj = pallas_osc.harmonic_project_mxu(
            jnp.asarray(x[b]), cyc_j, jnp.asarray(hw[b]), K, nhop, hh)
        ph_c = kharm[None, :] * cyc_j[::nhop][:N][:, None]
        ang_c = 2.0 * jnp.pi * (ph_c - jnp.round(ph_c))
        zj = np.asarray(rj * jnp.cos(ang_c) - ij * jnp.sin(ang_c)) \
            + 1j * np.asarray(rj * jnp.sin(ang_c) + ij * jnp.cos(ang_c))
        scale = float(np.abs(zj).max())
        np.testing.assert_allclose(re[b].numpy() + 1j * im[b].numpy(), zj,
                                   atol=2e-3 * scale)
        np.testing.assert_allclose(ws[b].numpy(), np.asarray(wj), rtol=1e-5)
        xj = np.asarray(xj)
        np.testing.assert_allclose(xs[b].numpy(), xj,
                                   atol=2e-3 * float(np.abs(xj).max()))


@pytest.mark.parametrize("variant,dur,floor,tail,with_dc", [
    ("mxu",) + s for s in MXU_SHAPES] + [
    ("mltsine", 0.6, 90.0, 0.3, True), ("mltsine", 0.12, 40.0, 0.0, False)])
def test_harmonic_analysis_branches_match(variant, dur, floor, tail, with_dc):
    """harmonic_analysis(mxu=True) and harmonic_analysis(window="mltsine")
    against the JAX function per utterance: amplitude within 2e-3 x scale,
    complex within 3e-3 x scale (test_pallas.py:79-85), mask equal, DC
    within 1e-6."""
    conf, x, f0, cyc = _analysis_inputs(dur, floor, tail)
    kw = dict(fs=conf.fs, max_k=conf.maxnhar, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize, fnyq=conf.fnyq, with_dc=with_dc)
    if variant == "mxu":
        kw["mxu"] = True
    else:
        kw["window"] = variant
    got = thm.harmonic_analysis(T(x), T(f0), cyc, nhop=conf.nhop, **kw)
    centers = jnp.arange(f0.shape[1], dtype=jnp.int32) * conf.nhop
    for b in range(2):
        ref = jhm.harmonic_analysis(jnp.asarray(x[b]), jnp.asarray(f0[b]),
                                    centers, jnp.asarray(cyc[b].numpy()),
                                    use_pallas=True, nhop=conf.nhop, **kw)
        a_j, p_j, m_j = map(np.asarray, ref[:3])
        a, p, m = (v[b].numpy() for v in got[:3])
        scale = float(np.abs(a_j).max())
        np.testing.assert_array_equal(m, m_j)
        np.testing.assert_allclose(a, a_j, atol=2e-3 * scale)
        np.testing.assert_allclose(a * np.exp(1j * p), a_j * np.exp(1j * p_j),
                                   atol=3e-3 * scale)
        if with_dc:
            np.testing.assert_allclose(got[3][b].numpy(), np.asarray(ref[3]),
                                       atol=1e-6)


@pytest.mark.parametrize("tail", [0.0, 0.3])
def test_refine_f0_full_rate_matches(tail):
    """At fs = 11000 the hop is 55 samples: no decimation D in 8/4/2
    divides it, so the JAX package runs its non-decimated branch through
    harmonic_project_pallas (K = 1); rtol 1e-4 (test_torch_ops.py:126-146),
    on a clean and a noisy row."""
    conf = jconfig.ChunkConf(fs=11000.0, fnyq=5500.0, f0_floor=90.0)
    assert conf.nhop == 55
    rows = [testsig.make_test_utterance(duration=0.4, fs=conf.fs, seed=s,
                                        noise_level=nl,
                                        unvoiced_tail_frac=tail)
            for s, nl in ((0, 0.0), (3, 0.05))]
    nhop, nfrm = conf.nhop, len(rows[0][1])
    x = np.stack([r[0][:nfrm * nhop] for r in rows]).astype(np.float32)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    kw = dict(fs=conf.fs, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    kernels.reset_launches()
    got = thm.refine_f0(T(x), T(f0), nhop=nhop, **kw).numpy()
    assert kernels.LAUNCHES["harmonic_project"] == 0   # CPU: the twin
    centers = jnp.arange(nfrm, dtype=jnp.int32) * nhop
    for b in range(2):
        ref = np.asarray(jhm.refine_f0(jnp.asarray(x[b]), jnp.asarray(f0[b]),
                                       centers, use_pallas=True, nhop=nhop,
                                       **kw))
        np.testing.assert_allclose(got[b], ref, rtol=1e-4)
        assert np.all(got[b][f0[b] == 0] == 0)
        assert not np.array_equal(got[b], f0[b])      # the refine moved it


@pytest.mark.parametrize("fs_in,fs_out,nx", [
    (16000.0, 44100.0, 4000), (44100.0, 16000.0, 11025),
    (11025.0, 11000.0, 11025),
    (48001.0, 48000.0, 9000),          # p q >= 2^31: the |q - p| ny branch
    (96001.0, 44100.0, 100000),        # neither: the re-approximation
    (11025.0, 11000.000000000002, 5000)])  # non-integral rate: sincresample
def test_resample_matches(fs_in, fs_out, nx):
    """resample_to (and through it rresample's three integer branches and
    sincresample) against the JAX module on two rows at once; atol 1e-5 x
    the peak (float32 weights and sums)."""
    rng = np.random.default_rng(int(fs_in) % 1000)
    t = np.arange(nx) / fs_in
    x = np.stack([np.sin(2 * np.pi * 440.0 * t) + 0.3 * np.sin(2 * np.pi * 3100.0 * t),
                  rng.standard_normal(nx)]).astype(np.float32)
    got = trs.resample_to(T(x), fs_in, fs_out).numpy()
    for b in range(2):
        ref = np.asarray(jrs.resample_to(jnp.asarray(x[b]), fs_in, fs_out))
        assert got[b].shape == ref.shape
        np.testing.assert_allclose(got[b], ref,
                                   atol=1e-5 * float(np.abs(x[b]).max()))
    ny = int(round(nx * fs_out / fs_in)) + 7
    got = trs.resample_to(T(x), fs_in, fs_out, ny=ny).numpy()
    ref = np.asarray(jrs.resample_to(jnp.asarray(x[1]), fs_in, fs_out, ny=ny))
    assert got.shape == (2, ny)
    np.testing.assert_allclose(got[1], ref, atol=1e-5 * float(np.abs(x[1]).max()))


@pytest.mark.parametrize("ratio", [44100 / 16000, 11000 / 11025,
                                   48000 / 48001, 0.7371, 3.3, 1e-5])
def test_best_rational_matches(ratio):
    """_best_rational is the JAX function (both packages then pick the same
    (p, q) and positions)."""
    assert trs._best_rational(ratio, 46000) == jrs._best_rational(ratio, 46000)


# the small verification shapes (SKILL.md) at 11 kHz: hop 55, so refine
# runs undecimated and the envelope pass at decimation 1
CONF11 = dict(fs=11000.0, maxnhar=24, npsd=32, nspec=65, f0_floor=90.0,
              fnyq=5500.0)
CONF16 = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
ROWS = ((0, 0.05), (1, 0.05), (2, 0.0))


def _round_trip_opts(pkg, case):
    conf = pkg.ChunkConf(**(CONF11 if case == "odd_hop_11k" else CONF16))
    opt = dataclasses.replace(pkg.create_aoptions(), conf=conf,
                              use_pallas=True)
    if case == "matmul_16k":
        opt = dataclasses.replace(opt, hm_kernel="matmul")
    sopt = dataclasses.replace(pkg.create_soptions(fs=conf.fs),
                               use_pallas=True)
    return opt, sopt


@pytest.mark.parametrize("case", ["odd_hop_11k", "matmul_16k"])
def test_round_trip_matches(case):
    """The library default (denoiser on) at an odd hop, and with
    hm_kernel="matmul", through _analyze and batched_pipeline, against the
    JAX Pallas branch on two noisy rows and a clean one: chunk fields as in
    test_torch_layer0.py (f0 rtol 1e-4, mask equal, tracks 1e-3 x scale,
    psd/edc rtol 1e-3) and per-row SNR within 0.05 dB.  The psd/edc floor
    is 2e-5 x the field's peak, not 1e-6: at 11 kHz the lowest noise
    channel's envelope is the harmonic band's cancellation residue (~3e-3
    of the peak), where the tracks' float32 differences (~3e-6 of the
    peak, measured) pass straight through."""
    jopt, jsopt = _round_trip_opts(jpkg, case)
    topt, tsopt = _round_trip_opts(tpkg, case)
    data = [testsig.make_test_utterance(duration=0.3, fs=topt.conf.fs, seed=s,
                                        noise_level=nl, return_parts=True)
            for s, nl in ROWS]
    x, f0, x_ref = (np.stack([d[j] for d in data]).astype(np.float32)
                    for j in range(3))
    tchunk = chunk_to_numpy(tl0._analyze(topt, T(x), T(f0)))
    for i in range(len(ROWS)):
        j = jl0._analyze_jit(jopt, jnp.asarray(x[i]), jnp.asarray(f0[i]))
        t = {f: v[i] for f, v in tchunk.items()}
        np.testing.assert_allclose(t["f0"], np.asarray(j.f0), rtol=1e-4)
        np.testing.assert_array_equal(t["hm_mask"], np.asarray(j.hm_mask))
        scale = float(np.abs(np.asarray(j.ampl)).max())
        np.testing.assert_allclose(t["ampl"], np.asarray(j.ampl),
                                   atol=1e-3 * scale)
        np.testing.assert_allclose(
            t["ampl"] * np.exp(1j * t["phse"]),
            np.asarray(j.ampl) * np.exp(1j * np.asarray(j.phse)),
            atol=1e-3 * scale)
        escale = float(np.abs(np.asarray(j.eenv_a)).max())
        np.testing.assert_allclose(
            t["eenv_a"] * np.exp(1j * t["eenv_p"]),
            np.asarray(j.eenv_a) * np.exp(1j * np.asarray(j.eenv_p)),
            atol=1e-3 * escale)
        for f in ("psd", "edc"):
            jv = np.asarray(getattr(j, f))
            np.testing.assert_allclose(t[f], jv, rtol=1e-3,
                                       atol=2e-5 * float(np.abs(jv).max()))
    nxv = np.full((len(ROWS),), x.shape[1], np.int32)
    _, jsnr, _ = jcorpus.batched_pipeline(jopt, jsopt, jnp.asarray(x),
                                          jnp.asarray(f0), jnp.asarray(nxv),
                                          jnp.asarray(x_ref))
    y, tsnr, _ = tcorpus.batched_pipeline(topt, tsopt, T(x), T(f0), T(nxv),
                                          T(x_ref))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    np.testing.assert_allclose(tsnr.numpy(), np.asarray(jsnr), atol=0.05)


def _opts_11025(pkg):
    opt = pkg.create_aoptions(fs=11025.0, maxnhar=24, npsd=32, nspec=65,
                              f0_floor=90.0, use_pallas=True)
    return opt, dataclasses.replace(pkg.create_soptions(fs=11025.0),
                                    use_pallas=True)


@pytest.mark.parametrize("seed,noise", [(0, 0.05), (2, 0.0)])
def test_public_api_at_11025_matches(seed, noise):
    """An 11.025 kHz file through the public analyze (input resampled to
    11000 Hz) and synthesize (rendered at 11000 Hz, every output resampled
    back): the port's chunk against the JAX package's as in
    test_round_trip_matches, then synthesis of the JAX chunk with the JAX
    noise bins injected: output length round(nfrm thop fs), y_sin within
    1e-3 and y_nos within 1e-4 (test_torch_layer0.py's tolerances)."""
    jopt, jsopt = _opts_11025(jpkg)
    topt, tsopt = _opts_11025(tpkg)
    assert topt.fs_input == 11025.0 and topt.conf.nhop == 55
    x, f0 = testsig.make_test_utterance(duration=0.3, fs=11025.0, seed=seed,
                                        noise_level=noise)
    x, f0 = x.astype(np.float32), f0.astype(np.float32)
    j = jl0.analyze(jopt, x, f0)
    t = chunk_to_numpy(tpkg.analyze(topt, x, f0, device="cpu"))
    np.testing.assert_allclose(t["f0"], np.asarray(j.f0), rtol=1e-4)
    np.testing.assert_array_equal(t["hm_mask"], np.asarray(j.hm_mask))
    scale = float(np.abs(np.asarray(j.ampl)).max())
    np.testing.assert_allclose(
        t["ampl"] * np.exp(1j * t["phse"]),
        np.asarray(j.ampl) * np.exp(1j * np.asarray(j.phse)), atol=1e-3 * scale)
    with pytest.raises(ValueError, match="resamples"):
        tl0._analyze(topt, T(x[None]), T(f0[None]))

    chunk = chunk_from_numpy(
        {f: np.asarray(getattr(j, f))[None] for f in LAYER0_FIELDS}, topt.conf,
        device="cpu")
    bins = _jax_bins(jsopt.noise_seed, chunk.nfrm, topt.conf.nhop + 1)
    out = tl0._synthesize(tsopt, chunk, bins=(bins[0][None], bins[1][None]))
    jout = jl0.synthesize(jsopt, j)
    ny = int(round(chunk.nfrm * topt.conf.thop * 11025.0))
    assert out.fs == 11025.0 and out.y.shape == (1, ny)
    assert np.asarray(jout.y_sin).shape == (ny,)
    np.testing.assert_allclose(out.y_sin[0].numpy(), np.asarray(jout.y_sin),
                               atol=1e-3)
    np.testing.assert_allclose(out.y_nos[0].numpy(), np.asarray(jout.y_nos),
                               atol=1e-4)
    np.testing.assert_allclose(out.y[0].numpy(), np.asarray(jout.y), atol=1e-3)
    single = tpkg.synthesize(tsopt, tpkg.analyze(topt, x, f0, device="cpu"))
    assert single.y.shape == (ny,) and bool(torch.isfinite(single.y).all())


def test_cpu_tensors_never_reach_the_new_kernels(monkeypatch):
    def no_build():
        raise AssertionError("CPU call reached the CUDA build")
    monkeypatch.setattr(_build, "library", no_build)
    kernels.reset_launches()
    dc, xw, lo, hi = _proj_rows(5, 40, 0, True)
    kernels.harmonic_project(T(dc), T(xw), 1, T(lo), T(hi))
    kernels.harmonic_project(T(dc), T(xw), 12)
    x = torch.rand(2, 400)
    kernels.harmonic_project_mxu(x, torch.rand(2, 400), 2.0 + 30 * torch.rand(2, 10),
                                 6, 40, 1)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    with pytest.raises(ValueError, match="cosine-series"):
        kernels.harmonic_project_mxu(x, x, torch.rand(2, 10), 6, 40, 1,
                                     window="mltsine")
