"""The analysis and synthesis options of the PyTorch port that the JAX
package's library default and its methods take, against the JAX package
on the CPU: the plain (use_pallas=False) branches stage by stage and the
whole round trip, FFT peak-picking (hm_method="pp"), Gauss-Seidel passes
and hm_correction="none", chunked framing (frame_chunk), gather framing
at non-uniform centres, and noise_idft="fft"; then tests/test_methods.py's
floors, its finite-gradient and no-NaN cases, and
test_layer0.py's Gauss-Seidel and iDFT-equality cases on the port.  Small
verification shapes unless a floor names its own; each test states its
tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.ops import harmonics as jhm
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import Chunk
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.ops import harmonics as thm
from libllsm2_tpu_torch.ops import kernels
from libllsm2_tpu_torch.utils import metrics

torch.set_num_threads(1)

CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
FIELDS = ("f0", "ampl", "phse", "hm_mask", "psd", "edc", "eenv_a", "eenv_p")


def snr_db(ref, est):
    """tests/test_layer0.py's SNR: 5-95 % of the common length."""
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    n = min(len(ref), len(est))
    lo, hi = int(0.05 * n), int(0.95 * n)
    e = ref[lo:hi] - est[lo:hi]
    return 10 * np.log10(np.sum(ref[lo:hi] ** 2) / max(np.sum(e ** 2), 1e-20))


def _fixture(duration=0.3, noise_level=0.05, seed=0):
    x, f0 = jts.make_test_utterance(duration=duration, seed=seed,
                                    noise_level=noise_level)
    return x.astype(np.float32), f0.astype(np.float32)


def _small(pkg, **change):
    return dataclasses.replace(pkg.create_aoptions(),
                               conf=pkg.ChunkConf(**CONF), **change)


def _close(t, j, rel, names=FIELDS):
    """Every field of the port's batch-of-one chunk t within rel of the
    largest |value| of the JAX chunk j's field (the phases as the complex
    tracks with their amplitudes)."""
    amp = dict(phse="ampl", eenv_p="eenv_a")
    for name in names:
        r = np.asarray(getattr(j, name))
        g = getattr(t, name)[0].numpy()
        if name in amp:
            g = getattr(t, amp[name])[0].numpy() * np.exp(1j * g)
            r = np.asarray(getattr(j, amp[name])) * np.exp(1j * r)
        np.testing.assert_allclose(g, r, atol=rel * max(np.abs(r).max(),
                                                        1e-12), err_msg=name)


def _analysis_inputs(conf, x, f0):
    """Refined F0 and its cycle track, made by the JAX package (so both
    packages project the same track)."""
    nhop = conf.nhop
    xj = jnp.asarray(x)
    centers = jnp.arange(len(f0), dtype=jnp.int32) * nhop
    f0r = jhm.refine_f0(xj, jnp.asarray(f0), centers, fs=conf.fs,
                        halfwin_max=conf.halfwin_max,
                        rel_winsize=conf.rel_winsize, nhop=nhop)
    cyc = jhm.sample_cycles(f0r, nhop, conf.fs, len(f0) * nhop)
    return xj, f0r, centers, cyc


@pytest.mark.parametrize("with_dc", [False, True])
def test_plain_projection_matches_jax(with_dc):
    """harmonic_analysis(use_pallas=False), the jnp per_chunk projection,
    at uniform centres and at the JAX package's gather centres: ampl,
    phse (as the complex track) and the DC within 1e-4 of the largest
    amplitude."""
    conf = jpkg.ChunkConf(**CONF)
    x, f0 = _fixture()
    xj, f0r, centers, cyc = _analysis_inputs(conf, x, f0)
    kw = dict(fs=conf.fs, max_k=conf.maxnhar, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize, fnyq=conf.fnyq, with_dc=with_dc)
    ref = jhm.harmonic_analysis(xj, f0r, centers, cyc, **kw)
    T = lambda a: torch.tensor(np.asarray(a))[None]
    for cent in (None, torch.tensor(np.asarray(centers))):
        got = thm.harmonic_analysis(T(xj), T(f0r), T(cyc), nhop=conf.nhop,
                                    use_pallas=False, centers=cent, **kw)
        scale = float(np.abs(np.asarray(ref[0])).max())
        tc = got[0][0].numpy() * np.exp(1j * got[1][0].numpy())
        jc = np.asarray(ref[0]) * np.exp(1j * np.asarray(ref[1]))
        np.testing.assert_allclose(tc, jc, atol=1e-4 * scale)
        if with_dc:
            np.testing.assert_allclose(got[3][0].numpy(), np.asarray(ref[3]),
                                       atol=1e-4 * scale)


def test_gather_framing_matches_jax():
    """harmonic_analysis at non-uniform centres with the kernels on
    (frames gathered, windowed here, kernels.harmonic_project's twin on
    the CPU) against the JAX package's gather branch (nhop=None, Pallas in
    interpret mode), jittered centres: within 1e-4 of the largest
    amplitude; and at uniform centres it equals the fused path within
    1e-4."""
    conf = jpkg.ChunkConf(**CONF)
    x, f0 = _fixture()
    xj, f0r, centers, cyc = _analysis_inputs(conf, x, f0)
    jit = np.random.default_rng(3).integers(-7, 8, len(f0))
    cent = np.clip(np.asarray(centers) + jit, 0, len(x) - 1).astype(np.int32)
    kw = dict(fs=conf.fs, max_k=conf.maxnhar, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize, fnyq=conf.fnyq)
    ref = jhm.harmonic_analysis(xj, f0r, jnp.asarray(cent), cyc,
                                use_pallas=True, **kw)
    T = lambda a: torch.tensor(np.asarray(a))[None]
    got = thm.harmonic_analysis(T(xj), T(f0r), T(cyc), nhop=conf.nhop,
                                centers=torch.tensor(cent), **kw)
    scale = float(np.abs(np.asarray(ref[0])).max())
    np.testing.assert_allclose(
        got[0][0].numpy() * np.exp(1j * got[1][0].numpy()),
        np.asarray(ref[0]) * np.exp(1j * np.asarray(ref[1])),
        atol=1e-4 * scale)
    uni = thm.harmonic_analysis(T(xj), T(f0r), T(cyc), nhop=conf.nhop,
                                centers=torch.tensor(np.asarray(centers)),
                                **kw)
    fused = thm.harmonic_analysis(T(xj), T(f0r), T(cyc), nhop=conf.nhop,
                                  **kw)
    np.testing.assert_allclose(torch.polar(*uni[:2]).numpy(),
                               torch.polar(*fused[:2]).numpy(),
                               atol=1e-4 * scale)


@pytest.mark.parametrize("window,fc", [("hanning", 16), ("hanning", 7),
                                       ("mltsine", 16)])
def test_frame_chunk_equals_unchunked(window, fc):
    """harmonic_analysis(frame_chunk=fc) with the kernels on (their twins
    on the CPU), two rows, the fused window and the framed (mltsine)
    path, with the DC: ampl, phse and the DC within 1e-6 of the unchunked
    call's largest value."""
    conf = tpkg.ChunkConf(**CONF)
    rows = [_fixture(seed=s) for s in (0, 1)]
    x = torch.tensor(np.stack([r[0] for r in rows]))
    f0 = torch.tensor(np.stack([r[1] for r in rows]))
    cyc = thm.sample_cycles(f0, conf.nhop, conf.fs, x.shape[-1])
    kw = dict(nhop=conf.nhop, fs=conf.fs, max_k=conf.maxnhar,
              halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
              fnyq=conf.fnyq, window=window, with_dc=True)
    whole = thm.harmonic_analysis(x, f0, cyc, **kw)
    chunked = thm.harmonic_analysis(x, f0, cyc, frame_chunk=fc, **kw)
    for a, b in zip(whole, chunked):
        np.testing.assert_allclose(b.numpy(), a.numpy(),
                                   atol=1e-6 * float(a.abs().max()))


@pytest.mark.parametrize("centers", [False, True])
def test_peak_pick_matches_jax(centers):
    """harmonic_peak_pick at uniform centres (hop-block frames) and at the
    gather centres: ampl and the complex track within 1e-4 of the largest
    amplitude."""
    conf = jpkg.ChunkConf(**CONF)
    x, f0 = _fixture()
    xj, f0r, cent, _ = _analysis_inputs(conf, x, f0)
    kw = dict(fs=conf.fs, max_k=conf.maxnhar, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize, fnyq=conf.fnyq)
    ref = jhm.harmonic_peak_pick(xj, f0r, cent,
                                 nhop=None if centers else conf.nhop, **kw)
    T = lambda a: torch.tensor(np.asarray(a))[None]
    got = thm.harmonic_peak_pick(
        T(xj), T(f0r), nhop=conf.nhop,
        centers=torch.tensor(np.asarray(cent)) if centers else None, **kw)
    scale = float(np.abs(np.asarray(ref[0])).max())
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(
        got[0][0].numpy() * np.exp(1j * got[1][0].numpy()),
        np.asarray(ref[0]) * np.exp(1j * np.asarray(ref[1])),
        atol=1e-4 * scale)


def test_plain_refine_and_render_match_jax():
    """refine_f0(use_pallas=False), the full-rate jnp probes, within 1e-4
    relative; the plain oscillator bank and its OLA within 1e-5 of the
    signal's peak."""
    conf = jpkg.ChunkConf(**CONF)
    x, f0 = _fixture()
    nhop = conf.nhop
    centers = jnp.arange(len(f0), dtype=jnp.int32) * nhop
    kw = dict(fs=conf.fs, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize)
    ref = np.asarray(jhm.refine_f0(jnp.asarray(x), jnp.asarray(f0), centers,
                                   nhop=nhop, **kw))
    got = thm.refine_f0(torch.tensor(x)[None], torch.tensor(f0)[None],
                        nhop=nhop, use_pallas=False, **kw)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    ch = jl0._analyze_jit(_small(jpkg), jnp.asarray(x), jnp.asarray(f0))
    cyc = jhm.sample_cycles(ch.f0, nhop, conf.fs, len(f0) * nhop)
    segs = jhm.oscillator_bank(cyc, centers, ch.ampl, ch.phse, ch.hm_mask,
                               nhop=nhop)
    y_j = np.asarray(jhm.overlap_add_half(segs, nhop, len(x)))
    T = lambda a: torch.tensor(np.asarray(a))[None]
    y_t = thm.overlap_add_half(thm.oscillator_bank(
        T(cyc), T(ch.ampl), T(ch.phse), T(ch.hm_mask), nhop=nhop), nhop,
        len(x))[0].numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-5 * np.abs(y_j).max())


@pytest.mark.parametrize("complex_in", [False, True])
@pytest.mark.parametrize("spectral", [False, True])
def test_plain_deconv_and_denoiser_match_jax(complex_in, spectral):
    """_deconv_correction and _track_denoise with the kernels off (the JAX
    package's jnp branches, with and without the complex handoff and the
    spectral gate) on a JAX single-pass analysis of a 0.6 s noisy
    fixture: within 1e-4 (deconv) and 1e-3 (denoiser, as test_torch_
    layer0's chunk) of the largest amplitude."""
    opt_j = _small(jpkg, use_pallas=False, track_denoise_spectral=spectral)
    opt_t = _small(tpkg, use_pallas=False, track_denoise_spectral=spectral)
    conf = opt_j.conf
    x, f0 = _fixture(duration=0.6, noise_level=0.1)
    xj, f0r, centers, cyc = _analysis_inputs(conf, x, f0)
    a, p, m = jhm.harmonic_analysis(
        xj, f0r, centers, cyc, fs=conf.fs, max_k=conf.maxnhar,
        halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
        fnyq=conf.fnyq)
    T = lambda v: torch.tensor(np.asarray(v))[None]
    dj = jl0._deconv_correction(opt_j, f0r, centers, cyc, a, p, m,
                                return_complex=complex_in)
    dt = tl0._deconv_correction(opt_t, T(f0r), T(cyc), T(a), T(p), T(m),
                                return_complex=complex_in)
    scale = float(np.abs(np.asarray(a)).max())
    for u, v in zip(dt, dj):
        np.testing.assert_allclose(u[0].numpy(), np.asarray(v),
                                   atol=1e-4 * scale)
    kw = dict(spectral=spectral, a_spec=opt_j.track_spectral_strength,
              spec_decimate=opt_j.track_spectral_decimate)
    # the complex handoff passes the track as c_complex, no (ampl, phse)
    jin, tin = ((None, None), (None, None)) if complex_in else (dj, dt)
    ja, jp = jl0._track_denoise(conf, f0r, cyc, centers, *jin, m, 15.0, 8.0,
                                c_complex=dj if complex_in else None, **kw)
    ta, tp = tl0._track_denoise(
        conf, T(f0r), T(cyc)[..., ::conf.nhop], *tin, T(m), 15.0, 8.0,
        use_pallas=False, c_complex=dt if complex_in else None, **kw)
    np.testing.assert_allclose(
        ta[0].numpy() * np.exp(1j * tp[0].numpy()),
        np.asarray(ja) * np.exp(1j * np.asarray(jp)), atol=1e-3 * scale)


@pytest.mark.parametrize("change", [
    dict(), dict(hm_method="pp"), dict(hm_passes=2, hm_correction="none"),
    dict(track_lowpass_hz=30.0), dict(track_spectral_decimate=1)])
def test_library_default_analysis_matches_jax(change):
    """_analyze with the library default (use_pallas=False) and its
    options against the JAX package's jnp branches on a noisy fixture:
    every field within 1e-3 of its largest value (the complex track for
    phse)."""
    x, f0 = _fixture()
    j = jl0._analyze_jit(_small(jpkg, **change), jnp.asarray(x),
                         jnp.asarray(f0))
    t = tl0._analyze(_small(tpkg, **change), torch.tensor(x)[None],
                     torch.tensor(f0)[None])
    _close(t, j, 1e-3)


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("idft", ["matmul", "fft"])
def test_synthesis_options_match_jax(kernels_on, idft):
    """_synthesize of a JAX chunk with the kernels on or off and either
    band iDFT, each package drawing its own noise (the port's draw equals
    jax.random's within 1e-6): y_sin within 1e-5 of its peak, y_nos
    within 1e-4 of its rms; no kernel launches on the CPU."""
    x, f0 = _fixture()
    j = jl0._analyze_jit(_small(jpkg), jnp.asarray(x), jnp.asarray(f0))
    tch = Chunk(conf=tpkg.ChunkConf(**CONF), **{
        f: torch.tensor(np.asarray(getattr(j, f)))[None] for f in FIELDS})
    change = dict(use_pallas=kernels_on, noise_idft=idft)
    jr = jl0._synthesize_jit(
        dataclasses.replace(jpkg.create_soptions(), **change), j)
    kernels.reset_launches()
    tr = tl0._synthesize(
        dataclasses.replace(tpkg.create_soptions(), **change), tch)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    ys, yn = np.asarray(jr.y_sin), np.asarray(jr.y_nos)
    np.testing.assert_allclose(tr.y_sin[0].numpy(), ys,
                               atol=1e-5 * np.abs(ys).max())
    np.testing.assert_allclose(tr.y_nos[0].numpy(), yn,
                               atol=1e-4 * np.sqrt(np.mean(yn ** 2)))


@pytest.mark.parametrize("fs", [16000.0, 48000.0])
def test_fft_synthesis_at_a_20_ms_hop_matches_jax(fs):
    """_synthesize with noise_idft="fft" and the kernels on, of a JAX chunk
    analysed at a 20 ms hop (hop 320 at 16 kHz; hop 960 at 48 kHz, where
    on the card the cycle track runs its long-hop kernel and the segment
    entry its 16-byte path), against the JAX package's (its Pallas kernel
    in interpret mode): y_nos within 1e-4 of its rms, as
    test_synthesis_options_match_jax; y_sin within 5e-5 of its peak (the
    JAX package's float32 cycle track drifts with the hop: 1.3e-5 at hop
    320 and 1.7e-5 at hop 960 from the port's float64 sums, the plain
    branches alike); no kernel launches on the CPU."""
    conf = dict(CONF, fs=fs, thop=0.02)
    x, f0 = jts.make_test_utterance(duration=0.6, fs=fs, thop=0.02, seed=3,
                                    noise_level=0.05)
    x, f0 = x.astype(np.float32), f0.astype(np.float32)
    jopt = dataclasses.replace(jpkg.create_aoptions(),
                               conf=jpkg.ChunkConf(**conf))
    j = jl0._analyze_jit(jopt, jnp.asarray(x), jnp.asarray(f0))
    tch = Chunk(conf=tpkg.ChunkConf(**conf), **{
        f: torch.tensor(np.asarray(getattr(j, f)))[None] for f in FIELDS})
    assert tch.conf.nhop == int(0.02 * fs)
    change = dict(use_pallas=True, noise_idft="fft")
    jr = jl0._synthesize_jit(
        dataclasses.replace(jpkg.create_soptions(fs=fs), **change), j)
    kernels.reset_launches()
    tr = tl0._synthesize(
        dataclasses.replace(tpkg.create_soptions(fs=fs), **change), tch)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    ys, yn = np.asarray(jr.y_sin), np.asarray(jr.y_nos)
    assert tr.y_nos.shape[-1] == len(yn) == len(f0) * tch.conf.nhop
    np.testing.assert_allclose(tr.y_sin[0].numpy(), ys,
                               atol=5e-5 * np.abs(ys).max())
    np.testing.assert_allclose(tr.y_nos[0].numpy(), yn,
                               atol=1e-4 * np.sqrt(np.mean(yn ** 2)))


def test_segment_entry_twin_equals_the_fused_twin():
    """kernels.noise_mod_ola_seg (its twin on the CPU) on the matmul
    segments equals noise_mod_ola on the same spectra within 1e-6 of the
    output's peak: the same OLA, modulation and band sum."""
    x, f0 = _fixture()
    ch = tl0._analyze(_small(tpkg), torch.tensor(x)[None],
                      torch.tensor(f0)[None])
    conf = ch.conf
    nhop = conf.nhop
    cyc = thm.sample_cycles(ch.f0, nhop, conf.fs, ch.nfrm * nhop)
    coefs = tl0._env_coefs(ch, cyc[..., ::nhop])
    nbin = nhop + 1
    re, im = kernels.noise_bins(7, 0, 1, ch.nfrm, nbin, cyc.device)
    gain = torch.rand((1, ch.nfrm, nbin), generator=torch.Generator()
                      .manual_seed(0))
    bands = kernels.band_ranges(nbin, conf.fs, tuple(conf.chan_edges))
    fused = kernels.noise_mod_ola(cyc, *coefs, re, im, gain, bands)
    T = 2 * nhop
    sc = torch.full((nbin,), (T / 2.0) ** 0.5)
    sc[0] = sc[-1] = T ** 0.5
    sci = sc.clone()
    sci[0] = sci[-1] = 0.0
    k = torch.arange(nbin)
    masks = torch.stack([((k >= lo) & (k < hi)).float()
                         for lo, hi in zip(bands[::2], bands[1::2])])
    w = torch.sqrt(0.5 - 0.5 * torch.cos(2 * np.pi * (torch.arange(T) + 0.5)
                                         / T))
    for idft in ("matmul", "fft"):
        segs = tl0._band_segments(torch.complex(re * sc, im * sci) * gain,
                                  masks, w, T, idft)
        y = kernels.noise_mod_ola_seg(cyc, *coefs, segs)
        np.testing.assert_allclose(y.numpy(), fused.numpy(),
                                   atol=1e-6 * float(fused.abs().max()))


# tests/test_methods.py and test_layer0.py's floors on the port, at the
# library default (use_pallas=False) and the full ChunkConf

def test_peak_picking_method_roundtrip():
    x, f0 = jts.make_test_utterance(duration=0.6)
    opt = dataclasses.replace(tpkg.create_aoptions(), hm_method="pp")
    out = tpkg.synthesize(tpkg.create_soptions(),
                          tpkg.analyze(opt, x, f0, device="cpu"))
    assert snr_db(x, out.y_sin.numpy()) >= 20.0


def test_peak_picking_robust_to_f0_error():
    """HMPP degrades more gracefully than the zoom under a 2% F0 error
    with refinement off."""
    x, f0 = jts.make_test_utterance(duration=0.6)
    res = {}
    for method in ("czt", "pp"):
        opt = dataclasses.replace(tpkg.create_aoptions(), hm_method=method,
                                  f0_refine=False)
        out = tpkg.synthesize(tpkg.create_soptions(),
                              tpkg.analyze(opt, x, f0 * 1.02, device="cpu"))
        res[method] = snr_db(x, out.y_sin.numpy())
    assert res["pp"] > res["czt"] + 3.0, res


def test_peak_picking_accuracy_delta_vs_czt():
    """czt stays the quality path: pp > 24 dB, czt > pp + 15 dB (1 s)."""
    x, f0 = jts.make_test_utterance(duration=1.0)
    res = {}
    for method in ("czt", "pp"):
        opt = dataclasses.replace(tpkg.create_aoptions(), hm_method=method)
        y = tpkg.synthesize(tpkg.create_soptions(),
                            tpkg.analyze(opt, x, f0, device="cpu")).y_sin
        n = min(len(x), len(y))
        res[method] = metrics.snr_db(x[:n], y.numpy()[:n])
    assert res["pp"] > 24.0, res
    assert res["czt"] > res["pp"] + 15.0, res


def test_analysis_no_nans():
    """The whole default pipeline, masked lanes included, stays finite on
    a noisy fixture with an unvoiced tail (test_methods.py's debug-nans
    job: every analysis field and output checked)."""
    x, f0 = jts.make_test_utterance(duration=0.3, noise_level=0.1,
                                    unvoiced_tail_frac=0.4)
    ch = tpkg.analyze(tpkg.create_aoptions(), x, f0, device="cpu")
    for name in FIELDS:
        assert bool(torch.isfinite(getattr(ch, name)).all()), name
    out = tpkg.synthesize(tpkg.create_soptions(), ch)
    assert all(bool(torch.isfinite(v).all()) for v in out[:3])


def test_oscillator_bank_finite():
    rng = np.random.default_rng(0)
    N, K, nhop = 11, 8, 40
    f0 = torch.full((1, N), 150.0)
    cyc = thm.sample_cycles(f0, nhop, 16000.0, N * nhop)
    out = thm.oscillator_bank(
        cyc, torch.tensor(rng.uniform(0, 1, (1, N, K)), dtype=torch.float32),
        torch.tensor(rng.uniform(-3, 3, (1, N, K)), dtype=torch.float32),
        torch.ones((1, N, K)), nhop=nhop)
    assert out.shape == (1, N, 2 * nhop) and bool(torch.isfinite(out).all())


def test_synthesis_at_different_fs():
    x, f0 = jts.make_test_utterance(duration=0.5)
    chunk = tpkg.analyze(tpkg.create_aoptions(), x, f0, device="cpu")
    for fs_out, ratio in [(8000.0, 0.5), (32000.0, 2.0)]:
        out = tpkg.synthesize(tpkg.create_soptions(fs=fs_out), chunk)
        y = out.y.numpy()
        assert len(y) == int(len(x) * ratio)
        assert np.all(np.isfinite(y))
        mid = len(y) // 2
        w = min(2048, len(y) - mid)
        spec = np.abs(np.fft.rfft(out.y_sin.numpy()[mid:mid + w]
                                  * np.hanning(w)))
        fpk_hz = (spec[5:].argmax() + 5) * fs_out / w
        ratio_h = fpk_hz / float(chunk.f0[chunk.nfrm // 2])
        assert abs(ratio_h - round(ratio_h)) < 0.25


def test_synthesis_is_differentiable():
    """torch.autograd through the plain synthesis: a finite, non-zero
    gradient of the y_sin loss in ampl, and a small step along it lowers
    the loss."""
    x, f0 = jts.make_test_utterance(duration=0.2)
    chunk = tl0._analyze(tpkg.create_aoptions(), torch.tensor(x)[None].float(),
                         torch.tensor(f0)[None].float())
    sopt = tpkg.create_soptions()
    target = torch.tensor(x, dtype=torch.float32)

    def loss(ampl):
        out = tl0._synthesize(sopt, chunk.replace(ampl=ampl))
        n = min(target.shape[0], out.y_sin.shape[-1])
        return torch.mean((out.y_sin[0, :n] - target[:n]) ** 2)

    a0 = (chunk.ampl * 0.5).requires_grad_(True)
    l0 = loss(a0)
    (g,) = torch.autograd.grad(l0, a0)
    assert g.shape == chunk.ampl.shape
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0
    step = 0.1 * float(a0.detach().abs().max()) / float(g.abs().max())
    with torch.no_grad():
        l1 = loss(a0 - step * g)
    assert float(l1) < float(l0.detach()), (float(l0.detach()), float(l1))


def test_upsampled_noise_rolls_off():
    x, f0 = jts.make_test_utterance(duration=0.5, noise_level=0.1)
    opt = tpkg.create_aoptions()
    chunk = tpkg.analyze(opt, x, f0, device="cpu")
    out = tpkg.synthesize(tpkg.create_soptions(fs=2 * opt.conf.fs), chunk)
    y_nos = out.y_nos.numpy()
    spec = np.abs(np.fft.rfft(y_nos)) ** 2
    f = np.fft.rfftfreq(len(y_nos), 1.0 / out.fs)
    inband = spec[(f > 2500.0) & (f < opt.conf.fs / 2 * 0.9)].mean()
    above = spec[f > opt.conf.fs / 2].mean()
    assert above < inband * 1e-4


def test_noise_idft_matmul_equals_fft():
    """test_layer0.py's equality of the two band iDFTs, on the port, with
    the kernels off and on (their twins): rms error < 3e-4 rms."""
    x, f0 = jts.make_test_utterance(duration=0.5, noise_level=0.1)
    chunk = tpkg.analyze(tpkg.create_aoptions(), x, f0, device="cpu")
    for up in (False, True):
        ym, yf = (tpkg.synthesize(tpkg.create_soptions(
            noise_idft=idft, use_pallas=up), chunk).y_nos.numpy()
            for idft in ("matmul", "fft"))
        rms = np.sqrt(np.mean(yf ** 2))
        assert rms > 0
        assert np.sqrt(np.mean((ym - yf) ** 2)) < 3e-4 * rms


def test_deconv_correction_tracks_gauss_seidel():
    """test_layer0.py's: the deconvolution recovers > 60% of what one
    Gauss-Seidel pass buys over a single pass, and > 32 dB, on the 0.8 s
    male hard fixture."""
    x, f0, xh = jts.synth_hard_utterance(
        duration=0.8, register="male", seed=3, jitter=0.01, shimmer=0.1,
        noise_level=0.0, burst=False, unvoiced_tail_frac=0.0)
    got = {}
    for name, kw in [("p1", dict(hm_passes=1, hm_correction="none")),
                     ("deconv", dict(hm_passes=1, hm_correction="deconv")),
                     ("gs2", dict(hm_passes=2, hm_correction="none"))]:
        opt = dataclasses.replace(tpkg.create_aoptions(), **kw)
        y = tpkg.synthesize(tpkg.create_soptions(),
                            tpkg.analyze(opt, x, f0, device="cpu")).y_sin
        got[name] = snr_db(xh, y.numpy())
    assert got["deconv"] - got["p1"] > 0.6 * (got["gs2"] - got["p1"]), got
    assert got["deconv"] > 32.0, got
