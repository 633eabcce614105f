"""The PyTorch port's layer-1 leftovers and the JAX suite's quality floors
on the port, on the CPU.  The section-model Rd fit (_resonance_dev,
fit_rd_sections, chunk_to_layer1(sections=)) and the legacy fit_rd
against the JAX package on the JAX analysis of a mid-gap nasal fixture
(Pallas branch in interpret mode); then the floors of tests/test_nasal.py,
tests/test_voiced_fricative.py (44 dB) and tests/test_hard_fixtures.py
(three cases, three registers), run through the port's own analysis,
layer 1 and synthesis with use_pallas=True (the port refuses False), on
the port's copies of the fixtures and metrics.  Each test states its
floor or tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import layer1 as jl1
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import LAYER0_FIELDS, chunk_from_numpy
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.utils import metrics, testsig

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))
OPT = dataclasses.replace(tpkg.create_aoptions(), use_pallas=True)
SOPT = dataclasses.replace(tpkg.create_soptions(), use_pallas=True)
SECS = ((250.0, 70.0, -1.0), (900.0, 60.0, 1.0))
NASAL_FORMANTS = ((250.0, 70.0), (1100.0, 180.0), (2300.0, 220.0))


@pytest.fixture(scope="module")
def midgap():
    """The mid-gap nasal fixture (zero (900, 60) Hz, f0 200 Hz, test_nasal's
    seed 2) through the JAX analysis: (the JAX layer-0 chunk, the log
    amplitudes held past the last harmonic as chunk_to_layer1 holds
    them)."""
    x, f0 = jts.synth_nasal_utterance(duration=1.0, seed=2,
                                      zero=(900.0, 60.0), f0_base=200.0)
    opt = dataclasses.replace(jpkg.create_aoptions(), use_pallas=True)
    ch = jl0.analyze(opt, x.astype(np.float32), f0.astype(np.float32))
    mask = np.asarray(ch.hm_mask)
    la = np.where(mask > 0, np.log(np.maximum(np.asarray(ch.ampl), 1e-10)),
                  -23.0).astype(np.float32)
    last = np.maximum(mask.sum(-1).astype(np.int64) - 1, 0)
    held = np.where(mask > 0, la, np.take_along_axis(la, last[:, None], -1))
    return ch, held


@pytest.mark.parametrize("fc,bw,sign", [(250.0, 70.0, -1.0),
                                        (900.0, 60.0, 1.0),
                                        (2300.0, 220.0, -1.0)])
def test_resonance_dev_matches(fc, bw, sign):
    """A section's phase-deviation contribution on a vibrato track with
    unvoiced frames: within 1e-4 rad of the JAX package's."""
    f0 = testsig.make_f0_track(120, 0.005, f0_base=190.0,
                               unvoiced_tail_frac=0.1).astype(np.float32)
    ref = np.asarray(jl1._resonance_dev(jnp.asarray(f0), 80, fc, bw,
                                        16000.0, sign))
    got = tl1._resonance_dev(T(f0)[None], 80, fc, bw, 16000.0, sign)[0]
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_fit_rd_sections_matches(midgap):
    """fit_rd_sections with test_nasal's sections: within 1e-3 relative
    (test_fit_rd_phase_matches' tolerance)."""
    ch, held = midgap
    args = (held, np.asarray(ch.phse), np.asarray(ch.hm_mask),
            np.asarray(ch.f0))
    ref = np.asarray(jl1.fit_rd_sections(*map(jnp.asarray, args), 16000.0,
                                         SECS))
    got = tl1.fit_rd_sections(*(T(a)[None] for a in args), 16000.0,
                              SECS)[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_fit_rd_legacy_matches(midgap):
    """The legacy amplitude-tilt fit on the held log amplitudes minus the
    lip tilt: within 1e-3 relative."""
    ch, held = midgap
    K = held.shape[-1]
    fk = np.arange(1, K + 1) * np.maximum(np.asarray(ch.f0), 1.0)[:, None]
    la = (held - np.log(np.maximum(2 * np.pi * fk * 0.015 / 343.0,
                                   1e-12))).astype(np.float32)
    mask = np.asarray(ch.hm_mask)
    ref = np.asarray(jl1.fit_rd(jnp.asarray(la), jnp.asarray(mask)))
    got = tl1.fit_rd(T(la)[None], T(mask)[None])[0].numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_chunk_to_layer1_sections_matches(midgap):
    """chunk_to_layer1(ch, None, sections) carried across: rd within 1e-3
    relative, vtmagn within 2e-3 (log units), as without sections
    (test_chunk_to_layer1_matches)."""
    ch, _ = midgap
    ref = jl1.chunk_to_layer1(ch, None, SECS)
    d = {f: np.asarray(getattr(ch, f))[None] for f in LAYER0_FIELDS}
    got = tl1.chunk_to_layer1(chunk_from_numpy(d, tpkg.ChunkConf(),
                                               device="cpu"), None, SECS)
    np.testing.assert_allclose(got.rd[0].numpy(), np.asarray(ref.rd),
                               rtol=1e-3)
    np.testing.assert_allclose(got.vtmagn[0].numpy(), np.asarray(ref.vtmagn),
                               atol=2e-3)


# -- tests/test_nasal.py on the port ----------------------------------------

def _core(f0, nhop=80):
    v = np.where(np.asarray(f0) > 0)[0]
    return v[int(0.10 * len(v))] * nhop, v[int(0.85 * len(v))] * nhop


def _analyze(x, f0, opt=OPT):
    return tl0.analyze(opt, x.astype(np.float32), f0.astype(np.float32),
                       device="cpu")


def _nasal_roundtrip(**kw):
    x, f0 = testsig.synth_nasal_utterance(duration=1.0, seed=2, **kw)
    ch = _analyze(x, f0)
    l1 = tl1.chunk_to_layer1(ch)
    y1 = tl0.synthesize(SOPT, tl1.chunk_to_layer0(l1)).y.numpy()
    return x, f0, ch, l1, y1


def _rd_median(l1, f0, sel=None):
    v = np.asarray(f0) > 0 if sel is None else sel
    return float(np.median(l1.rd.numpy()[v]))


def test_layer0_roundtrip_with_antiformant():
    """test_nasal's floor: the voiced-core SNR above 29 dB."""
    x, f0 = testsig.synth_nasal_utterance(duration=1.0, seed=2)
    y = tl0.synthesize(SOPT, _analyze(x, f0)).y.numpy()
    lo, hi = _core(f0)
    assert metrics.snr_db(x[lo:hi], y[lo:hi], trim=0.0) > 29.0


def test_layer1_roundtrip_and_notch_reproduction():
    """SNR above 29 dB, smoothed LSD under 2.5 dB and the notch depth
    within 2 dB of the input's (above 8 dB)."""
    x, f0, ch, l1, y1 = _nasal_roundtrip()
    lo, hi = _core(f0)
    assert metrics.snr_db(x[lo:hi], y1[lo:hi], trim=0.0) > 29.0
    assert metrics.log_spectral_distance_db(x[lo:hi], y1[lo:hi],
                                            smooth_bins=16) < 2.5
    a, b = x[lo:hi], y1[lo:hi]
    fr = np.fft.rfftfreq(len(a), 1 / 16000.0)
    band_db = lambda sp, f1, f2: 10 * np.log10(
        sp[(fr >= f1) & (fr < f2)].mean())
    depth = [band_db(s, 500, 650) - band_db(s, 750, 880) for s in (
        np.abs(np.fft.rfft(v * np.hanning(len(a)))) ** 2 for v in (a, b))]
    assert depth[0] > 8.0 and abs(depth[1] - depth[0]) < 2.0, depth


@pytest.mark.parametrize("rd_true", [0.5, 1.0, 2.2])
def test_rd_recovery_with_sampled_zero(rd_true):
    """f0 = 120 (harmonics sample the notch): median rd within 15%."""
    x, f0, ch, l1, y1 = _nasal_roundtrip(rd=rd_true)
    assert abs(_rd_median(l1, f0) / rd_true - 1.0) < 0.15


def test_rd_midgap_zero_documented_floor():
    """The mid-gap zero at f0 = 200: median rd above 0.45 (true 1.0), the
    round trip above 28 dB."""
    x, f0, ch, l1, y1 = _nasal_roundtrip(zero=(900.0, 60.0), f0_base=200.0)
    assert _rd_median(l1, f0) > 0.45
    lo, hi = _core(f0)
    assert metrics.snr_db(x[lo:hi], y1[lo:hi], trim=0.0) > 28.0


def test_rd_midgap_bias_follows_the_pole_not_the_zero():
    """No zero at all: F1 sampled at f0 = 120 gives rd above 0.85, F1
    between harmonics at f0 = 200 below 0.75."""
    def rd_of(f0_base):
        f0 = testsig.make_f0_track(200, 0.005, f0_base=f0_base,
                                   vibrato_depth=0.015, glide=0.1)
        x, f0t = testsig.synth_lf_speech(f0, rd=1.0, formants=NASAL_FORMANTS,
                                         zeros=(), noise_level=0.02, seed=2)
        return _rd_median(tl1.chunk_to_layer1(_analyze(x, f0t)), f0t)

    assert rd_of(120.0) > 0.85
    assert rd_of(200.0) < 0.75


@pytest.mark.parametrize("f0b,lo,hi", [(200.0, 0.8, 1.25), (182.0, 0.8, 1.25),
                                       (120.0, 0.9, 1.15)])
def test_rd_sections_observation_model_recovers_midgap(f0b, lo, hi):
    """chunk_to_layer1(sections=) recovers the mid-gap rd into (0.8, 1.25)
    at 182 and 200 Hz; the well-sampled 120 Hz default fixture stays in
    (0.9, 1.15)."""
    kw = dict(zero=(900.0, 60.0), f0_base=f0b) if f0b > 150 else {}
    x, f0 = testsig.synth_nasal_utterance(duration=1.0, seed=2, **kw)
    l1 = tl1.chunk_to_layer1(_analyze(x, f0), None, SECS)
    assert lo < _rd_median(l1, f0) < hi


def test_rd_midgap_bias_is_common_mode_across_frames():
    """At f0 = 182 the frames whose 5th harmonic lies in the notch and
    those that miss it fit the same biased rd (medians within 0.1, the
    others under 0.8)."""
    x, f0, ch, l1, y1 = _nasal_roundtrip(zero=(900.0, 60.0), f0_base=182.0)
    f0n = np.asarray(f0)
    v = f0n > 0
    in_notch = (5 * f0n > 860) & (5 * f0n < 940) & v
    assert in_notch.sum() >= 20 and (v & ~in_notch).sum() >= 20
    med_in = _rd_median(l1, f0, in_notch)
    med_out = _rd_median(l1, f0, v & ~in_notch)
    assert abs(med_in - med_out) < 0.1 and med_out < 0.8


# -- tests/test_voiced_fricative.py and test_hard_fixtures.py ---------------

def _bp(s, flo, fhi, fs=16000.0):
    S = np.fft.rfft(s)
    f = np.fft.rfftfreq(len(s), 1 / fs)
    return np.fft.irfft(S * ((f >= flo) & (f <= fhi)), len(s))


def test_voiced_band_snr_with_strong_frication():
    """test_voiced_fricative's floor: the harmonics below the frication
    band above 44 dB."""
    x, f0, xh, cycles = testsig.synth_voiced_fricative(duration=1.0, seed=3,
                                                       return_parts=True)
    ysin = tl0.synthesize(SOPT, _analyze(x, f0)).y_sin.numpy()
    v = np.where(np.asarray(f0) > 0)[0]
    lo, hi = v[int(0.10 * len(v))] * 80, v[int(0.85 * len(v))] * 80
    s = metrics.snr_db(_bp(xh[lo:hi], 0, 2800), _bp(ysin[lo:hi], 0, 2800),
                       trim=0.0)
    assert s > 44.0, s


HARD_OPT = dataclasses.replace(OPT, conf=tpkg.ChunkConf(f0_floor=65.0))


def _hard(reg, **kw):
    x, f0, xh = testsig.synth_hard_utterance(duration=0.8, register=reg,
                                             seed=3, **kw)
    out = tl0.synthesize(SOPT, _analyze(x, f0, HARD_OPT))
    v = np.where(f0 > 0)[0]
    lo, hi = v[int(0.10 * len(v))] * 80, v[int(0.85 * len(v))] * 80
    ysin, y = out.y_sin.numpy(), out.y.numpy()
    n = min(len(x), len(y))
    return (metrics.snr_db(xh[lo:hi], ysin[lo:hi], trim=0.0),
            metrics.log_spectral_distance_db(x[:n], y[:n], smooth_bins=16),
            metrics.band_energy_error_db(x[:n], y[:n]))


@pytest.mark.parametrize("reg", ["male", "female", "child"])
def test_hard_full_stressors(reg):
    """All stressors: SNR above 25 dB, LSD under 5 dB, band energy within
    2.5 dB."""
    snr, lsd, be = _hard(reg)
    assert snr > 25.0 and lsd < 5.0 and be < 2.5, (snr, lsd, be)


@pytest.mark.parametrize("reg", ["male", "female", "child"])
def test_hard_noiseless_stressed(reg):
    """No breath noise: SNR above 41.5 / 53 / 50 dB."""
    snr = _hard(reg, noise_level=0.0)[0]
    assert snr > {"male": 41.5, "female": 53.0, "child": 50.0}[reg], snr


@pytest.mark.parametrize("reg", ["male", "female", "child"])
def test_hard_no_jitter_above_45db(reg):
    """No jitter or noise: SNR above 47 / 62 / 51 dB, LSD under 3 dB."""
    snr, lsd, _ = _hard(reg, noise_level=0.0, jitter=0.0)
    assert snr > {"male": 47.0, "female": 62.0, "child": 51.0}[reg], snr
    assert lsd < 3.0, lsd
