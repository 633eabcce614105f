"""The JAX suite's quality floors on the PyTorch port at the library
default (create_aoptions(), so use_pallas=False: the plain branches):
tests/test_f0.py (the tracker and the tracked round trip),
tests/test_resample.py (the resampler and 44.1 kHz analysis),
tests/test_creaky.py (period-doubled sources), tests/test_edgecases.py
(silence, noise, F0 extremes, short and long inputs, conf sweeps) and
tests/test_outofmodel.py (non-LF sources, reverb, clipping, whisper, Rd
transitions, diphthongs, two voices), at those tests' own sizes and
floors, with the port's copies of their fixtures (utils/testsig.py).

Every size is the JAX test's own; no floor is changed.
test_resample.py's CLI round trip has no counterpart: the port has no
command-line interface."""
import dataclasses

import numpy as np
import pytest
import torch

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch import ChunkConf, create_aoptions, create_soptions
from libllsm2_tpu_torch.models import coder, layer1, pbp
from libllsm2_tpu_torch.ops import f0 as f0mod
from libllsm2_tpu_torch.ops import resample
from libllsm2_tpu_torch.utils import metrics, testsig

torch.set_num_threads(1)


def analyze(opt, x, f0):
    return tpkg.analyze(opt, np.asarray(x, np.float32),
                        np.asarray(f0, np.float32), device="cpu")


def synth(sopt, chunk):
    return tpkg.synthesize(sopt, chunk)


def snr_db(ref, est):
    """tests/test_layer0.py's SNR: 5-95 % of the common length."""
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    n = min(len(ref), len(est))
    lo, hi = int(0.05 * n), int(0.95 * n)
    e = ref[lo:hi] - est[lo:hi]
    return 10 * np.log10(np.sum(ref[lo:hi] ** 2) / max(np.sum(e ** 2), 1e-20))


def track(x, cfg=None):
    return f0mod.track(cfg or f0mod.F0Config(),
                       torch.tensor(np.asarray(x), dtype=torch.float32)
                       ).numpy()


# --- test_f0.py -----------------------------------------------------------

def test_f0_tracks_known_f0_and_unvoiced():
    x, f0_true = testsig.make_test_utterance(duration=1.0, noise_level=0.02)
    est = track(x)
    n = min(len(est), len(f0_true))
    sl = slice(10, n - 10)
    rel = np.abs(est[sl] - f0_true[sl]) / f0_true[sl]
    assert np.median(rel) < 0.005 and np.mean(rel < 0.02) > 0.9
    x, f0_true = testsig.make_test_utterance(duration=1.0, noise_level=0.1,
                                             unvoiced_tail_frac=0.3)
    est = track(x)
    n = len(f0_true)
    assert np.mean(est[int(0.75 * n):int(0.95 * n)] == 0.0) > 0.6
    assert np.mean(est[10:int(0.6 * n)] > 0.0) > 0.9


def test_f0_glide_voicing_recall():
    rng = np.random.default_rng(1)
    for i in range(4):
        dur = float(rng.uniform(0.25, 0.45))
        x, f0_true = testsig.make_test_utterance(duration=dur, seed=10 + i)
        tr = track(x, f0mod.F0Config(f0_floor=90.0))
        nf = min(len(f0_true), len(tr))
        v = tr[:nf] > 0
        assert np.mean(v) > 0.9, (i, np.mean(v))
        rel = np.abs(tr[:nf][v] - f0_true[:nf][v]) / f0_true[:nf][v]
        assert np.median(rel) < 0.005, (i, np.median(rel))


def test_f0_self_contained_pipeline():
    """Raw audio -> tracked F0 -> analyze -> synthesize: >= 30 dB."""
    x, f0_true = testsig.make_test_utterance(duration=1.0)
    est = track(x)
    out = synth(create_soptions(),
                analyze(create_aoptions(), x, est[:len(f0_true)]))
    assert snr_db(x, out.y_sin.numpy()) >= 30.0


def test_f0_octave_traps():
    for f0b, mult in ((130.0, 2.0), (200.0, 2.0), (110.0, 3.0), (90.0, 2.0)):
        x, f0t = testsig.make_octave_trap(f0_base=f0b, fmt_mult=mult)
        est = track(x)
        v = est > 0
        assert v.mean() > 0.9, (f0b, mult, v.mean())
        ref = np.interp(np.where(v)[0], np.arange(len(f0t)), f0t)
        assert np.mean(np.abs(est[v] / ref - 1.0) < 0.1) == 1.0, (f0b, mult)
    x, f0t = testsig.make_octave_trap(f0_base=130.0, fmt_mult=2.0)
    est0 = track(x, f0mod.F0Config(hs_weight=0.0))
    v = est0 > 0
    ref = np.interp(np.where(v)[0], np.arange(len(f0t)), f0t)
    assert np.mean(np.abs(est0[v] / ref - 1.0) < 0.1) < 0.5


# --- test_resample.py -----------------------------------------------------

def _tone(fs, f, dur=1.0):
    t = np.arange(int(fs * dur)) / fs
    return np.sin(2 * np.pi * f * t).astype(np.float32)


def _snr(ref, est, trim=200):
    n = min(len(ref), len(est))
    r, e = ref[trim:n - trim], est[trim:n - trim] - ref[trim:n - trim]
    return 10 * np.log10(np.sum(r ** 2) / max(np.sum(e ** 2), 1e-20))


def _rs(x, *a, fn=resample.resample_to, **kw):
    return fn(torch.tensor(np.asarray(x), dtype=torch.float32), *a,
              **kw).numpy()


def test_resample_tones():
    x = _tone(16000, 1000)
    y = _rs(x, 16000, 44100)
    assert _snr(_tone(44100, 1000, len(y) / 44100 + 0.1)[:len(y)], y) > 80.0
    z = _rs(_rs(_tone(16000, 1234), 16000, 44100), 44100, 16000)
    assert _snr(_tone(16000, 1234), z) > 60.0
    d = _rs(_tone(16000, 7000), 16000, 8000)
    assert 10 * np.log10(np.mean(d[100:-100] ** 2) / 0.5) < -60.0


def test_resample_matches_scipy_and_keeps_dc():
    from scipy import signal as sps
    rng = np.random.default_rng(0)
    x = sps.lfilter(*sps.butter(6, 0.35),
                    rng.standard_normal(16000)).astype(np.float32)
    assert _snr(sps.resample_poly(x, 3, 2),
                _rs(x, 3, 2, fn=resample.rresample)) > 50.0
    y = _rs(np.ones(1000), 441, 440, fn=resample.rresample)
    assert np.abs(y[50:-50] - 1.0).max() < 1e-5
    r = 1.0 / np.pi
    y = _rs(_tone(16000, 500, 2.0), float(r), fn=resample.sincresample)
    assert _snr(_tone(16000 * r, 500, 2.1)[:len(y)], y) > 55.0


def test_resample_no_drift():
    fs = 16000
    y = _rs(_tone(fs, 440, 30.0), 441, 440, fn=resample.rresample)
    fs2 = fs * 441 / 440
    n0 = int(29.0 * fs2)
    ref = np.sin(2 * np.pi * 440 * np.arange(n0, n0 + 4000) / fs2)
    assert _snr(ref, y[n0:n0 + 4000], trim=10) > 55.0
    y = _rs(_tone(48001.0, 800, 0.5), 48001.0, 48000.0)
    ref = np.sin(2 * np.pi * 800 * np.arange(len(y)) / 48000.0)
    assert _snr(ref, y) > 60.0


def test_sincresample_no_decay_on_long_signal():
    """Local SNR against the true rational rate over 120 s: > 80 dB late,
    within 3 dB of early."""
    fs, dur = 16000, 120.0
    x = np.sin(2 * np.pi * 1000 * np.arange(int(fs * dur)) / fs)
    r = 2.0 / np.pi
    p, q = resample._best_rational(r, 46000)
    assert abs(p / q - r) / r < 2e-8
    y = _rs(x, float(r), fn=resample.sincresample)
    fs2 = fs * p / q

    def snr_at(t0):
        n0 = int(t0 * fs2)
        ref = np.sin(2 * np.pi * 1000 * np.arange(n0, n0 + 8000) / fs2)
        e = y[n0:n0 + 8000] - ref
        return 10 * np.log10(np.sum(ref ** 2) / np.sum(e ** 2))

    early, late = snr_at(2.0), snr_at(dur - 4.0)
    assert late > 80.0 and abs(early - late) < 3.0, (early, late)


def test_441k_roundtrip():
    fs = 44100.0
    opt = create_aoptions(fs=fs, maxnhar=60, f0_floor=100.0)
    assert opt.fs_input == fs
    x, f0 = testsig.make_test_utterance(duration=1.0, fs=fs, thop=0.005)
    chunk = analyze(opt, x, f0)
    out = synth(create_soptions(fs=fs), chunk)
    y = out.y_sin.numpy()
    assert out.fs == fs
    assert len(y) == int(round(chunk.nfrm * opt.conf.thop * fs))
    n = min(len(x), len(y))
    assert metrics.snr_db(x[:n], y[:n]) > 50.0


# --- test_creaky.py -------------------------------------------------------

def _oe_ratio(sig, f0_hz, fs=16000.0, kmax=60):
    t = np.arange(len(sig)) / fs

    def comb(ks):
        return sum(abs(np.dot(sig, np.exp(-2j * np.pi * k * f0_hz * t))
                       / len(t)) ** 2 for k in ks)
    return comb(range(1, kmax, 2)) / comb(range(2, kmax, 2))


@pytest.mark.parametrize("alt_amp,alt_period", [(0.55, 0.04), (1.0, 0.0)])
def test_creaky_round_trip(alt_amp, alt_period):
    """Diplophonic and degenerate creak: round trip >= 33 dB; the
    diplophonic alternation depth reproduced (odd/even ratio within 25%)
    and carried by the chunk's subharmonics; the degenerate case's track
    kept within 2% and no subharmonics invented."""
    x, f0 = testsig.synth_creaky_utterance(alt_amp=alt_amp,
                                           alt_period=alt_period)
    opt = dataclasses.replace(create_aoptions(),
                              conf=ChunkConf(maxnhar=160, fnyq=6000.0))
    chunk = analyze(opt, x, f0)
    y = synth(create_soptions(), chunk).y.numpy()
    n = len(y)
    lo, hi = int(0.15 * n), int(0.9 * n)
    e = x[lo:hi] - y[lo:hi]
    assert 10 * np.log10(np.sum(x[lo:hi] ** 2) / np.sum(e ** 2)) >= 33.0
    ry = _oe_ratio(y[lo:hi], float(f0[0]))
    if alt_period:
        rx = _oe_ratio(x[lo:hi], float(f0[0]))
        assert rx > 0.3 and abs(ry - rx) < 0.25 * rx, (rx, ry)
        a = (chunk.ampl * chunk.hm_mask).numpy()
        mid = a[chunk.nfrm // 4: 3 * chunk.nfrm // 4]
        ratio = np.mean(mid[:, 0::2] ** 2) / np.mean(mid[:, 1::2] ** 2)
        assert 0.25 < ratio < 0.7, ratio
    else:
        assert np.all(np.abs(chunk.f0.numpy() - 45.0) <= 0.02 * 45.0)
        assert ry < 0.05, ry


# --- test_edgecases.py ----------------------------------------------------

def _pipeline(x, f0, opt=None, sopt=None):
    chunk = analyze(opt or create_aoptions(), x, f0)
    return chunk, synth(sopt or create_soptions(), chunk).y.numpy()


def test_silence_and_unvoiced_noise():
    _, y = _pipeline(np.zeros(60 * 80), np.zeros(60))
    assert np.all(np.isfinite(y)) and np.abs(y).max() < 1e-3
    x = np.random.default_rng(0).standard_normal(60 * 80) * 0.1
    _, y = _pipeline(x, np.zeros(60))
    assert np.all(np.isfinite(y)) and 0.3 < np.std(y) / np.std(x) < 3.0


def test_f0_at_floor_and_ceiling_and_short():
    for f0v in (42.0, 590.0):
        f0 = np.full(80, f0v)
        x, _ = testsig.synth_harmonic(f0, nharmonics=20)
        _, y = _pipeline(x, f0)
        assert np.all(np.isfinite(y)) and np.std(y) > 0.05 * np.std(x), f0v
    x, f0 = testsig.make_test_utterance(duration=0.05)
    _, y = _pipeline(x, f0)
    assert np.all(np.isfinite(y))


def test_voicing_boundary_transitions():
    f0 = np.full(90, 150.0)
    f0[20:30] = 0.0
    f0[60:75] = 0.0
    x, _ = testsig.synth_harmonic(f0, noise_level=0.1)
    chunk, y = _pipeline(x, f0)
    assert np.all(np.isfinite(y))
    m = chunk.hm_mask.numpy()
    assert m[25].sum() == 0 and m[40].sum() > 0


def test_layer1_pbp_and_coder_on_sparse_voicing():
    f0 = np.full(80, 160.0)
    f0[:10] = 0.0
    f0[-10:] = 0.0
    x, _ = testsig.synth_harmonic(f0, noise_level=0.05)
    l1 = layer1.chunk_to_layer1(analyze(create_aoptions(), x, f0))
    assert np.all(np.isfinite(pbp.pbp_synthesize(create_soptions(),
                                                 l1).y.numpy()))
    cc = coder.CoderConfig(conf=l1.conf)
    back = coder.decode(cc, coder.encode(cc, l1))
    assert np.all(np.isfinite(synth(create_soptions(), back).y.numpy()))


def test_48khz_pipeline():
    fs = 48000.0
    f0 = np.full(80, 220.0)
    x, _ = testsig.synth_harmonic(f0, fs=fs, thop=0.005, nharmonics=40)
    conf = ChunkConf(fs=fs, fnyq=12000.0, chanfreq=(3000.0, 6000.0, 9000.0),
                     nspec=513)
    opt = dataclasses.replace(create_aoptions(), conf=conf)
    y = synth(create_soptions(fs=fs), analyze(opt, x, f0)).y_sin.numpy()
    assert np.all(np.isfinite(y))
    lo, hi = int(0.1 * len(x)), int(0.9 * len(x))
    e = x[lo:hi] - y[lo:hi]
    assert 10 * np.log10(np.sum(x[lo:hi] ** 2)
                         / max(np.sum(e ** 2), 1e-20)) > 35.0


def test_long_utterance_30s():
    """30 s: the length, finite output, and > 30 dB on the last 2 s."""
    x, f0 = testsig.make_test_utterance(duration=30.0)
    _, y = _pipeline(x, f0)
    assert np.all(np.isfinite(y)) and len(y) == len(x)
    lo = len(x) - 32000
    e = x[lo:-800] - y[lo:-800]
    assert 10 * np.log10(np.sum(x[lo:-800] ** 2)
                         / max(np.sum(e ** 2), 1e-20)) > 30.0


@pytest.mark.parametrize("kw", [
    dict(nchannel=2, chanfreq=(3000.0,)),
    dict(nchannel=6, chanfreq=(1000.0, 2000.0, 3000.0, 4500.0, 6000.0)),
    dict(maxnhar=24, fnyq=4000.0),
    dict(npsd=32, nspec=129),
    dict(maxnhar_e=2),
    dict(thop=0.01),
    dict(rel_winsize=3.0, f0_floor=60.0),
])
def test_conf_sweep(kw):
    conf = ChunkConf(**kw)
    conf.validate()
    opt = dataclasses.replace(create_aoptions(), conf=conf)
    nfrm = int(0.4 / conf.thop)
    f0 = np.full(nfrm, 150.0)
    x, _ = testsig.synth_harmonic(f0, thop=conf.thop, noise_level=0.05)
    _, y = _pipeline(x, f0, opt)
    assert np.all(np.isfinite(y)) and np.std(y) > 0.05 * np.std(x)


# --- test_outofmodel.py ---------------------------------------------------

def _roundtrip(x, f0, opt=None, sopt=None, through_layer1=False):
    ch = analyze(opt or create_aoptions(), x, f0)
    if through_layer1:
        ch = layer1.chunk_to_layer0(layer1.chunk_to_layer1(ch))
    return synth(sopt or create_soptions(), ch).y.numpy().astype(np.float64), ch


@pytest.mark.parametrize("src", ["rosenberg", "klatt", "triangle"])
def test_outofmodel_layer0_and_layer1(src):
    """Layer 0 > 27 dB and MCD < 1 on each foreign source; layer 1 within
    1 dB of layer 0 with Rd inside [0.01, 6]."""
    x, f0 = testsig.synth_outofmodel_utterance(src, duration=0.8)
    y0, _ = _roundtrip(x, f0)
    s0 = metrics.snr_db(x, y0, trim=0.12)
    assert s0 > 27.0, (src, s0)
    assert metrics.mel_cepstral_distortion_db(
        x[1000:-1000], y0[1000:len(x) - 1000], 16000.0) < 1.0
    y1, ch1 = _roundtrip(x, f0, through_layer1=True)
    assert metrics.snr_db(x, y1, trim=0.12) > s0 - 1.0
    rd = ch1.rd.numpy()
    rd = rd[rd > 0]
    assert rd.size and np.all(rd >= 0.01) and np.all(rd <= 6.0)


@pytest.mark.parametrize("stress,floor,mcd", [
    (dict(reverb_rt60=0.15), 21.0, 1.5), (dict(clip_frac=0.3), 25.0, None)])
def test_outofmodel_stressors(stress, floor, mcd):
    x, f0 = testsig.synth_outofmodel_utterance("rosenberg", duration=0.8,
                                               **stress)
    y, _ = _roundtrip(x, f0)
    assert np.all(np.isfinite(y))
    assert metrics.snr_db(x, y, trim=0.12) > floor
    if mcd:
        assert metrics.mel_cepstral_distortion_db(
            x[1000:-1000], y[1000:len(x) - 1000], 16000.0) < mcd


def test_whisper_zero_f0_noise_only():
    x, f0 = testsig.synth_whisper_utterance(duration=0.8)
    assert float(np.max(f0)) == 0.0
    ch = analyze(create_aoptions(), x, f0)
    assert float((ch.ampl * ch.hm_mask).abs().max()) == 0.0
    y = synth(create_soptions(), ch).y.numpy().astype(np.float64)
    n = min(len(x), len(y))
    a, b = x[500:n - 500], y[500:n - 500]
    assert metrics.mel_cepstral_distortion_db(a, b, 16000.0) < 1.6
    assert abs(10 * np.log10(np.sum(b ** 2) / np.sum(a ** 2))) < 1.5


def test_breathy_pressed_rd_transition_tracked():
    x, f0, rd_true = testsig.synth_rd_transition_utterance(duration=1.2)
    ch = analyze(create_aoptions(), x, f0)
    l1 = layer1.chunk_to_layer1(ch)
    y = synth(create_soptions(), ch).y.numpy()
    n = min(len(x), len(y))
    assert metrics.snr_db(x[:n], y[:n], trim=0.1) > 18.0
    v = np.asarray(f0) > 0
    rd_fit = l1.rd.numpy()
    assert np.corrcoef(rd_fit[v], rd_true[v])[0, 1] > 0.9
    assert rd_fit[v].min() < 1.0 and rd_fit[v].max() > 1.7


def test_diphthong_glide_with_stop_consonant():
    x, f0 = testsig.synth_diphthong_utterance(duration=1.0)
    assert (np.asarray(f0) == 0).sum() >= 10
    y = synth(create_soptions(), analyze(create_aoptions(), x, f0)).y.numpy()
    n = min(len(x), len(y))
    assert metrics.snr_db(x[:n], y[:n], trim=0.1) > 14.0
    assert metrics.mel_cepstral_distortion_db(x[1000:n - 1000],
                                              y[1000:n - 1000], 16000.0) < 1.1


def test_two_speaker_mixture_graceful():
    x, fa, xa = testsig.synth_two_speaker_mixture(duration=1.0)
    out = synth(create_soptions(), analyze(create_aoptions(), x, fa))
    ys = out.y_sin.numpy()
    n = min(len(xa), len(ys))
    assert metrics.snr_db(xa[:n], ys[:n], trim=0.1) > 16.0
    assert np.isfinite(out.y.numpy()).all()


def test_48k_out_of_model_roundtrip():
    opt = create_aoptions(fs=48000.0)
    sopt = dataclasses.replace(create_soptions(), fs=48000.0)
    x, f0 = testsig.synth_outofmodel_utterance("klatt", duration=0.8,
                                               fs=48000.0)
    y, _ = _roundtrip(x, f0, opt, sopt)
    assert metrics.snr_db(x, y, trim=0.12) > 27.0
    assert metrics.mel_cepstral_distortion_db(
        x[3000:-3000], y[3000:len(x) - 3000], 48000.0) < 1.5
