"""The PyTorch port's leaf ops, fixtures and configs against the JAX
package (libllsm2_tpu_torch vs libllsm2_tpu, CPU, float32).  Inputs are
made with numpy from a seed and fed to both packages."""
import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libllsm2_tpu import config as jconfig
from libllsm2_tpu.ops import harmonics as jhm
from libllsm2_tpu.ops import interp as jinterp
from libllsm2_tpu.ops import spectral as jspectral
from libllsm2_tpu.ops import warp as jwarp
from libllsm2_tpu.ops import windows as jwindows
from libllsm2_tpu.utils import metrics as jmetrics
from libllsm2_tpu.utils import testsig as jtestsig

from libllsm2_tpu_torch import config as tconfig
from libllsm2_tpu_torch.ops import harmonics as thm
from libllsm2_tpu_torch.ops import interp as tinterp
from libllsm2_tpu_torch.ops import spectral as tspectral
from libllsm2_tpu_torch.ops import warp as twarp
from libllsm2_tpu_torch.ops import windows as twindows
from libllsm2_tpu_torch.utils import metrics as tmetrics
from libllsm2_tpu_torch.utils import testsig as ttestsig

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a, np.float32))


def _cycles_close(a, b, atol):
    """Mod-1 cycle tracks compared on the circle (0.999.. vs 0.000..)."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d = d - np.round(d)
    assert np.abs(d).max() <= atol, np.abs(d).max()


@pytest.mark.parametrize("name", sorted(jwindows.COSINE_SERIES) + ["mltsine"])
def test_windows_match(name):
    rng = np.random.default_rng(0)
    n = rng.uniform(-300, 300, (7, 91)).astype(np.float32)
    hw = rng.uniform(2, 300, (7, 1)).astype(np.float32)
    ref = jwindows.window_centered(name, jnp.asarray(n), jnp.asarray(hw))
    got = twindows.window_centered(name, T(n), T(hw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    assert twindows.COSINE_SERIES == jwindows.COSINE_SERIES


def test_interp_warp_periodogram_match():
    rng = np.random.default_rng(1)
    fp = rng.standard_normal((5, 32)).astype(np.float32)
    pos = rng.uniform(-2, 35, 81).astype(np.float32)
    ref = jax.vmap(lambda p: jinterp.interp1_uniform(p, jnp.asarray(pos)))(
        jnp.asarray(fp))
    np.testing.assert_allclose(tinterp.interp1_uniform(T(fp), T(pos)).numpy(),
                               np.asarray(ref), atol=1e-6)

    f = rng.uniform(0, 8000, 50).astype(np.float32)
    np.testing.assert_allclose(
        twarp.warp_frequency(T(f), 15000.0).numpy(),
        np.asarray(jwarp.warp_frequency(jnp.asarray(f), 15000.0)), rtol=1e-6)
    for npsd, nbin in ((128, 257), (32, 257), (32, 65)):
        np.testing.assert_array_equal(
            twarp.warped_band_matrix(npsd, nbin, 16000.0, 15000.0).numpy(),
            np.asarray(jwarp.warped_band_matrix(npsd, nbin, 16000.0, 15000.0)))

    for n in (1, 5, 320, 1024, 1025):
        assert tspectral.next_pow2(n) == jspectral.next_pow2(n)
    frames = rng.standard_normal((3, 9, 320)).astype(np.float32)
    w = np.hanning(320).astype(np.float32)
    ref = jspectral.periodogram(jnp.asarray(frames), jnp.asarray(w), 512)
    got = tspectral.periodogram(T(frames), T(w), 512)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5 * float(np.abs(ref).max()))


def test_sample_cycles_frames_segments_match():
    """sample_cycles against the JAX function over 100 hops, and over 1600
    hops (the bench length: a float32 cumsum of hop totals would drift
    ~1e-4 cycles there) against the float64 integral of the same F0
    samples, on a batch of two tracks (one with an unvoiced tail); then
    frame_hops in both padding modes and cycle_segments.

    The JAX comparison stays short because the jitted JAX scan itself
    drifts from the float64 integral on the CPU (~1e-5 cycles at 400 hops,
    ~6e-5 at 1600), while the port stays within 1e-6."""
    nhop, nfrm, fs = 80, 1600, 16000.0
    nx = nhop * nfrm
    f0 = np.stack([jtestsig.make_f0_track(nfrm, 0.005),
                   jtestsig.make_f0_track(nfrm, 0.005, f0_base=210.0,
                                          unvoiced_tail_frac=0.2)])
    f0 = f0.astype(np.float32)
    got = thm.sample_cycles(T(f0), nhop, fs, nx).numpy()
    assert got.shape == (2, nx)
    n_j = 100
    ref = np.asarray(jax.jit(jhm.sample_cycles, static_argnums=(1, 2, 3))(
        jnp.asarray(f0[0, :n_j]), nhop, fs, n_j * nhop))
    _cycles_close(thm.sample_cycles(T(f0[:1, :n_j]), nhop, fs,
                                    n_j * nhop)[0].numpy(), ref, 1e-5)
    pos = np.arange(nx, dtype=np.float32) / nhop
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, nfrm - 2)
    t = np.clip(pos - i0, 0.0, 1.0).astype(np.float64)
    for b in range(2):
        f0s = np.maximum(f0[b], 0.0).astype(np.float64)
        c = np.cumsum((f0s[i0] * (1 - t) + f0s[i0 + 1] * t) / fs)
        _cycles_close(got[b], np.concatenate([[0.0], c[:-1]]), 5e-6)

    cyc = got[:, :300 * nhop]
    x = np.random.default_rng(2).standard_normal(cyc.shape).astype(np.float32)
    for arr, mode in ((x, "constant"), (cyc, "edge")):
        ref = jhm.frame_hops(jnp.asarray(arr[1]), 300, nhop, 6, mode=mode)
        got = thm.frame_hops(T(arr), 300, nhop, 6, mode=mode)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref))
    centers = np.arange(300, dtype=np.int32) * nhop
    ref = jhm.cycle_segments(jnp.asarray(cyc[0]), jnp.asarray(centers), 37)
    got = thm.cycle_segments(T(cyc), torch.tensor(centers, dtype=torch.int64),
                             37)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("nhop", [55, 80, 110, 160])
def test_sample_cycles_twin_matches_and_rows_stand_alone(nhop):
    """kernels.sample_cycles_ref (the plain twin of the cycle-track kernel)
    against the JAX function over 100 hops at each hop size the port
    renders, and a row's track from a 1-row call equal, bit for bit, to
    the same row inside a 5-row call."""
    from libllsm2_tpu_torch.ops import kernels
    fs, n = 200.0 * nhop, 100
    f0 = np.stack([jtestsig.make_f0_track(n, 0.005, f0_base=100.0 + 30 * r,
                                          unvoiced_tail_frac=0.1 * (r % 2))
                   for r in range(5)]).astype(np.float32)
    got = kernels.sample_cycles_ref(T(f0), nhop, fs, n * nhop)
    ref = np.asarray(jax.jit(jhm.sample_cycles, static_argnums=(1, 2, 3))(
        jnp.asarray(f0[2]), nhop, fs, n * nhop))
    _cycles_close(got[2].numpy(), ref, 1e-5)
    for r in (0, 2, 4):
        alone = kernels.sample_cycles_ref(T(f0[r:r + 1]), nhop, fs, n * nhop)
        assert torch.equal(alone[0], got[r])


def test_cycle_steps_take_each_sample_index_rounded_past_2_24():
    """kernels.cycle_steps (the plain twin's steps) at a frame shard's
    block whose samples cross 2^24 (hop 882, start 18900: samples
    16669800-16934400): each position is the float32 nearest its integer
    sample index over nhop, as the kernel (float)s and jnp.arange take it,
    so the steps equal numpy's float32 arithmetic on those positions bit
    for bit (a float32 torch.arange rounds 45512 of these indices
    otherwise)."""
    from libllsm2_tpu_torch.ops import kernels
    nhop, start, n = 882, 18900, 300
    fs = 44100.0
    rng = np.random.default_rng(25)
    f0 = rng.uniform(70.0, 300.0, (1, n)).astype(np.float32)
    got = kernels.cycle_steps(T(f0), nhop, fs, n * nhop, start).numpy()[0]
    s = np.arange(start * nhop, (start + n) * nhop, dtype=np.int64)
    pos = s.astype(np.float32) / np.float32(nhop)
    i0 = np.clip(np.floor(pos).astype(np.int64) - start, 0, n - 2)
    t = np.clip(pos - (i0 + start).astype(np.float32), np.float32(0.0),
                np.float32(1.0))
    a, b = f0[0, i0], f0[0, i0 + 1]
    ref = (a * (np.float32(1.0) - t) + b * t) / np.float32(fs)
    np.testing.assert_array_equal(got, ref)


def _sums(a):
    """Float64 sums over a's last axis, taken sequentially, in reverse and
    pairwise (halves first)."""
    def pairwise(v):
        if v.shape[-1] == 1:
            return v[..., 0]
        h = v.shape[-1] // 2
        return pairwise(v[..., :h]) + pairwise(v[..., h:])

    seq, rev = a[..., 0], a[..., -1]
    for i in range(1, a.shape[-1]):
        seq, rev = seq + a[..., i], rev + a[..., -1 - i]
    return seq, rev, pairwise(a)


def _sum_orders(d):
    """Every float64 partial d[..., :m + 1] in _sums' three orders."""
    parts = [_sums(d[..., :m + 1]) for m in range(d.shape[-1])]
    return tuple(np.stack(p, axis=-1) for p in zip(*parts))


def _exact_sums(d):
    """Per leading index: True where every partial of the nonnegative
    float64 rows d[..., :] is exact in float64 (no value has a set bit
    below 2^(e - 52), e the exponent of the largest partial)."""
    m, e = np.frexp(d)
    mi = (m * 2.0 ** 53).astype(np.int64)
    low = np.where(d > 0, e - 53 + np.log2(np.maximum(mi & -mi, 1)), 1e9)
    top = np.frexp(d.sum(axis=-1))[1] - 1
    return low.min(axis=-1) >= top - 52


def _bench_f0():
    """F0 tracks the cycle track meets: the 8 s bench rows 0, 1, 64 after
    refine_f0 (16 kHz, f0_floor 70) and three _f0_rows tracks with
    unvoiced stretches (voicing edges ramp to 0 within a hop)."""
    from test_torch_cuda import _f0_rows
    conf = tconfig.create_aoptions(f0_floor=70.0).conf
    rows = ttestsig.make_test_utterances([(0, 0.05), (1, 0.05), (64, 0.0)],
                                         duration=8.0)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    x = np.stack([r[0][:f0.shape[1] * conf.nhop]
                  for r in rows]).astype(np.float32)
    ref = thm.refine_f0(T(x), T(f0), nhop=conf.nhop, fs=conf.fs,
                        halfwin_max=conf.halfwin_max,
                        rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    return torch.cat([ref, T(_f0_rows(3, f0.shape[1], 80))])


def test_sample_cycles_sums_are_exact_on_the_bench_tracks():
    """The fact the cycle-track kernel leans on (csrc/sample_cycles.cu):
    on the bench F0 tracks every hop's float64 partials of the twin's d
    are exact, so the twin's partials (PyTorch's CPU cumsum, float64 then
    rounded to float32) equal the same d summed sequentially, in reverse
    and pairwise, bit for bit, as do the float64 prefix sums of the hop
    totals mod 1 (every 50th prefix: the 1600 hops' pairwise sums)."""
    from libllsm2_tpu_torch.ops import kernels
    nhop, fs = 80, 16000.0
    f0 = _bench_f0()
    nx = f0.shape[1] * nhop
    d = kernels.cycle_steps(f0, nhop, fs, nx).reshape(len(f0), -1, nhop)
    within = torch.cumsum(d, dim=-1).numpy()
    d64 = d.double().numpy()
    assert (d64 == 0).any() and _exact_sums(d64).all()
    orders = _sum_orders(d64)
    for part in orders:
        assert np.array_equal(part.astype(np.float32), within)
        assert np.array_equal(part, orders[0])
    tot = np.remainder(within[..., -1], np.float32(1.0)).astype(np.float64)
    assert _exact_sums(tot).all()
    seq = np.cumsum(tot, axis=-1)
    for m in range(0, tot.shape[-1], 50):
        for part in _sums(tot[:, :m + 1]):
            assert np.array_equal(part, seq[:, m])


def test_sample_cycles_orders_part_where_sums_are_not_exact():
    """The limit of that fact: a hop ramping from a tiny positive F0 (1e-11
    Hz, whose d has bits far below the hop's largest partial's last) to
    1000 Hz.  Its float64 partials are not exact, and the three orders part
    by up to 4.4e-16 cycles (two units in the last place at ~2.5 cycles);
    rounded to float32 they agree here, and the kernel is held within 1e-6
    cycles of the twin on such rows (tests/test_torch_cuda.py)."""
    from libllsm2_tpu_torch.ops import kernels
    f0 = torch.tensor([[1e-11, 1000.0, 1000.0]])
    d = kernels.cycle_steps(f0, 80, 16000.0, 160).reshape(1, 2, 80)
    d64 = d.double().numpy()
    assert not _exact_sums(d64)[0, 0] and _exact_sums(d64)[0, 1]
    seq, rev, pair = _sum_orders(d64)
    gap = max(np.abs(seq - rev).max(), np.abs(seq - pair).max())
    assert 0 < gap <= 2 * np.spacing(seq.max())
    for part in (rev, pair):
        assert np.abs(part.astype(np.float32) - seq.astype(np.float32)).max() \
            <= np.spacing(np.float32(seq.max()))


@pytest.mark.parametrize("tail", [0.0, 0.3])
def test_refine_f0_decimated_matches(tail):
    """The port's refine is the JAX package's decimated branch (the one
    use_pallas=True takes at 16 kHz)."""
    conf = jconfig.ChunkConf(f0_floor=90.0)
    rows = [jtestsig.make_test_utterance(duration=0.4, seed=s,
                                         noise_level=nl,
                                         unvoiced_tail_frac=tail)
            for s, nl in ((0, 0.0), (3, 0.05))]
    nhop, nfrm = conf.nhop, len(rows[0][1])
    x = np.stack([r[0][:nfrm * nhop] for r in rows]).astype(np.float32)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    kw = dict(fs=conf.fs, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    got = thm.refine_f0(T(x), T(f0), nhop=nhop, **kw).numpy()
    centers = jnp.arange(nfrm, dtype=jnp.int32) * nhop
    for b in range(2):
        ref = np.asarray(jhm.refine_f0(jnp.asarray(x[b]), jnp.asarray(f0[b]),
                                       centers, use_pallas=True, nhop=nhop,
                                       **kw))
        np.testing.assert_allclose(got[b], ref, rtol=1e-4)
        assert np.all(got[b][f0[b] == 0] == 0)


def test_refine_f0_row_alone_equals_its_row_in_a_batch():
    """refine_f0 on the 0.5 s bench rows of scripts/port_card_vs_cpu.py
    (batch=66, f0_floor 70): rows 0, 1, 64 and 65 each alone (a batch of
    one) equal their rows of the 66-row batch bit for bit, at one thread
    and at four, and stay within the decimated test's rtol 1e-4 of the
    JAX refine."""
    conf = tconfig.create_aoptions(f0_floor=70.0).conf
    rows = ttestsig.make_test_utterances(
        [(i, 0.05 if i < 64 else 0.0) for i in range(66)], duration=0.5)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    nhop, nfrm = conf.nhop, f0.shape[1]
    x = np.stack([np.pad(r[0], (0, max(nfrm * nhop - len(r[0]), 0)))
                  [:nfrm * nhop] for r in rows]).astype(np.float32)
    kw = dict(nhop=nhop, fs=conf.fs, halfwin_max=conf.halfwin_max,
              rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    threads = torch.get_num_threads()
    try:
        for n in (1, 4):
            torch.set_num_threads(n)
            whole = thm.refine_f0(T(x), T(f0), **kw)
            for r in (0, 1, 64, 65):
                alone = thm.refine_f0(T(x[r:r + 1]), T(f0[r:r + 1]), **kw)
                assert torch.equal(alone[0], whole[r]), (n, r)
    finally:
        torch.set_num_threads(threads)
    centers = jnp.arange(nfrm, dtype=jnp.int32) * nhop
    for r in (0, 64):
        ref = np.asarray(jhm.refine_f0(jnp.asarray(x[r]), jnp.asarray(f0[r]),
                                       centers, use_pallas=True, **kw))
        np.testing.assert_allclose(whole[r].numpy(), ref, rtol=1e-4)


@pytest.mark.parametrize("fn,kw", [
    ("formant_envelope", dict(f=np.linspace(0, 8000, 101))),
    ("make_f0_track", dict(nfrm=200, thop=0.005, unvoiced_tail_frac=0.25)),
    ("make_test_utterance", dict(duration=0.2, seed=5, noise_level=0.05,
                                 return_parts=True)),
    ("make_test_utterance", dict(duration=0.2, seed=2)),
])
def test_fixture_copies_are_exact(fn, kw):
    ref = getattr(jtestsig, fn)(**kw)
    got = getattr(ttestsig, fn)(**kw)
    for r, g in zip(*(v if isinstance(v, tuple) else (v,)
                      for v in (ref, got))):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("fn,kw", [
    ("make_hard_f0_track", dict(nfrm=160, thop=0.005, register="male",
                                jitter=0.01, seed=2, unvoiced_tail_frac=0.15)),
    ("make_hard_f0_track", dict(nfrm=160, thop=0.005, register="child")),
    ("synth_hard_utterance", dict(duration=0.3, register="female", seed=3)),
    ("synth_hard_utterance", dict(duration=0.3, register="male", seed=1,
                                  noise_level=0.0, jitter=0.0, burst=False)),
    ("synth_voiced_fricative", dict(duration=0.3, seed=3, return_parts=True)),
])
def test_hard_and_fricative_fixture_copies_are_exact(fn, kw):
    """The port's copies of the pure-numpy hardened and voiced-fricative
    fixtures give the JAX package's arrays bit for bit."""
    test_fixture_copies_are_exact(fn, kw)


@pytest.mark.parametrize("kw", [dict(), dict(zero=(900.0, 60.0), f0_base=200.0,
                                             rd=0.6, seed=4)])
def test_synth_nasal_utterance_copy_matches(kw):
    """The nasal fixture, whose pulse shape comes from each package's LF
    model: the F0 track equal, the signal within 1e-6 of the unit peak (as
    test_synth_lf_speech_copy_matches)."""
    xj, fj = jtestsig.synth_nasal_utterance(duration=0.3, **kw)
    xt, ft = ttestsig.synth_nasal_utterance(duration=0.3, **kw)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(xt, xj, atol=1e-6)


@pytest.mark.parametrize("fn,kw", [
    ("synth_outofmodel_utterance", dict(source="rosenberg", duration=0.3)),
    ("synth_outofmodel_utterance", dict(source="klatt", duration=0.3,
                                        reverb_rt60=0.1, clip_frac=0.2)),
    ("synth_outofmodel_utterance", dict(source="triangle", duration=0.3,
                                        fs=48000.0)),
    ("make_octave_trap", dict(duration=0.3, f0_base=200.0)),
    ("synth_consonant_cluster", dict(duration=0.4, return_parts=True)),
    ("synth_whisper_utterance", dict(duration=0.3, seed=2)),
])
def test_oracle_fixture_copies_are_exact(fn, kw):
    """The port's copies of the pure-numpy oracle fixtures (out-of-model
    sources, octave trap, consonant cluster, whisper) give the JAX
    package's arrays bit for bit."""
    test_fixture_copies_are_exact(fn, kw)


@pytest.mark.parametrize("fn,kw", [
    ("synth_creaky_utterance", dict(duration=0.3)),
    ("synth_creaky_utterance", dict(duration=0.3, alt_amp=1.0,
                                    alt_period=0.0)),
    ("synth_rd_transition_utterance", dict(duration=0.3)),
    ("synth_diphthong_utterance", dict(duration=0.4)),
    ("synth_two_speaker_mixture", dict(duration=0.3)),
])
def test_lf_oracle_fixture_copies_match(fn, kw):
    """The oracle fixtures whose pulse shape comes from each package's LF
    model: the F0 (and Rd) tracks equal, every signal within 1e-6 of the
    unit peak, as test_synth_nasal_utterance_copy_matches."""
    ref = getattr(jtestsig, fn)(**kw)
    got = getattr(ttestsig, fn)(**kw)
    tracks = (1, 2) if fn == "synth_rd_transition_utterance" else (1,)
    for i, (g, r) in enumerate(zip(got, ref)):
        if i in tracks:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, atol=1e-6)


@pytest.mark.parametrize("name", ["snr_db", "log_spectral_distance_db",
                                  "mel_cepstral_distortion_db",
                                  "band_energy_error_db"])
def test_metrics_copy_matches(name):
    """Each metric of the port's copy equals the JAX package's on seeded
    signals (numpy in both), bit for bit."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(8000)
    y = x + 0.1 * rng.standard_normal(8000)
    fn = getattr(tmetrics, name), getattr(jmetrics, name)
    assert fn[0](x, y) == fn[1](x, y)
    assert fn[0](x, 0.5 * y) == fn[1](x, 0.5 * y)
    np.testing.assert_array_equal(
        tmetrics._mel_filterbank(16000.0, 400, 40, 50.0, 8000.0),
        jmetrics._mel_filterbank(16000.0, 400, 40, 50.0, 8000.0))


def _speechlike(fs=16000, dur=2.0, seed=0):
    from scipy import signal as sps
    rng = np.random.default_rng(seed)
    t = np.arange(int(fs * dur)) / fs
    src = sps.square(2 * np.pi * 120 * t) + 0.05 * rng.standard_normal(len(t))
    b, a = sps.butter(2, [500 / (fs / 2), 2500 / (fs / 2)], "bandpass")
    return sps.lfilter(b, a, src)


def test_mcd_anchors_hold_on_the_copy():
    """tests/test_metrics.py's anchors on the port's MCD: 0 for identical
    signals, gain-invariant, -40 dB noise under 2.5 dB, -20 dB noise in
    (3, 8) dB and worse, unrelated noise 2 dB worse still; a small formant
    shift under 2 dB and a large one over twice that."""
    from scipy import signal as sps
    fs = 16000
    mcd = lambda a, b: tmetrics.mel_cepstral_distortion_db(a, b, fs)
    x = _speechlike(fs)
    rng = np.random.default_rng(1)
    assert mcd(x, x) == 0.0 and mcd(x, 2.0 * x) < 1e-9
    near = mcd(x, x + 0.01 * np.std(x) * rng.standard_normal(len(x)))
    deg = mcd(x, x + 0.1 * np.std(x) * rng.standard_normal(len(x)))
    bad = mcd(x, np.std(x) * rng.standard_normal(len(x)))
    assert near < 2.5 and 3.0 < deg < 8.0 and deg > near and bad > deg + 2.0
    rng = np.random.default_rng(2)
    t = np.arange(fs * 2) / fs
    src = sps.square(2 * np.pi * 120 * t) + 0.05 * rng.standard_normal(len(t))

    def formants(lo, hi):
        b, a = sps.butter(2, [lo / (fs / 2), hi / (fs / 2)], "bandpass")
        return sps.lfilter(b, a, src)

    ref = formants(500, 2500)
    small, big = mcd(ref, formants(550, 2600)), mcd(ref, formants(900, 4000))
    assert small < 2.0 and big > 2.0 * small, (small, big)


@pytest.mark.parametrize("fs", [16000.0, 11000.0])
def test_batched_fixture_rows_are_exact(fs):
    """make_test_utterances (one harmonic synthesis for many rows) gives
    every row of the JAX package's make_test_utterance exactly."""
    rows = [(0, 0.05), (3, 0.05), (64, 0.0)]
    got = ttestsig.make_test_utterances(rows, duration=0.2, fs=fs)
    for (seed, level), g in zip(rows, got):
        ref = jtestsig.make_test_utterance(duration=0.2, fs=fs, seed=seed,
                                           noise_level=level,
                                           return_parts=True)
        for r, v in zip(ref, g):
            np.testing.assert_array_equal(v, r)


@pytest.mark.parametrize("name", ["ChunkConf", "AnalysisOptions",
                                  "SynthesisOptions"])
def test_config_fields_and_defaults_match(name):
    jc, tc = getattr(jconfig, name), getattr(tconfig, name)
    jf = [(f.name, f.default) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tc)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, jd), (_, td) in zip(jf, tf):
        if n == "conf":
            assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        else:
            assert td == jd, n
    if name == "ChunkConf":
        for conf_kw in ({}, dict(f0_floor=70.0), dict(fs=8000.0, fnyq=4000.0)):
            j, t = jc(**conf_kw), tc(**conf_kw)
            for p in ("nhop", "halfwin_max", "winlen_max", "nfft_spec",
                      "nfft_noise", "chan_edges"):
                assert getattr(t, p) == getattr(j, p), p
    ja = jconfig.create_aoptions(fs=44100.0, maxnhar=40)
    ta = tconfig.create_aoptions(fs=44100.0, maxnhar=40)
    assert dataclasses.asdict(ta) == dataclasses.asdict(ja)


def test_import_pulls_in_no_jax():
    code = ("import sys, libllsm2_tpu_torch\n"
            "from libllsm2_tpu_torch.models import layer0\n"
            "from libllsm2_tpu_torch.parallel import corpus\n"
            "from libllsm2_tpu_torch.utils import metrics, serialize, "
            "testsig\n"
            "from libllsm2_tpu_torch.models import coder\n"
            "from libllsm2_tpu_torch.runtime import native, rtanalyze, "
            "rtserve, rtsynth\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('libllsm2_tpu.') "
            "or m == 'libllsm2_tpu']\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
