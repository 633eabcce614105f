"""The PyTorch port's leaf DSP kit (ops/filters.py, ops/stft.py,
spectral.czt / iczt / instantaneous_frequency, interp.interp1 /
catmull_rom_uniform) against the JAX package's functions on the CPU, on
seeded numpy inputs of a few rows (the JAX functions mapped over the rows
with jax.vmap), then tests/test_dspkit.py's scipy and numpy oracles on the
port's functions.  Tolerances: czt / iczt 1e-4 of the largest magnitude,
the rest 1e-5 (of the largest magnitude where the values are large),
and the oracles' own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import signal as sps

from libllsm2_tpu.ops import filters as jfilt
from libllsm2_tpu.ops import interp as jinterp
from libllsm2_tpu.ops import spectral as jspec
from libllsm2_tpu.ops import stft as jstft
from libllsm2_tpu.utils import testsig as jts

from libllsm2_tpu_torch.ops import filters, interp, spectral, stft

torch.set_num_threads(1)

RNG = np.random.default_rng(0)
X = RNG.standard_normal((3, 500)).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("m,f_step", [(64, 0.013), (500, 1.0 / 500),
                                      (200, [0.004, 0.01, 0.02])])
def test_czt_matches(m, f_step):
    """czt on 3 rows (one zoom, or a zoom a row as vmap maps them)."""
    if isinstance(f_step, list):
        ref = jax.vmap(lambda r, f: jspec.czt(r, m, f))(
            jnp.asarray(X), jnp.asarray(f_step, jnp.float32))
        got = spectral.czt(torch.tensor(X), m, torch.tensor(f_step))
    else:
        ref = jax.vmap(lambda r: jspec.czt(r, m, f_step))(jnp.asarray(X))
        got = spectral.czt(torch.tensor(X), m, f_step)
    assert got.shape == (3, m)
    assert _rel(got.numpy(), ref) <= 1e-4


def test_iczt_matches_and_inverts():
    """iczt of the full-circle transform: the JAX package's within 1e-4,
    and x back within 1e-4."""
    Xf = spectral.czt(torch.tensor(X), 500, 1.0 / 500)
    ref = jax.vmap(lambda r: jspec.iczt(r, 1.0 / 500))(jnp.asarray(Xf.numpy()))
    got = spectral.iczt(Xf, 1.0 / 500)
    assert _rel(got.numpy(), ref) <= 1e-4
    assert _rel(got.real.numpy(), X) <= 1e-4


def test_instantaneous_frequency_matches():
    """Flanagan's detector on a chirp, 3 rows: within 1e-5 relative, and
    within 1 Hz of the true frequency at the centres."""
    fs, n = 16000.0, 4000
    t = np.arange(n) / fs
    f_true = 150.0 + 40.0 * t / t[-1]
    rows = np.stack([np.cos(2 * np.pi * np.cumsum(f_true * s) / fs)
                     for s in (1.0, 1.5, 2.0)]).astype(np.float32)
    centers = np.arange(400, 3600, 200)
    freqs = np.stack([f_true[centers] * s * 1.01
                      for s in (1.0, 1.5, 2.0)]).astype(np.float32)
    hw = np.full(freqs.shape, 300.0, np.float32)
    ref = jax.vmap(lambda r, f, h: jspec.instantaneous_frequency(
        r, jnp.asarray(centers), f, fs=fs, halfwidth=h, halfwin_max=320))(
        jnp.asarray(rows), jnp.asarray(freqs), jnp.asarray(hw))
    got = spectral.instantaneous_frequency(
        torch.tensor(rows), torch.tensor(centers), torch.tensor(freqs),
        fs=fs, halfwidth=torch.tensor(hw), halfwin_max=320)
    assert _rel(got.numpy(), ref) <= 1e-5
    truth = np.stack([f_true[centers] * s for s in (1.0, 1.5, 2.0)])
    assert np.abs(got.numpy() - truth).max() < 1.0


def test_interp1_and_catmull_rom_match():
    xp = np.sort(RNG.uniform(0, 10, 20)).astype(np.float32)
    fp = RNG.standard_normal((2, 33)).astype(np.float32)
    q = RNG.uniform(-1, 11, 50).astype(np.float32)
    ref = jinterp.interp1(jnp.asarray(xp), jnp.asarray(fp[0, :20]),
                          jnp.asarray(q))
    got = interp.interp1(torch.tensor(xp), torch.tensor(fp[0, :20]),
                         torch.tensor(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    pos = np.linspace(-1, 40, 77).astype(np.float32)
    ref = jax.vmap(lambda f: jinterp.catmull_rom_uniform(
        f, jnp.asarray(pos)))(jnp.asarray(fp))
    got = interp.catmull_rom_uniform(torch.tensor(fp), torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_filters_match():
    """fir1_bandpass, fftfilt, biquad, filtfilt_biquad, levinson,
    lpc_from_signal and lpc_spectrum on 3 rows, within 1e-5."""
    h = RNG.standard_normal(31).astype(np.float32)
    assert _rel(filters.fir1_bandpass(127, 1000.0, 3000.0, 16000.0).numpy(),
                jfilt.fir1_bandpass(127, 1000.0, 3000.0, 16000.0)) <= 1e-5
    assert _rel(filters.fftfilt(torch.tensor(h), torch.tensor(X)).numpy(),
                jfilt.fftfilt(jnp.asarray(h), jnp.asarray(X))) <= 1e-5
    b, a = sps.butter(2, 0.3)
    ref = jax.vmap(lambda r: jfilt.biquad(r, b, a))(jnp.asarray(X))
    assert _rel(filters.biquad(torch.tensor(X), b, a).numpy(), ref) <= 1e-5
    ref = jax.vmap(lambda r: jfilt.filtfilt_biquad(r, b, a))(jnp.asarray(X))
    assert _rel(filters.filtfilt_biquad(torch.tensor(X), b, a).numpy(),
                ref) <= 1e-5
    r = np.stack([np.correlate(v, v, "full")[499:508]
                  for v in X]).astype(np.float32)
    aj, ej = jax.vmap(lambda v: jfilt.levinson(v, 8))(jnp.asarray(r))
    at, et = filters.levinson(torch.tensor(r), 8)
    assert _rel(at.numpy(), aj) <= 1e-5 and _rel(et.numpy(), ej) <= 1e-5
    aj, ej = jax.vmap(lambda v: jfilt.lpc_from_signal(v, 6))(jnp.asarray(X))
    at, et = filters.lpc_from_signal(torch.tensor(X), 6)
    assert _rel(at.numpy(), aj) <= 1e-5 and _rel(et.numpy(), ej) <= 1e-5
    ref = jax.vmap(lambda v, e: jfilt.lpc_spectrum(v, e, 129))(aj, ej)
    assert _rel(filters.lpc_spectrum(at, et, 129).numpy(), ref) <= 1e-5


def test_stft_dct_hilbert_match():
    """stft / istft (128-sample Hann, hop 32), dct and hilbert_envelope on
    3 rows, within 1e-5."""
    spec_j = jstft.stft(jnp.asarray(X), 128, 32)
    spec_t = stft.stft(torch.tensor(X), 128, 32)
    assert _rel(spec_t.numpy(), spec_j) <= 1e-5
    assert _rel(stft.istft(spec_t, 128, 32, 500).numpy(),
                jstft.istft(spec_j, 128, 32, 500)) <= 1e-5
    assert _rel(stft.dct(torch.tensor(X)).numpy(),
                jstft.dct(jnp.asarray(X))) <= 1e-5
    assert _rel(stft.hilbert_envelope(torch.tensor(X)).numpy(),
                jstft.hilbert_envelope(jnp.asarray(X))) <= 1e-5


# tests/test_dspkit.py's oracles on the port (its orbax round trip is
# tests/test_torch_mesh_models.py's test_orbax_roundtrip, on the port's
# torch.distributed.checkpoint directories)

def test_fir1_bandpass_response():
    h = filters.fir1_bandpass(127, 1000.0, 3000.0, 16000.0).numpy()
    w, resp = sps.freqz(h, worN=512, fs=16000.0)
    mag = np.abs(resp)
    assert mag[(w > 1500) & (w < 2500)].min() > 0.7
    assert mag[w < 400].max() < 0.05
    assert mag[w > 5000].max() < 0.05


def test_fftfilt_matches_scipy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal(500).astype(np.float32)
    h = rng.standard_normal(31).astype(np.float32)
    got = filters.fftfilt(torch.tensor(h), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, sps.lfilter(h, [1.0], x), atol=1e-3)


def test_biquad_matches_scipy():
    b, a = sps.butter(2, 0.3)
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    got = filters.biquad(torch.tensor(x), b, a).numpy()
    np.testing.assert_allclose(got, sps.lfilter(b, a, x), atol=1e-4)


def test_levinson_matches_direct_solve():
    x = np.random.default_rng(2).standard_normal(2048)
    x = sps.lfilter([1.0], [1.0, -1.2, 0.5], x)      # AR(2) process
    r = np.correlate(x, x, "full")[len(x) - 1:len(x) + 2]
    a, _ = filters.levinson(torch.tensor(r, dtype=torch.float32), 2)
    np.testing.assert_allclose(a.numpy()[1:], [-1.2, 0.5], atol=0.05)


def test_lpc_spectrum_tracks_ar_process():
    x = np.random.default_rng(3).standard_normal(4096)
    x = sps.lfilter([1.0], [1.0, -0.9], x)
    a, err = filters.lpc_from_signal(
        torch.tensor(x * np.hanning(len(x)), dtype=torch.float32), 4)
    spec = filters.lpc_spectrum(a, err, 129).numpy()
    assert spec[0] > spec[-1] * 3          # lowpass tilt of the AR(1) pole


def test_stft_roundtrip():
    x, _ = jts.make_test_utterance(duration=0.3)
    x = torch.tensor(x[None, :], dtype=torch.float32)
    y = stft.istft(stft.stft(x, 256, 64), 256, 64, x.shape[-1])
    lo, hi = 256, x.shape[-1] - 256
    np.testing.assert_allclose(y[0, lo:hi].numpy(), x[0, lo:hi].numpy(),
                               atol=1e-3)


def test_dct_matches_scipy():
    from scipy.fft import dct as sdct
    x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(stft.dct(torch.tensor(x)).numpy(),
                               sdct(x, type=2, norm="ortho"), atol=1e-4)


def test_hilbert_envelope():
    t = np.arange(4096) / 16000.0
    env = 1.0 + 0.5 * np.sin(2 * np.pi * 20 * t)
    got = stft.hilbert_envelope(torch.tensor(
        env * np.sin(2 * np.pi * 1000 * t), dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got[200:-200], env[200:-200], rtol=0.05)


def test_cepstrum_roundtrip():
    logmag = torch.tensor(np.random.default_rng(7).standard_normal(129),
                          dtype=torch.float32)
    back = spectral.cepstrum_to_spec(spectral.spec_to_cepstrum(logmag))
    np.testing.assert_allclose(back.numpy(), logmag.numpy(), atol=1e-4)
