"""The PyTorch port's F0 tracker (ops/f0.py) against the JAX package's on
the CPU: the difference function and CMNDF, the Viterbi observations,
the Viterbi path given the JAX observations, whole tracks on test_f0.py's
fixtures, the octave-trap floors of test_f0.py, and a row alone against
its row in a batch.  Inputs are made from seeds with numpy; each test
states its tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libllsm2_tpu.ops import f0 as jf0
from libllsm2_tpu.ops.interp import fetch_frames as jfetch
from libllsm2_tpu.utils import testsig

from libllsm2_tpu_torch.ops import f0 as tf0
from libllsm2_tpu_torch.ops import interp as tinterp

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))


def _jax_front_end(cfg, x):
    """The JAX tracker's body up to its Viterbi (libllsm2_tpu/ops/f0.py
    track, op for op, with the package's own fetch_frames,
    _difference_function and _cmndf; the comb matrix, built there by the
    same numpy code, taken from the port) -> (dp [N, tau_max], logobs [N,
    nbins + 1], lt)."""
    fs, nhop = cfg.fs, cfg.nhop
    nfrm = x.shape[0] // nhop
    centers = jnp.arange(nfrm, dtype=jnp.int32) * nhop
    frames = jfetch(jnp.asarray(x, jnp.float32), centers,
                    cfg.winlen // 2)[:, :cfg.winlen]
    frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    tau_min, tau_max, span = tf0._lags(cfg)
    dp = jf0._cmndf(jf0._difference_function(frames, tau_max, span))
    f_grid = jnp.exp(jnp.linspace(jnp.log(cfg.f0_floor + 1.0),
                                  jnp.log(cfg.f0_ceil - 1.0), cfg.nbins))
    lag = fs / f_grid
    i0 = jnp.clip(jnp.floor(lag).astype(jnp.int32), 1, tau_max - 2)
    tfrac = lag - i0
    obs = jnp.take(dp, i0, axis=-1) * (1.0 - tfrac) \
        + jnp.take(dp, i0 + 1, axis=-1) * tfrac
    logp_v = -obs / 0.1
    win = jnp.hanning(cfg.winlen).astype(jnp.float32)
    mag = jnp.abs(jnp.fft.rfft(frames * win[None, :], n=2 * cfg.winlen))
    comb = jnp.asarray(tf0._tables_np(tf0.F0Config(**cfg._asdict()))["comb"])
    hs = jnp.matmul(mag, comb, precision=jax.lax.Precision.HIGHEST)
    hs_rel = jnp.log(hs + 1e-9) - jnp.log(jnp.max(hs, axis=-1,
                                                  keepdims=True) + 1e-9)
    logp_v = logp_v + cfg.hs_weight * hs_rel
    logp_u = -cfg.voicing_threshold / 0.1 * jnp.ones((nfrm, 1))
    logobs = jnp.concatenate([logp_v, logp_u], axis=-1)
    semi = 12.0 * jnp.log2(f_grid[None, :] / f_grid[:, None])
    B = cfg.nbins
    lt = jnp.full((B + 1, B + 1), -cfg.switch_penalty)
    lt = lt.at[:B, :B].set(-(semi ** 2) / (2.0 * cfg.transition_semitones
                                            ** 2))
    lt = lt.at[B, B].set(0.0)
    lt = lt - jax.scipy.special.logsumexp(lt, axis=1, keepdims=True)
    return np.asarray(dp), np.asarray(logobs), lt


def _jax_viterbi(logobs, lt):
    """The JAX tracker's Viterbi scan and backtrace, op for op."""
    def fwd(score, lo):
        cand = score[:, None] + lt
        score_new = jnp.max(cand, axis=0) + lo
        return score_new - jnp.max(score_new), jnp.argmax(cand, axis=0)

    init = logobs[0] - jnp.max(logobs[0])
    final, back = jax.lax.scan(fwd, init, logobs[1:])
    last = jnp.argmax(final)
    _, path_rev = jax.lax.scan(lambda s, bp: (bp[s], bp[s]), last, back,
                               reverse=True)
    return np.asarray(jnp.concatenate([path_rev, jnp.array([last])]))


def _utt(duration, seed, **kw):
    x, f0 = testsig.make_test_utterance(duration=duration, seed=seed, **kw)
    return x.astype(np.float32), f0


def test_fetch_frames_match_jax():
    """fetch_frame / fetch_frames against the JAX package's (zero-padded
    gathers) exactly, and the tracker's frames cut from frame_hops equal
    fetch_frames' (before the mean removal)."""
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    c = np.array([0, 37, 512, 999], np.int32)
    np.testing.assert_array_equal(
        tinterp.fetch_frames(T(x), T(c), 50).numpy(),
        np.asarray(jfetch(jnp.asarray(x), jnp.asarray(c), 50)))
    from libllsm2_tpu.ops.interp import fetch_frame as jfetch1
    np.testing.assert_array_equal(
        tinterp.fetch_frame(T(x), 990, 20).numpy(),
        np.asarray(jfetch1(jnp.asarray(x), jnp.int32(990), 20)))
    cfg = tf0.F0Config()
    xb = T(x[None].repeat(2, 0))
    fr = tf0._frames(cfg, xb)
    ref = tinterp.fetch_frames(xb, torch.arange(1000 // 80) * 80, 512)
    ref = ref[..., :1024]
    torch.testing.assert_close(fr, ref - ref.mean(-1, keepdim=True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("span", [None, 400])
def test_cmndf_and_observations_match_jax(span):
    """The difference function and CMNDF within 2e-5 relative to their
    peak (float32 FFT correlations of two libraries), the Viterbi
    observations (CMNDF at the bins' lags + the comb score) within 2e-4 of
    their spread, on a noisy 0.5 s utterance; span=None is the legacy
    full-window form."""
    x, _ = _utt(0.5, 3, noise_level=0.05)
    cfg = tf0.F0Config()
    frames = tf0._frames(cfg, T(x)[None])[0]
    tau_max = tf0._lags(cfg)[1]
    d_t = tf0._difference_function(frames, tau_max, span).numpy()
    d_j = np.asarray(jf0._difference_function(jnp.asarray(frames.numpy()),
                                              tau_max, span))
    assert np.abs(d_t - d_j).max() <= 2e-5 * np.abs(d_j).max()
    c_t = tf0._cmndf(T(d_j)).numpy()
    c_j = np.asarray(jf0._cmndf(jnp.asarray(d_j)))
    np.testing.assert_allclose(c_t, c_j, rtol=1e-5, atol=1e-6)
    if span is None:
        return
    dp_j, lo_j, _ = _jax_front_end(jf0.F0Config(), x)
    lo_t, dp_t = tf0._observations(cfg, T(x)[None])
    np.testing.assert_allclose(dp_t[0].numpy(), dp_j, atol=2e-4, rtol=0)
    assert np.abs(lo_t[0].numpy() - lo_j).max() <= 2e-4 * np.ptp(lo_j)


def test_viterbi_given_jax_observations_gives_jax_path():
    """The port's Viterbi (a loop over frames, first maximum on ties) on
    the JAX tracker's observations gives the JAX scan's path exactly, on
    three utterances at once (one with an unvoiced tail)."""
    cfg = jf0.F0Config()
    los, paths = [], []
    for seed, kw in ((0, {}), (1, dict(noise_level=0.1,
                                       unvoiced_tail_frac=0.3)), (2, {})):
        x, _ = _utt(0.6, seed, **kw)
        _, lo, lt = _jax_front_end(cfg, x)
        los.append(lo)
        paths.append(_jax_viterbi(jnp.asarray(lo), lt))
    lt_t = tf0._tables(tf0.F0Config(), "cpu")["lt"]
    got = tf0.viterbi(T(np.stack(los)), lt_t).numpy()
    np.testing.assert_array_equal(got, np.stack(paths))
    assert (got == cfg.nbins).any() and (got < cfg.nbins).any()


@pytest.mark.parametrize("case", ["known_f0", "unvoiced_tail", "glide",
                                  "octave_trap"])
def test_track_matches_jax(case):
    """track() on test_f0.py's fixtures: voicing equal frame for frame and
    voiced F0 within 1e-4 relative of the JAX package's."""
    cfg = tf0.F0Config()
    if case == "known_f0":
        x, _ = _utt(1.0, 0, noise_level=0.02)
    elif case == "unvoiced_tail":
        x, _ = _utt(1.0, 0, noise_level=0.1, unvoiced_tail_frac=0.3)
    elif case == "glide":
        x, _ = _utt(0.35, 11)
        cfg = tf0.F0Config(f0_floor=90.0)
    else:
        x, _ = testsig.make_octave_trap(f0_base=200.0, fmt_mult=2.0)
        x = np.asarray(x, np.float32)
    ref = np.asarray(jf0.track(jf0.F0Config(**cfg._asdict()), x))
    got = tf0.track(cfg, x, device="cpu").numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    v = ref > 0
    np.testing.assert_allclose(got[v], ref[v], rtol=1e-4)


def test_octave_traps():
    """test_f0.py's octave-trap floors on the port: > 90% voiced and no
    octave error with the harmonic comb; the comb disabled really fails
    the f0 = 130 trap."""
    for f0b, mult in ((130.0, 2.0), (200.0, 2.0), (110.0, 3.0),
                      (90.0, 2.0)):
        x, f0t = testsig.make_octave_trap(f0_base=f0b, fmt_mult=mult)
        est = tf0.track(tf0.F0Config(), np.asarray(x, np.float32),
                        device="cpu").numpy()
        v = est > 0
        assert v.mean() > 0.9, (f0b, mult, v.mean())
        ref = np.interp(np.where(v)[0], np.arange(len(f0t)), f0t)
        assert np.mean(np.abs(est[v] / ref - 1.0) < 0.1) == 1.0, (f0b, mult)
    x, f0t = testsig.make_octave_trap(f0_base=130.0, fmt_mult=2.0)
    est0 = tf0.track(tf0.F0Config(hs_weight=0.0), np.asarray(x, np.float32),
                     device="cpu").numpy()
    v = est0 > 0
    ref = np.interp(np.where(v)[0], np.arange(len(f0t)), f0t)
    assert np.mean(np.abs(est0[v] / ref - 1.0) < 0.1) < 0.5


def test_rows_alone_equal_their_rows_in_a_batch():
    """track_batch on three padded rows gives, bit for bit, each row's
    track alone (a batch of one), and the first rows of a 70-row batch
    (two row groups) too."""
    xs = [_utt(0.5, s, noise_level=0.05 * (s % 2))[0] for s in range(3)]
    n = max(len(x) for x in xs)
    batch = np.stack([np.pad(x, (0, n - len(x))) for x in xs])
    cfg = tf0.F0Config()
    whole = tf0.track_batch(cfg, batch, device="cpu")
    assert whole.shape == (3, n // cfg.nhop)
    for r in range(3):
        assert torch.equal(tf0.track(cfg, batch[r], device="cpu"), whole[r])
    big = tf0.track_batch(cfg, np.concatenate([batch] * 24)[:70],
                          device="cpu")
    assert torch.equal(big[:3], whole) and torch.equal(big[66:69], whole)


def test_numpy_input_defaults_to_the_card():
    """track on numpy input runs on "cuda" unless device="cpu" is given:
    without a card it raises; a tensor stays on its device."""
    x, _ = _utt(0.2, 0)
    cfg = tf0.F0Config()
    assert tf0.track(cfg, T(x)).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tf0.track(cfg, x)
