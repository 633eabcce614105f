"""The PyTorch port's layer-1 codec against the JAX package on the CPU: the
LF model, the spectral and interpolation primitives, the Rd tables, the
Viterbi path, the Rd fit and chunk_to_layer1 on an LF fixture with a known
Rd, and the layer0 -> layer1 -> layer0 round trip on the 1 s bench-style
utterance.  Inputs are made from seeds with numpy and handed to both
packages; the JAX layer-0 analysis runs its Pallas branch in interpret
mode.  Each test states its tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import layer1 as jl1
from libllsm2_tpu.ops import lf as jlf
from libllsm2_tpu.ops import spectral as jsp
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import (CHUNK_FIELDS, LAYER0_FIELDS,
                                          chunk_from_numpy, chunk_to_numpy)
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.ops import interp as tinterp
from libllsm2_tpu_torch.ops import lf as tlf
from libllsm2_tpu_torch.ops import spectral as tsp
from libllsm2_tpu_torch.utils import testsig as tts

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))
RD_TRUE = 1.4
RD = np.concatenate([[0.01, 0.05, 0.1, 6.0, 8.0],
                     np.geomspace(0.1, 3.0, 40)]).astype(np.float32)


def _carry(jchunk, fields=LAYER0_FIELDS, batch=True):
    """A JAX chunk's fields as a port chunk on the CPU (batch axis added)."""
    d = {f: np.asarray(getattr(jchunk, f)) for f in fields}
    if batch:
        d = {f: v[None] for f, v in d.items()}
    return chunk_from_numpy(d, tpkg.ChunkConf(), device="cpu")


def _jopt():
    return dataclasses.replace(jpkg.create_aoptions(), use_pallas=True)


def test_lf_model_matches():
    """lf_from_rd (clipped ends included), lf_spectrum on 0..40 harmonics
    and lf_flow_deriv over [-0.1, 1.1]: relative 1e-5 on the parameters,
    1e-4 on the spectrum (relative to max(|S|, 1e-3)), 1e-5 x peak on the
    flow derivative -- float32 transcendentals of two libraries."""
    pj = jlf.lf_from_rd(jnp.asarray(RD))
    pt = tlf.lf_from_rd(T(RD))
    for name, a, b in zip(pj._fields, pj, pt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    col = lambda p: p.map(lambda a: a[:, None])
    f = np.linspace(0.0, 40.0, 97).astype(np.float32)
    sj = np.asarray(jlf.lf_spectrum(f[None], jax.tree.map(lambda a: a[:, None],
                                                           pj)))
    st = tlf.lf_spectrum(T(f)[None], col(pt)).numpy()
    assert np.max(np.abs(st - sj) / np.maximum(np.abs(sj), 1e-3)) < 1e-4
    t = np.linspace(-0.1, 1.1, 301).astype(np.float32)
    fj = np.asarray(jlf.lf_flow_deriv(t[None], jax.tree.map(
        lambda a: a[:, None], pj)))
    ft = tlf.lf_flow_deriv(T(t)[None], col(pt)).numpy()
    np.testing.assert_allclose(ft, fj, atol=1e-5 * np.abs(fj).max())


def test_spectral_primitives_match():
    """minphase phase / spectrum, cepstrum round trip, qifft and linear
    upsampling on random inputs: 1e-5 absolute (float32 FFTs)."""
    rng = np.random.default_rng(3)
    lm = rng.standard_normal((4, 5, 65)).astype(np.float32)
    np.testing.assert_allclose(tsp.minphase_phase(T(lm)).numpy(),
                               np.asarray(jsp.minphase_phase(lm)), atol=1e-5)
    np.testing.assert_allclose(tsp.minphase_spectrum(T(lm)).numpy(),
                               np.asarray(jsp.minphase_spectrum(lm)),
                               atol=1e-5 * np.exp(np.abs(lm).max()))
    ceps = tsp.spec_to_cepstrum(T(lm))
    np.testing.assert_allclose(ceps.numpy(),
                               np.asarray(jsp.spec_to_cepstrum(lm)), atol=1e-5)
    np.testing.assert_allclose(tsp.cepstrum_to_spec(ceps).numpy(),
                               np.asarray(jsp.cepstrum_to_spec(
                                   np.asarray(ceps))), atol=1e-5)
    k = rng.integers(-2, 68, (4, 5))                  # clamped at both ends
    for a, b in zip(tsp.qifft(T(lm), T(k)),
                    jsp.qifft(jnp.asarray(lm), jnp.asarray(k))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for os_ in (1, 4):
        np.testing.assert_allclose(tsp.upsample_linear(T(lm), os_).numpy(),
                                   np.asarray(jsp.upsample_linear(lm, os_)),
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["random", "repeated", "ends"])
def test_interp_matches_jnp_interp(case):
    """The batched interp against jnp.interp per row: x below, on and above
    the knots, runs of equal knots; 1e-6 x the value range."""
    rng = np.random.default_rng(7)
    B, P, M = 3, 12, 300
    xp = np.sort(rng.uniform(0, 10, (B, P)), axis=-1).astype(np.float32)
    if case == "repeated":
        xp[:, 4:7] = xp[:, 4:5]
        xp[:, -2:] = xp[:, -1:]
        xp[1, :3] = xp[1, :1]
    fp = rng.standard_normal((B, P)).astype(np.float32)
    x = rng.uniform(-2, 12, (B, M)).astype(np.float32)
    if case != "random":
        x[:, :P] = xp
        x[:, P] = xp[:, 0] - 1.0
        x[:, P + 1] = xp[:, -1] + 1.0
    got = tinterp.interp(T(x), T(xp), T(fp)).numpy()
    for b in range(B):
        np.testing.assert_allclose(got[b], np.asarray(jnp.interp(x[b], xp[b],
                                                                 fp[b])),
                                   atol=1e-6 * np.ptp(fp))
    shared = tinterp.interp(T(x[0]), T(xp), T(fp)).numpy()   # broadcast x
    np.testing.assert_allclose(shared[1], np.asarray(
        jnp.interp(x[0], xp[1], fp[1])), atol=1e-6 * np.ptp(fp))


@pytest.mark.parametrize("rows", [tl1.RD_GRID_SIZE, tl1.RD_SRC_ROWS])
def test_source_and_phase_dev_tables_match(rows):
    """The Rd tables (K = 80): grid exact, log magnitude 1e-4, unwrapped
    phase and the phase-deviation table 5e-4 rad (float32 LF spectra of
    two libraries, unwrapped over ~1000 fine rows)."""
    gj, lj, pj = jl1._source_tables(80, rows)
    gt, lt, pt = tl1._source_tables(80, rows)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=5e-4)
    if rows == tl1.RD_GRID_SIZE:
        np.testing.assert_allclose(tl1._phase_dev_tables(80).numpy(),
                                   np.asarray(jl1._phase_dev_tables(80)),
                                   atol=5e-4)


def test_rd_viterbi_matches():
    """Random scores of three utterances with unvoiced runs: the same grid
    path as the JAX scan, frame for frame."""
    rng = np.random.default_rng(11)
    B, N, G = 3, 120, tl1.RD_GRID_SIZE
    score = rng.uniform(0.0, 1.0, (B, N, G)).astype(np.float32)
    voiced = rng.uniform(size=(B, N)) > 0.15
    voiced[0, 40:60] = False
    got = tl1._rd_viterbi(T(score), T(voiced), 10.0).numpy()
    for b in range(B):
        ref = np.asarray(jl1._rd_viterbi(jnp.asarray(score[b]),
                                         jnp.asarray(voiced[b]), 10.0))
        np.testing.assert_array_equal(got[b], ref)


@pytest.fixture(scope="module")
def lf_ref():
    """A 1 s LF fixture of known Rd 1.4 (an in-model source: the Rd score
    has a clear peak in every voiced frame): the JAX layer-0 chunk and its
    JAX layer-1 chunk."""
    f0 = jts.make_f0_track(200, 0.005)
    x, f0 = jts.synth_lf_speech(f0, rd=RD_TRUE)
    ch = jl0.analyze(_jopt(), x.astype(np.float32), f0.astype(np.float32))
    return ch, jl1.chunk_to_layer1(ch)


def test_fit_rd_phase_matches(lf_ref):
    """fit_rd_phase with and without the continuity prior on an in-model
    source, where the Rd score has a clear peak: within 1e-3 relative."""
    ch, _ = lf_ref
    la = np.where(np.asarray(ch.hm_mask) > 0,
                  np.log(np.maximum(np.asarray(ch.ampl), 1e-10)), -23.0)
    args = (la, np.asarray(ch.phse), np.asarray(ch.hm_mask), np.asarray(ch.f0))
    for smooth in (10.0, 0.0):
        ref = np.asarray(jl1.fit_rd_phase(*map(jnp.asarray, args),
                                          smooth=smooth))
        got = tl1.fit_rd_phase(*(T(a)[None] for a in args),
                               smooth=smooth)[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_chunk_to_layer1_matches(lf_ref):
    """chunk_to_layer1 on the LF fixture: rd within 1e-3 relative; vtmagn
    within 2e-3 (log units); the voice-source phase within 1e-2 rad on
    harmonics above -60 dB of the frame's peak; rd within 15% of the truth
    (the JAX suite's criterion, tests/test_layer1.py)."""
    ch, l1 = lf_ref
    got = chunk_to_numpy(tl1.chunk_to_layer1(_carry(ch)))
    got = {f: v[0] for f, v in got.items()}
    np.testing.assert_allclose(got["rd"], np.asarray(l1.rd), rtol=1e-3)
    np.testing.assert_allclose(got["vtmagn"], np.asarray(l1.vtmagn), atol=2e-3)
    a = np.asarray(ch.ampl)
    live = a > 1e-3 * a.max(axis=-1, keepdims=True)
    dph = np.angle(np.exp(1j * (got["vsphse"] - np.asarray(l1.vsphse))))
    assert np.abs(dph[live]).max() < 1e-2
    assert abs(np.median(got["rd"][20:-20]) - RD_TRUE) <= 0.15 * RD_TRUE


def test_public_single_chunk_api(lf_ref):
    """chunk_to_layer1 / chunk_to_layer0 on a chunk without a batch axis
    give the batched rows, with and without sections=; a layer-0 chunk
    refuses chunk_to_layer0."""
    ch, _ = lf_ref
    single = _carry(ch, batch=False)
    l1 = tpkg.models.chunk_to_layer1(single)
    assert l1.has_layer1 and l1.rd.shape == (ch.nfrm,)
    batched = tl1.chunk_to_layer1(_carry(ch))
    np.testing.assert_array_equal(l1.rd.numpy(), batched.rd[0].numpy())
    back = tpkg.models.chunk_to_layer0(l1)
    assert back.ampl.shape == single.ampl.shape
    with pytest.raises(ValueError, match="layer-1"):
        tl1.chunk_to_layer0(single)
    secs = ((250.0, 60.0, -1),)
    np.testing.assert_array_equal(
        tl1.chunk_to_layer1(single, sections=secs).rd.numpy(),
        tl1.chunk_to_layer1(_carry(ch), sections=secs).rd[0].numpy())


@pytest.fixture(scope="module")
def bench_ref():
    """The 1 s bench-style utterance (make_test_utterance, seed 0, breath
    noise 0.05): JAX layer-0 chunk and JAX layer0 -> layer1 -> layer0."""
    x, f0, x_ref = jts.make_test_utterance(duration=1.0, noise_level=0.05,
                                           return_parts=True)
    ch = jl0.analyze(_jopt(), x.astype(np.float32), f0.astype(np.float32))
    l1 = jl1.chunk_to_layer1(ch)
    return ch, l1, jl1.chunk_to_layer0(l1), x_ref


def _snr(ref, y, margin=457):
    ref, y = ref[margin:-margin], y[margin:-margin]
    return 10.0 * np.log10(np.sum(ref ** 2) / np.sum((ref - y) ** 2))


def test_layer1_round_trip_matches(bench_ref):
    """layer0 -> layer1 -> layer0 on the out-of-model bench utterance (rd
    is near-flat there, so only what vsphse makes rd-invariant is held):
    the regenerated harmonics within 1e-4 x scale of the JAX ones, the
    mask equal, and y_sin's SNR against the clean harmonic part within
    0.05 dB of the JAX package's."""
    ch, _, back_j, x_ref = bench_ref
    back = tl1.chunk_to_layer0(tl1.chunk_to_layer1(_carry(ch)))
    zj = np.asarray(back_j.ampl) * np.exp(1j * np.asarray(back_j.phse))
    zt = back.ampl[0].numpy() * np.exp(1j * back.phse[0].numpy())
    np.testing.assert_array_equal(back.hm_mask[0].numpy(),
                                  np.asarray(back_j.hm_mask))
    np.testing.assert_allclose(zt, zj, atol=1e-4 * np.abs(zj).max())
    sopt = dataclasses.replace(tpkg.create_soptions(), use_pallas=True)
    jsopt = dataclasses.replace(jpkg.create_soptions(), use_pallas=True)
    y_t = tl0._synthesize(sopt, back).y_sin[0].numpy()
    y_j = np.asarray(jl0.synthesize(jsopt, back_j).y_sin)
    s_t, s_j = _snr(x_ref, y_t), _snr(x_ref, y_j)
    assert abs(s_t - s_j) <= 0.05, (s_t, s_j)


def test_synth_lf_speech_copy_matches():
    """The port's copy of synth_lf_speech (pulse shape from the port's LF
    model) against the JAX package's: a scalar Rd with antiformants, and a
    per-frame Rd track; 1e-6 of the unit peak."""
    f0 = jts.make_f0_track(120, 0.005, unvoiced_tail_frac=0.1)
    for kw in (dict(rd=0.8, zeros=((900.0, 100.0),)),
               dict(rd=np.linspace(0.4, 2.7, 120), noise_level=0.0, seed=3)):
        xj, fj = jts.synth_lf_speech(f0, **kw)
        xt, ft = tts.synth_lf_speech(f0, **kw)
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_allclose(xt, xj, atol=1e-6)


def test_numpy_input_runs_on_the_card_by_default():
    """analyze and chunk_from_numpy put numpy input on "cuda" unless the
    caller passes device="cpu": without a card the default raises (no
    fallback); a tensor stays on its device."""
    x, f0 = tts.make_test_utterance(duration=0.2)
    x, f0 = x.astype(np.float32), f0.astype(np.float32)
    opt = dataclasses.replace(tpkg.create_aoptions(), use_pallas=True,
                              conf=tpkg.ChunkConf(maxnhar=8, npsd=16, nspec=33,
                                                  f0_floor=90.0, fnyq=4000.0))
    ch = tpkg.analyze(opt, x, f0, device="cpu")
    assert ch.ampl.device.type == "cpu"
    assert tpkg.analyze(opt, torch.tensor(x), torch.tensor(f0)).ampl.device \
        .type == "cpu"
    d = chunk_to_numpy(ch)
    if torch.cuda.is_available():
        assert tpkg.analyze(opt, x, f0).ampl.device.type == "cuda"
        assert chunk_from_numpy(d, opt.conf).f0.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tpkg.analyze(opt, x, f0)
        with pytest.raises((AssertionError, RuntimeError)):
            chunk_from_numpy(d, opt.conf)
    assert set(d) == set(LAYER0_FIELDS) and set(CHUNK_FIELDS) > set(d)
