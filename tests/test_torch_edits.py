"""The PyTorch port's chunk utilities and parameter-domain edits against the
JAX package on the CPU: create_chunk, extras, frame, the phase utilities
(cumulative_cycles wrap-aware against the JAX scan over short spans and
against the float64 integral, phase_propagate / phase_shift / phase_sync
through exp(i phi)), the ten edits of models/edits.py on a layer-1 LF
fixture carried across from the JAX package, and the batch API
(analyze_batch / synthesize_batch).  Inputs are made from seeds with
numpy; each test states its tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu import container as jcont
from libllsm2_tpu.models import edits as jed
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import layer1 as jl1
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import CHUNK_FIELDS, chunk_from_numpy
from libllsm2_tpu_torch.models import edits as ted
from libllsm2_tpu_torch.models import layer0 as tl0

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))
PHASES = {"phse": "ampl", "vsphse": "ampl", "eenv_p": "eenv_a"}


def _carry(jchunk):
    """Every field of a JAX chunk as a port chunk on the CPU."""
    d = {f: np.asarray(getattr(jchunk, f)) for f in CHUNK_FIELDS
         if getattr(jchunk, f) is not None}
    return chunk_from_numpy(d, tpkg.ChunkConf(**dataclasses.asdict(
        jchunk.conf)), device="cpu")


def _random_chunk(pkg_conf, N, seed, batch=()):
    """f0 in [100, 200] Hz (a few unvoiced frames), phases in (-3, 3), all
    slots live -> numpy fields."""
    rng = np.random.default_rng(seed)
    K = pkg_conf.maxnhar
    f0 = rng.uniform(100, 200, batch + (N,)).astype(np.float32)
    f0[..., :3] = 0.0
    return dict(f0=f0,
                phse=rng.uniform(-3, 3, batch + (N, K)).astype(np.float32),
                hm_mask=np.ones(batch + (N, K), np.float32),
                ampl=rng.uniform(0, 1, batch + (N, K)).astype(np.float32))


def _both(d):
    """A JAX chunk and a port chunk with the fields of d, zeros elsewhere."""
    conf = jpkg.ChunkConf()
    shape = d["f0"].shape
    j = jpkg.create_chunk(conf, shape[-1], shape[:-1]).replace(
        **{k: jnp.asarray(v) for k, v in d.items()})
    t = tpkg.create_chunk(tpkg.ChunkConf(), shape[-1], shape[:-1],
                          device="cpu").replace(**{k: T(v)
                                                   for k, v in d.items()})
    return j, t


def _phase_err(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64)
                                        - np.asarray(b, np.float64)))))


def test_create_chunk_shapes_and_device():
    """create_chunk's shapes (test_container's) on the CPU when asked; the
    default is the card, which raises without one."""
    conf = tpkg.ChunkConf()
    ch = tpkg.create_chunk(conf, 100, device="cpu")
    assert ch.f0.shape == (100,)
    assert ch.ampl.shape == (100, conf.maxnhar)
    assert ch.psd.shape == (100, conf.npsd)
    assert ch.eenv_a.shape == (100, conf.nchannel, conf.maxnhar_e)
    assert not ch.has_layer1 and ch.extras is None
    assert tpkg.create_chunk(conf, 5, (2, 3), device="cpu").ampl.shape == \
        (2, 3, 5, conf.maxnhar)
    if torch.cuda.is_available():
        assert tpkg.create_chunk(conf, 4).f0.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tpkg.create_chunk(conf, 4)


@pytest.mark.parametrize("N", [200, 2000])
def test_cumulative_cycles_matches_float64(N):
    """The port against the float64 trapezoidal integral within 1e-6
    cycles (it sums in float64) at 200 and 2000 frames; the JAX float32
    scan within 1e-3 (test_container's bound)."""
    rng = np.random.default_rng(0)
    f0 = rng.uniform(80, 300, size=N).astype(np.float32)
    f0[5:9] = 0.0
    thop = 0.005
    f0z = np.maximum(f0.astype(np.float64), 0.0)
    ref = np.concatenate([[0.0], np.cumsum(0.5 * (f0z[:-1] + f0z[1:])
                                           * thop)]) % 1.0
    wrap = lambda a: np.abs((np.asarray(a, np.float64) - ref + 0.5) % 1.0 - 0.5)
    got = tpkg.cumulative_cycles(T(f0), thop).numpy()
    assert got.dtype == np.float32 and got.min() >= 0.0 and got.max() < 1.0
    assert wrap(got).max() < 1e-6, wrap(got).max()
    assert wrap(jpkg.cumulative_cycles(jnp.asarray(f0), thop)).max() < 1e-3


def test_cumulative_cycles_matches_jax_over_short_spans():
    """Over 64 frames (before the JAX scan drifts) the two packages agree
    within 2e-6 cycles, wrap-aware, on each row of a batch."""
    rng = np.random.default_rng(1)
    f0 = rng.uniform(80, 300, size=(3, 64)).astype(np.float32)
    f0[1, 10:20] = 0.0
    got = tpkg.cumulative_cycles(T(f0), 0.005).numpy()
    for b in range(3):
        ref = np.asarray(jpkg.cumulative_cycles(jnp.asarray(f0[b]), 0.005))
        d = (got[b].astype(np.float64) - ref + 0.5) % 1.0 - 0.5
        assert np.abs(d).max() < 2e-6, np.abs(d).max()


def test_phase_propagate_roundtrip_and_matches_jax():
    """phase_propagate(-1) then (+1) returns the phases within 1e-4 rad;
    each direction matches the JAX package within 1e-3 rad (the cycle
    tracks differ by the JAX scan's float32 drift over 50 frames times
    up to 80 harmonics), on a single chunk and a batch of two."""
    for batch in ((), (2,)):
        j, t = _both(_random_chunk(jpkg.ChunkConf(), 50, 1, batch))
        back = tpkg.phase_propagate(tpkg.phase_propagate(t, -1), +1)
        assert _phase_err(back.phse, t.phse).max() < 1e-4
        for sign in (-1, 1):
            got = tpkg.phase_propagate(t, sign).phse.numpy()
            if batch:
                ref = np.stack([np.asarray(jpkg.phase_propagate(
                    jcont.Chunk(**{f: getattr(j, f)[b] for f in
                                   ("f0", "ampl", "phse", "hm_mask", "psd",
                                    "edc", "eenv_a", "eenv_p")},
                                conf=j.conf), sign).phse) for b in range(2)])
            else:
                ref = np.asarray(jpkg.phase_propagate(j, sign).phse)
            assert _phase_err(got, ref).max() < 1e-3


def test_phase_shift_and_sync_match_jax():
    """phase_shift by a quarter period advances the fundamental by pi/2
    (test_container's check) and matches the JAX package within 1e-5 rad;
    phase_sync zeroes the fundamental and matches within 1e-4 rad (the port
    reduces (k+1) phi_0 in cycles first, the JAX package in radians)."""
    j, t = _both(_random_chunk(jpkg.ChunkConf(), 6, 2))
    ch = t.replace(f0=torch.full((6,), 100.0))
    out = tpkg.phase_shift(ch, 0.0025)
    assert _phase_err(out.phse[:, 0] - ch.phse[:, 0], np.pi / 2).max() < 1e-5
    for dt in (0.0025, 0.0131):
        got = tpkg.phase_shift(t, dt).phse.numpy()
        ref = np.asarray(jcont.phase_shift(j, dt).phse)
        assert _phase_err(got, ref).max() < 1e-5
    s = tpkg.phase_sync(t)
    np.testing.assert_allclose(s.phse[:, 0].numpy(), 0.0, atol=1e-5)
    assert _phase_err(s.phse, jpkg.phase_sync(j).phse).max() < 1e-4


def test_extras_frame_and_excerpt():
    """attach / detach / get (test_container's), frame(i) keeps a frame
    axis of length 1 (extras too), excerpt slices every field and extra on
    the frame axis, batched or not."""
    conf = tpkg.ChunkConf()
    ch = tpkg.create_chunk(conf, 8, device="cpu").attach(
        "marks", torch.arange(8.0))
    assert float(ch.get("marks")[3]) == 3.0
    assert ch.detach("marks").get("marks") is None
    assert ch.detach("marks").extras is None
    assert ch.get("missing", 42) == 42
    fr = ch.replace(f0=torch.arange(8.0)).frame(5)
    assert fr.f0.shape == (1,) and float(fr.f0[0]) == 5.0
    assert fr.ampl.shape == (1, conf.maxnhar) and float(fr.get("marks")[0]) == 5
    ex = ted.excerpt(ch, 2, 6)
    assert ex.nfrm == 4 and ex.eenv_p.shape[0] == 4
    np.testing.assert_array_equal(ex.get("marks").numpy(), [2, 3, 4, 5])
    bt = tpkg.create_chunk(conf, 8, (3,), device="cpu").attach(
        "marks", torch.arange(24.0).reshape(3, 8))
    exb = ted.excerpt(bt, 1, -1)
    assert exb.f0.shape == (3, 6) and exb.ampl.shape == (3, 6, conf.maxnhar)
    np.testing.assert_array_equal(exb.get("marks")[2].numpy(),
                                  np.arange(17.0, 23.0))
    assert bt.frame(7).f0.shape == (3, 1)


@pytest.fixture(scope="module")
def l1_pair():
    """A 1 s LF fixture of known Rd 1.4 through the JAX package's analysis
    and chunk_to_layer1 (an in-model source: rd stable), and a second
    layer-1 chunk of another length and pitch (JAX pitch_shift by 1.25,
    frames 20-170) -> (JAX a, JAX b, port a, port b)."""
    f0 = jts.make_f0_track(200, 0.005, unvoiced_tail_frac=0.1)
    x, f0 = jts.synth_lf_speech(f0, rd=1.4)
    opt = dataclasses.replace(jpkg.create_aoptions(), use_pallas=True)
    a = jl1.chunk_to_layer1(jl0.analyze(opt, x.astype(np.float32),
                                        f0.astype(np.float32)))
    b = jed.excerpt(jed.pitch_shift(a, 1.25), 20, 170)
    return a, b, _carry(a), _carry(b)


def _assert_chunks_close(got, ref, tol=1e-4):
    """got (port, no batch axis) against ref (JAX): f0, rd, vtmagn, psd,
    edc and eenv_a within tol relative to each field's peak; the mask
    equal; each phase field through its amplitude, |a e^{i phi} - a' e^{i
    phi'}| within tol x the peak amplitude."""
    assert got.nfrm == ref.nfrm
    for f in CHUNK_FIELDS:
        r = getattr(ref, f)
        g = getattr(got, f)
        assert (g is None) == (r is None), f
        if r is None:
            continue
        r, g = np.asarray(r, np.float64), g.numpy().astype(np.float64)
        if f == "hm_mask":
            np.testing.assert_array_equal(g, r)
        elif f in PHASES:
            amp = np.asarray(getattr(ref, PHASES[f]), np.float64)
            amp_g = getattr(got, PHASES[f]).numpy()
            err = np.abs(amp_g * np.exp(1j * g) - amp * np.exp(1j * r))
            assert err.max() <= tol * max(amp.max(), 1e-12), (f, err.max())
        else:
            scale = max(np.abs(r).max(), 1e-12)
            assert np.abs(g - r).max() <= tol * scale, \
                (f, np.abs(g - r).max(), scale)


EDITS = {
    "pitch_shift": (lambda m, a, b: m.pitch_shift(a, 2.0), 1e-4),
    "vibrato": (lambda m, a, b: m.vibrato(a, 5.0, 0.8), 1e-4),
    "tremolo": (lambda m, a, b: m.tremolo(a, 4.0, 4.0), 1e-5),
    "time_stretch": (lambda m, a, b: m.time_stretch(a, 1.5), 1e-4),
    "formant_shift": (lambda m, a, b: m.formant_shift(a, 1.3), 1e-4),
    "breathiness": (lambda m, a, b: m.breathiness(a, 6.0, rd_delta=0.3),
                    1e-4),
    "creak": (lambda m, a, b: m.creak(a, 0.5), 1e-4),
    "morph": (lambda m, a, b: m.morph(a, b, 0.4), 1e-4),
    "concat": (lambda m, a, b: m.concat(a, b, 8), 1e-4),
    "excerpt": (lambda m, a, b: m.excerpt(a, 40, 120), 0.0),
}


@pytest.mark.parametrize("name", list(EDITS))
def test_edit_matches_jax(l1_pair, name):
    """Each edit on the same layer-1 chunks in both packages: every field
    within the tolerance in EDITS (relative to the field's peak; phases
    through their amplitudes), the voicing mask equal; excerpt exactly."""
    ja, jb, ta, tb = l1_pair
    fn, tol = EDITS[name]
    _assert_chunks_close(fn(ted, ta, tb), fn(jed, ja, jb), tol)


@pytest.mark.parametrize("name", ["pitch_shift", "time_stretch", "morph",
                                  "concat"])
def test_batched_edit_rows_equal_single_edits(l1_pair, name):
    """An edit of a batch of two chunks gives, row by row, the edit of each
    chunk alone, within 1e-6 of each field's peak."""
    _, _, ta, tb = l1_pair
    fn = EDITS[name][0]
    rev = ta.map(lambda v: v.flip(0))          # frames in reverse order
    pair = ta.map(lambda v: torch.stack([v, v.flip(0)]))
    other = tb.map(lambda v: torch.stack([v, v]))
    got = fn(ted, pair, other)
    for r, single in ((0, ta), (1, rev)):
        alone = fn(ted, single, tb)
        for f in CHUNK_FIELDS:
            g, a = getattr(got, f), getattr(alone, f)
            if a is None:
                continue
            np.testing.assert_allclose(g[r].numpy(), a.numpy(), rtol=0,
                                       atol=1e-6 * max(float(a.abs().max()),
                                                       1e-12), err_msg=f)


def test_time_stretch_and_pitch_chain(l1_pair):
    """BASELINE config 4's chain on the port: pitch x2 then stretch x1.5
    gives round(1.5 nfrm) frames, the voiced median F0 doubled within 1e-4
    relative and a finite render."""
    _, _, ta, _ = l1_pair
    out = ted.time_stretch(ted.pitch_shift(ta, 2.0), 1.5)
    assert out.nfrm == round(1.5 * ta.nfrm)
    med = lambda c: float(torch.median(c.f0[c.f0 > 0]))
    assert abs(med(out) / med(ta) - 2.0) <= 2e-4
    sopt = dataclasses.replace(tpkg.create_soptions(), use_pallas=True)
    y = tpkg.synthesize(sopt, out).y
    assert y.shape == (out.nfrm * 80,) and bool(torch.isfinite(y).all())


def test_edits_refuse_a_layer0_chunk(l1_pair):
    """Edits that regenerate harmonics need layer 1; two-chunk edits need
    one ChunkConf."""
    _, _, ta, tb = l1_pair
    l0 = ta.replace(rd=None, vtmagn=None, vsphse=None)
    for fn in (ted.pitch_shift, ted.creak, ted.formant_shift):
        with pytest.raises(ValueError, match="layer-1"):
            fn(l0, 1.5)
    with pytest.raises(ValueError, match="ChunkConf"):
        ted.concat(ta, tb.replace(conf=dataclasses.replace(tb.conf,
                                                            maxnhar=60)))


def test_batch_api_equals_private_calls():
    """analyze_batch / synthesize_batch give _analyze / _synthesize's
    tensors exactly, on the CPU when asked; numpy input defaults to the
    card."""
    conf = tpkg.ChunkConf(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0,
                          fnyq=6000.0)
    opt = dataclasses.replace(tpkg.create_aoptions(), conf=conf,
                              use_pallas=True)
    sopt = dataclasses.replace(tpkg.create_soptions(), use_pallas=True)
    rows = [jts.make_test_utterance(duration=0.3, seed=s, noise_level=nl)
            for s, nl in ((0, 0.05), (1, 0.0))]
    x = np.stack([r[0] for r in rows]).astype(np.float32)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    got = tpkg.analyze_batch(opt, x, f0, device="cpu")
    ref = tl0._analyze(opt, T(x), T(f0))
    for f in CHUNK_FIELDS:
        if getattr(ref, f) is not None:
            assert torch.equal(getattr(got, f), getattr(ref, f)), f
    out, out_ref = tpkg.synthesize_batch(sopt, got), tl0._synthesize(sopt, ref)
    for a, b in zip(out[:3], out_ref[:3]):
        assert torch.equal(a, b)
    assert out.y.shape == x.shape
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tpkg.analyze_batch(opt, x, f0)
