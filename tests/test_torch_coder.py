"""The PyTorch port's frame coder, quantizer and archives against the JAX
package on the CPU.  Parity runs on the layer-1 chunk of
tests/test_torch_layer1.py's fixture (1 s of LF speech, Rd 1.4: the JAX
analysis, Pallas branch in interpret mode, carried across); the JAX
suite's floors (tests/test_coder.py) run on the port's own analysis of
test_coder.py's fixture (0.6 s, breath noise 0.05).  The quantizer is
numpy in both packages, so its codes are held equal bit for bit.  Each
test states its tolerance."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import coder as jcoder
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import layer1 as jl1
from libllsm2_tpu.utils import serialize as jser
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import CHUNK_FIELDS, chunk_from_numpy
from libllsm2_tpu_torch.models import coder as tcoder
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.utils import metrics as tmetrics
from libllsm2_tpu_torch.utils import serialize as tser
from libllsm2_tpu_torch.utils import testsig as tts

torch.set_num_threads(1)
PHASE = [False, True]


def _sopt():
    return dataclasses.replace(tpkg.create_soptions(), use_pallas=True)


def _ccs(conf, with_phase):
    return (jcoder.CoderConfig(conf=jpkg.ChunkConf(), with_phase=with_phase),
            tcoder.CoderConfig(conf=conf, with_phase=with_phase))


@pytest.fixture(scope="module")
def lf_l1():
    """tests/test_torch_layer1.py's LF fixture: the JAX layer-1 chunk and
    the same chunk as a port chunk on the CPU (no batch axis)."""
    f0 = jts.make_f0_track(200, 0.005)
    x, f0 = jts.synth_lf_speech(f0, rd=1.4)
    opt = dataclasses.replace(jpkg.create_aoptions(), use_pallas=True)
    l1 = jl1.chunk_to_layer1(jl0.analyze(opt, x.astype(np.float32),
                                         f0.astype(np.float32)))
    d = {f: np.asarray(getattr(l1, f)) for f in CHUNK_FIELDS}
    return l1, chunk_from_numpy(d, tpkg.ChunkConf(), device="cpu")


@pytest.fixture(scope="module")
def l1chunk():
    """tests/test_coder.py's fixture through the port on the CPU: (x, the
    layer-1 chunk)."""
    x, f0 = tts.make_test_utterance(duration=0.6, noise_level=0.05)
    opt = dataclasses.replace(tpkg.create_aoptions(), use_pallas=True)
    ch = tl0.analyze(opt, x.astype(np.float32), f0.astype(np.float32),
                     device="cpu")
    return x, tl1.chunk_to_layer1(ch)


@pytest.mark.parametrize("with_phase", PHASE)
def test_layout_and_dims_match_jax(lf_l1, with_phase):
    jl, tl = lf_l1
    jc, tc = _ccs(tl.conf, with_phase)
    assert tc.layout() == jc.layout() and tc.dims == jc.dims
    v = tcoder.encode(tc, tl)
    assert tuple(v.shape) == (tl.nfrm, tc.dims) and bool(v.isfinite().all())
    batched = tcoder.encode(tc, tl.map(lambda a: a[None]))
    assert tuple(batched.shape) == (1, tl.nfrm, tc.dims)
    torch.testing.assert_close(batched[0], v, rtol=0, atol=0)


@pytest.mark.parametrize("with_phase", PHASE)
def test_encode_matches_jax(lf_l1, with_phase):
    """Vectors within 1e-4 absolute: the two libraries' linspace grids, on
    which vtmagn and the log PSD are resampled, differ by up to one
    float32 ulp (1.5e-5 bins at 256), times the envelope's slope."""
    jl, tl = lf_l1
    jc, tc = _ccs(tl.conf, with_phase)
    np.testing.assert_allclose(tcoder.encode(tc, tl).numpy(),
                               np.asarray(jcoder.encode(jc, jl)), atol=1e-4)


@pytest.mark.parametrize("with_phase", PHASE)
def test_decode_layer1_matches_jax(lf_l1, with_phase):
    """decode_layer1 of the JAX package's vectors: every field within 1e-5
    absolute (vtmagn, psd relative); harmonics empty."""
    jl, tl = lf_l1
    jc, tc = _ccs(tl.conf, with_phase)
    v = np.asarray(jcoder.encode(jc, jl))
    ref, got = jcoder.decode_layer1(jc, v), tcoder.decode_layer1(
        tc, v, device="cpu")
    for f in CHUNK_FIELDS:
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert g.shape == r.shape, f
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=f)
    assert float(got.ampl.abs().max()) == 0.0


@pytest.mark.parametrize("fn", ["decode", "decode_frames"])
@pytest.mark.parametrize("with_phase", PHASE)
def test_decode_matches_jax(lf_l1, fn, with_phase):
    """decode / decode_frames of the JAX package's vectors: the harmonics
    within 1e-4 x scale (as the layer-1 round trip), the mask equal; where
    decode propagates the phases (with_phase=False), within 1e-3 x scale:
    the JAX package's cycle track drifts in its float32 scan
    (test_phase_propagate_roundtrip_and_matches_jax's 1e-3 rad)."""
    jl, tl = lf_l1
    jc, tc = _ccs(tl.conf, with_phase)
    v = np.asarray(jcoder.encode(jc, jl))
    ref = getattr(jcoder, fn)(jc, v)
    got = getattr(tcoder, fn)(tc, torch.tensor(v))
    zj = np.asarray(ref.ampl) * np.exp(1j * np.asarray(ref.phse))
    zt = got.ampl.numpy() * np.exp(1j * got.phse.numpy())
    np.testing.assert_array_equal(got.hm_mask.numpy(), np.asarray(ref.hm_mask))
    tol = 1e-3 if fn == "decode" and not with_phase else 1e-4
    np.testing.assert_allclose(zt, zj, atol=tol * np.abs(zj).max())


def test_batched_decode_rows_equal_single_decodes(lf_l1):
    """Two chunks' vectors decoded in one batched call give each chunk's
    own decode bit for bit."""
    _, tl = lf_l1
    tc = tcoder.CoderConfig(conf=tl.conf)
    v = tcoder.encode(tc, tl)
    two = torch.stack([v, v.flip(0)])
    both = tcoder.decode(tc, two)
    for b, vb in enumerate(two):
        one = tcoder.decode(tc, vb)
        for f in ("f0", "ampl", "phse", "rd", "vtmagn", "psd"):
            torch.testing.assert_close(getattr(both, f)[b], getattr(one, f),
                                       rtol=0, atol=0)


def test_numpy_vectors_go_to_the_card_by_default(lf_l1):
    _, tl = lf_l1
    tc = tcoder.CoderConfig(conf=tl.conf)
    v = tcoder.encode(tc, tl).numpy()
    assert tcoder.decode_layer1(tc, v, device="cpu").f0.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tcoder.decode_layer1(tc, v)


def test_with_phase_coder_near_lossless(l1chunk):
    """As test_coder.py: vsphse / eenv_p round-trip within 1e-6 and the
    with_phase decode's waveform error under a quarter of the phase-less
    one."""
    x, l1 = l1chunk
    cc = tcoder.CoderConfig(conf=l1.conf, with_phase=True)
    v = tcoder.encode(cc, l1)
    d1 = tcoder.decode_layer1(cc, v)
    torch.testing.assert_close(d1.vsphse, l1.vsphse, rtol=0, atol=1e-6)
    torch.testing.assert_close(d1.eenv_p, l1.eenv_p, rtol=0, atol=1e-6)

    def err(ccv):
        back = tcoder.decode(ccv, tcoder.encode(ccv, l1))
        y = tl0.synthesize(_sopt(), back).y_sin.numpy()
        n = min(len(x), len(y))
        lo, hi = int(0.1 * n), int(0.9 * n)
        return float(np.sum((x[lo:hi] - y[lo:hi]) ** 2))

    e_phase, e_nophase = err(cc), err(tcoder.CoderConfig(conf=l1.conf))
    assert e_phase < 0.25 * e_nophase, (e_phase, e_nophase)


@pytest.mark.parametrize("with_phase", PHASE)
def test_streaming_vector_decode_matches_offline(l1chunk, with_phase):
    """test_coder.py's two streaming cases on the port: vectors decoded
    block by block (decode_frames, 16 frames) into an RTSynthesizer --
    propagate mode for the phase-less coder, absolute mode for with_phase
    (its frames carry the absolute phases) -- render the offline decode's
    harmonic audio within 25 dB over the middle 80%."""
    from libllsm2_tpu_torch.runtime import rtsynth
    x, l1 = l1chunk
    cc = tcoder.CoderConfig(conf=l1.conf, with_phase=with_phase)
    v = tcoder.encode(cc, l1)
    sopt = _sopt()
    y_off = tl0.synthesize(sopt, tcoder.decode(cc, v)).y_sin.numpy()
    rt = rtsynth.RTSynthesizer(
        sopt, l1.conf, capacity_frames=l1.nfrm + 8, device="cpu",
        phase_mode="absolute" if with_phase else "propagate")
    out = []
    for s in range(0, v.shape[0], 16):
        rt.feed_many(tcoder.decode_frames(cc, v[s:s + 16]))
        out.append(rt.fetch(rt.readable()))
    rt.flush()
    out.append(rt.fetch(rt.readable()))
    y_st = np.concatenate(out)
    n = min(len(y_off), len(y_st))
    lo, hi = int(0.1 * n), int(0.9 * n)
    num = float(np.sum(y_off[lo:hi] ** 2))
    den = float(np.sum((y_off[lo:hi] - y_st[lo:hi]) ** 2))
    assert 10.0 * np.log10(num / max(den, 1e-12)) > 25.0


def test_decode_random_vectors_never_nan(l1chunk):
    """Arbitrary model outputs at scales 1, 1e3 and 1e6 decode to finite
    audio (decode_layer1's clamps)."""
    _, l1 = l1chunk
    cc = tcoder.CoderConfig(conf=l1.conf)
    rng = np.random.default_rng(0)
    for scale in (1.0, 1e3, 1e6):
        v = (scale * rng.standard_normal((30, cc.dims))).astype(np.float32)
        y = tl0.synthesize(_sopt(), tcoder.decode(cc, v, device="cpu")).y
        assert bool(torch.isfinite(y).all()), scale


def _quant_pair(v, cc, jc, bits, dpcm):
    kw = lambda mod, c: dict(dpcm=mod.default_dpcm_mask(c),
                             f0_slot=mod.f0_slot(c)) if dpcm else {}
    return (tcoder.fit_quantizer(v, bits=bits, **kw(tcoder, cc)),
            jcoder.fit_quantizer(v, bits=bits, **kw(jcoder, jc)))


@pytest.mark.parametrize("dpcm", [False, True])
@pytest.mark.parametrize("bits", [8, 16])
def test_quantizer_matches_jax_bit_for_bit(lf_l1, bits, dpcm):
    """fit_quantizer, quantize and dequantize on the same numpy vectors
    (two rows: the fixture's and its time reversal): ranges, codes and
    vectors equal, bit for bit; DPCM re-syncs at voicing onsets."""
    jl, tl = lf_l1
    jc, tc = _ccs(tl.conf, False)
    v = np.asarray(jcoder.encode(jc, jl))
    v = np.stack([v, v[::-1]])
    tq, jq = _quant_pair(v, tc, jc, bits, dpcm)
    for f in ("lo", "hi", "dpcm", "dlo", "dhi"):
        a, b = getattr(tq, f), getattr(jq, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tq.bits, tq.f0_slot) == (jq.bits, jq.f0_slot)
    codes = tcoder.quantize(tq, torch.tensor(v))
    np.testing.assert_array_equal(codes, jcoder.quantize(jq, v))
    np.testing.assert_array_equal(tcoder.dequantize(tq, codes),
                                  jcoder.dequantize(jq, codes))


def test_dpcm_voicing_resync_matches_jax():
    """test_coder.py's synthetic voicing runs: the port codes them as the
    JAX package does, bit for bit, and re-syncs at each voiced onset."""
    rng = np.random.default_rng(0)
    B, N = 2, 120
    f0 = np.zeros((B, N), np.float32)
    f0[:, 10:60] = 150.0
    f0[:, 70:110] = 220.0
    v = np.zeros((B, N, 4), np.float32)
    v[:, :, 0] = f0
    v[:, :, 1] = np.where(f0 > 0, 0.9 + np.cumsum(
        rng.normal(0, 0.003, (B, N)), axis=1), 1.0)
    v[:, :, 2:] = rng.normal(0, 1, (B, N, 2))
    mask = np.array([False, True, False, False])
    for kw in ({}, dict(f0_slot=0)):
        tq = tcoder.fit_quantizer(v, bits=8, dpcm=mask, **kw)
        jq = jcoder.fit_quantizer(v, bits=8, dpcm=mask, **kw)
        codes = tcoder.quantize(tq, v)
        np.testing.assert_array_equal(codes, jcoder.quantize(jq, v))
        np.testing.assert_array_equal(tcoder.dequantize(tq, codes),
                                      jcoder.dequantize(jq, codes))
    dv = tcoder.dequantize(tq, codes)
    onsets = (f0 > 0) & ~np.pad(f0 > 0, ((0, 0), (1, 0)))[:, :-1]
    # the onset frames are absolute: their codes are the affine codes
    absolute = np.round((np.clip(v, tq.lo, tq.hi) - tq.lo) / tq.step)
    np.testing.assert_array_equal(codes[onsets][:, 1], absolute[onsets][:, 1])
    assert np.abs((dv - v)[:, :, 1])[f0 > 0].max() < 0.6 * tq.step[1]


def _same_cc(a, b):
    assert (dataclasses.asdict(a.conf), a.nvt, a.npsd_c, a.with_phase) \
        == (dataclasses.asdict(b.conf), b.nvt, b.npsd_c, b.with_phase)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_coded_archives_load_in_the_other_package(lf_l1, tmp_path, writer,
                                                   bits):
    """A coded_save archive written by either package loads in the other
    with equal vectors (the 8-bit F0 side array included) and an equal
    CoderConfig."""
    jl, tl = lf_l1
    jc, tc = _ccs(tl.conf, False)
    v = np.asarray(jcoder.encode(jc, jl))
    path = str(tmp_path / "utt.llsm.npz")
    save, load = ((tser.coded_save, tc), jser.coded_load) \
        if writer == "port" else ((jser.coded_save, jc), tser.coded_load)
    save[0](path, save[1], v, bits=bits)
    cc2, v2 = load(path)
    other = jser if writer == "port" else tser
    cc3, v3 = other.coded_load(path)
    _same_cc(cc2, tc)
    _same_cc(cc3, tc)
    np.testing.assert_array_equal(v2, v3)
    assert v2.dtype == np.float32 and v2.shape == v.shape


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chunk_archives_load_in_the_other_package(lf_l1, tmp_path, writer):
    """chunk_save by either package, chunk_load by the other: every field
    and an extra equal, the conf equal."""
    jl, tl = lf_l1
    path = str(tmp_path / "chunk.npz")
    if writer == "port":
        tser.chunk_save(path, tl.attach("gain", tl.f0 * 0.5))
        got = jser.chunk_load(path)
        ref = {f: getattr(tl, f).numpy() for f in CHUNK_FIELDS}
        ref["gain"] = tl.f0.numpy() * 0.5
    else:
        jser.chunk_save(path, jl.attach("gain", jl.f0 * 0.5))
        got = tser.chunk_load(path, device="cpu")
        ref = {f: np.asarray(getattr(jl, f)) for f in CHUNK_FIELDS}
        ref["gain"] = np.asarray(jl.f0) * 0.5
    for f, r in ref.items():
        g = got.get(f) if f == "gain" else getattr(got, f)
        np.testing.assert_array_equal(np.asarray(g), r, err_msg=f)
    assert dataclasses.asdict(got.conf) == dataclasses.asdict(tl.conf)


def test_coded_archive_f0_side_channel(l1chunk, tmp_path):
    """As test_coder.py: the 8-bit archive's F0 at the 16-bit step,
    voicing exact, the decode's waveform within 25 dB of the float one."""
    _, l1 = l1chunk
    cc = tcoder.CoderConfig(conf=l1.conf)
    v = tcoder.encode(cc, l1).numpy()
    path = str(tmp_path / "utt8.llsm.npz")
    tser.coded_save(path, cc, v, bits=8)
    _, v2 = tser.coded_load(path)
    voiced = v[:, 0] > 0
    assert np.array_equal(v2[:, 0] == 0.0, ~voiced)
    q = tcoder.fit_quantizer(v, bits=8, dpcm=tcoder.default_dpcm_mask(cc),
                             f0_slot=tcoder.f0_slot(cc))
    ref = np.clip(v[voiced, 0], q.lo[0], q.hi[0])
    assert np.abs(v2[voiced, 0] - ref).max() < 2.0 * (q.hi[0] - q.lo[0]) \
        / 65535.0
    y0 = tl0.synthesize(_sopt(), tcoder.decode(cc, v, device="cpu")).y_sin
    yq = tl0.synthesize(_sopt(), tcoder.decode(cc, v2, device="cpu")).y_sin
    y0, yq = y0.numpy(), yq.numpy()
    lo, hi = int(0.05 * len(y0)), int(0.95 * len(y0))
    snr = 10 * np.log10(np.sum(y0[lo:hi] ** 2)
                        / max(np.sum((y0[lo:hi] - yq[lo:hi]) ** 2), 1e-12))
    assert snr > 25.0, snr


def test_transport_mcd_floors(l1chunk):
    """test_coder.py's rate-distortion floors on the port: the 16-bit
    transport under 0.05 dB MCD, 8 bits with voicing-aware DPCM under
    0.3 dB."""
    _, l1 = l1chunk
    cc = tcoder.CoderConfig(conf=l1.conf)
    v = tcoder.encode(cc, l1).numpy()
    y0 = tl0.synthesize(_sopt(), tcoder.decode(cc, v, device="cpu"))
    y0 = y0.y_sin.numpy()

    def mcd_of(bits, dpcm=False):
        kw = dict(dpcm=tcoder.default_dpcm_mask(cc),
                  f0_slot=tcoder.f0_slot(cc)) if dpcm else {}
        q = tcoder.fit_quantizer(v, bits=bits, **kw)
        dv = tcoder.dequantize(q, tcoder.quantize(q, v))
        y = tl0.synthesize(_sopt(), tcoder.decode(cc, dv, device="cpu"))
        y = y.y_sin.numpy()
        n = min(len(y0), len(y))
        return tmetrics.mel_cepstral_distortion_db(y0[:n], y[:n],
                                                   fs=cc.conf.fs)

    assert mcd_of(16) < 0.05
    assert mcd_of(8, dpcm=True) < 0.3
