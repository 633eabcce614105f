"""The PyTorch port's layer-0 round trip against the JAX package's Pallas
branch (use_pallas=True, interpret mode on the CPU), with the track
denoiser off and with the library default (denoiser on, spectral gate at
decimation 4), at the small verification shapes: chunk fields, harmonic
synthesis from a carried-across chunk, noise synthesis with the JAX noise
bins injected and drawn by the port (keyed by frame as jax.random keys
them), and the batched pipeline's per-row SNR."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.parallel import corpus as jcorpus
from libllsm2_tpu.utils import testsig

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import (LAYER0_FIELDS, chunk_from_numpy,
                                          chunk_to_numpy, index_batch)
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.ops import harmonics as thm
from libllsm2_tpu_torch.ops import kernels as tkernels
from libllsm2_tpu_torch.parallel import corpus as tcorpus

torch.set_num_threads(1)

CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
DUR = 0.3
ROWS = {"noisy": (0, 0.05), "noisy2": (1, 0.05), "clean": (2, 0.0),
        "clean2": (3, 0.0)}


def _opts(pkg, denoise=False, **change):
    opt = dataclasses.replace(pkg.create_aoptions(), conf=pkg.ChunkConf(**CONF),
                              track_denoise=denoise, use_pallas=True, **change)
    return opt, dataclasses.replace(pkg.create_soptions(), use_pallas=True)


def _jax_bins(seed, nfrm, nbin):
    """The JAX package's per-frame noise bins (layer0._synth_noise)."""
    key = jax.random.PRNGKey(seed)

    def frame(i):
        kr, ki = jax.random.split(jax.random.fold_in(key, i))
        return (jax.random.normal(kr, (nbin,), jnp.float32),
                jax.random.normal(ki, (nbin,), jnp.float32))

    re, im = jax.vmap(frame)(jnp.arange(nfrm, dtype=jnp.int32))
    return np.asarray(re), np.asarray(im)


def _fixtures():
    data = [testsig.make_test_utterance(duration=DUR, seed=s, noise_level=nl,
                                        return_parts=True)
            for s, nl in ROWS.values()]
    return tuple(np.stack([d[j] for d in data]).astype(np.float32)
                 for j in range(3))


@pytest.fixture(scope="module", params=["denoise_off", "denoise_on"])
def ref(request):
    """Both packages on the same four fixtures (two noisy, two clean), with
    the denoiser off or at the library default."""
    x, f0, x_ref = _fixtures()
    denoise = request.param == "denoise_on"
    jopt, jsopt = _opts(jpkg, denoise)
    topt, tsopt = _opts(tpkg, denoise)
    jchunks = [jl0._analyze_jit(jopt, jnp.asarray(x[i]), jnp.asarray(f0[i]))
               for i in range(len(ROWS))]
    tchunk = tl0._analyze(topt, torch.tensor(x), torch.tensor(f0))
    return dict(x=x, f0=f0, x_ref=x_ref, jopt=jopt, jsopt=jsopt, topt=topt,
                tsopt=tsopt, jchunks=jchunks, tchunk=tchunk)


@pytest.mark.parametrize("row", ["clean", "noisy"])
def test_analysis_chunk_matches(ref, row):
    i = list(ROWS).index(row)
    j = ref["jchunks"][i]
    t = {f: v[i] for f, v in chunk_to_numpy(ref["tchunk"]).items()}
    np.testing.assert_allclose(t["f0"], np.asarray(j.f0), rtol=1e-4)
    np.testing.assert_array_equal(t["hm_mask"], np.asarray(j.hm_mask))
    np.testing.assert_allclose(t["ampl"], np.asarray(j.ampl), atol=1e-3)
    scale = float(np.abs(np.asarray(j.ampl)).max())
    np.testing.assert_allclose(t["ampl"] * np.exp(1j * t["phse"]),
                               np.asarray(j.ampl) * np.exp(1j * np.asarray(j.phse)),
                               atol=1e-3 * scale)
    escale = float(np.abs(np.asarray(j.eenv_a)).max())
    np.testing.assert_allclose(
        t["eenv_a"] * np.exp(1j * t["eenv_p"]),
        np.asarray(j.eenv_a) * np.exp(1j * np.asarray(j.eenv_p)),
        atol=1e-3 * escale)
    # rtol 1e-3, plus an absolute floor of 1e-6 of the field's peak: on the
    # clean fixture the residual's high bins sit at float32 rounding level
    # (~1e-9), where both packages' values are rounding noise
    for f in ("psd", "edc"):
        jv = np.asarray(getattr(j, f))
        np.testing.assert_allclose(t[f], jv, rtol=1e-3,
                                   atol=1e-6 * float(np.abs(jv).max()))


@pytest.mark.parametrize("row", ["clean", "noisy"])
def test_synthesis_from_carried_chunk_matches(ref, row):
    """The JAX chunk carried across (numpy -> port Chunk): y_sin, and y_nos
    with the JAX noise bins injected through bins=."""
    i = list(ROWS).index(row)
    j = ref["jchunks"][i]
    d = {f: np.asarray(getattr(j, f))[None] for f in LAYER0_FIELDS}
    chunk = chunk_from_numpy(d, ref["topt"].conf, device="cpu")
    nhop = ref["topt"].conf.nhop
    bins = _jax_bins(ref["jsopt"].noise_seed, chunk.nfrm, nhop + 1)
    out = tl0._synthesize(ref["tsopt"], chunk,
                          bins=(bins[0][None], bins[1][None]))
    jout = jl0._synthesize_jit(ref["jsopt"], j)
    np.testing.assert_allclose(out.y_sin[0].numpy(), np.asarray(jout.y_sin),
                               atol=1e-3)
    np.testing.assert_allclose(out.y_nos[0].numpy(), np.asarray(jout.y_nos),
                               atol=1e-4)
    np.testing.assert_allclose(out.y[0].numpy(), np.asarray(jout.y),
                               atol=1e-3)


@pytest.mark.parametrize("seed,frame_base,nfrm,nbin", [
    (0, 0, 60, 81), (12345, 1537, 40, 161), (-1, 7, 9, 3)])
def test_noise_bins_match_jax_draw(seed, frame_base, nfrm, nbin):
    """The port's per-frame draw against jax.random's: the uint32 bits
    exactly, the normals within 1e-6 (XLA's erf_inv to an ulp); every row
    of the batch the same draw."""
    key = jax.random.PRNGKey(seed)

    def frame(i):
        kr, ki = jax.random.split(jax.random.fold_in(key, i))
        return tuple(f(k, (nbin,), d) for k in (kr, ki) for f, d in (
            (jax.random.normal, jnp.float32), (jax.random.bits, jnp.uint32)))

    jre, jbre, jim, jbim = map(np.asarray, jax.vmap(frame)(
        frame_base + jnp.arange(nfrm, dtype=jnp.int32)))
    re, im, bre, bim = tkernels.noise_bins(seed, frame_base, 2, nfrm, nbin,
                                           "cpu", bits=True)
    np.testing.assert_array_equal(bre.numpy().view(np.uint32), jbre)
    np.testing.assert_array_equal(bim.numpy().view(np.uint32), jbim)
    assert re.shape == im.shape == (2, nfrm, nbin)
    for b in range(2):
        np.testing.assert_allclose(re[b].numpy(), jre, atol=1e-6, rtol=0)
        np.testing.assert_allclose(im[b].numpy(), jim, atol=1e-6, rtol=0)


@pytest.mark.parametrize("row", ["clean", "noisy"])
def test_synthesis_draws_jax_noise(ref, row):
    """_synthesize with no bins injected: y_nos against the JAX
    synthesize's at the injected-bins tolerance."""
    i = list(ROWS).index(row)
    j = ref["jchunks"][i]
    chunk = chunk_from_numpy({f: np.asarray(getattr(j, f))[None]
                              for f in LAYER0_FIELDS}, ref["topt"].conf,
                             device="cpu")
    out = tl0._synthesize(ref["tsopt"], chunk)
    jout = jl0._synthesize_jit(ref["jsopt"], j)
    np.testing.assert_allclose(out.y_nos[0].numpy(), np.asarray(jout.y_nos),
                               atol=1e-4)


def test_chunk_alone_equals_its_row_in_a_batch(ref):
    """Row 1 of a batch of 3 and the same chunk alone render the same
    waveform, noise included, bit for bit on the CPU."""
    batch = index_batch(ref["tchunk"], slice(0, 3))
    alone = index_batch(ref["tchunk"], slice(1, 2))
    got = tl0._synthesize(ref["tsopt"], batch)
    one = tl0._synthesize(ref["tsopt"], alone)
    for g, o in zip(got[:3], one[:3]):
        assert torch.equal(g[1], o[0])


def test_noise_frame_base_renders_a_slice_of_the_whole(ref):
    """Frames [i0, i0+n) of a chunk rendered with frame_base=i0 (on the
    whole render's cycle track) give the whole render's samples wherever
    both of their overlapping segments lie in the slice."""
    ch = index_batch(ref["tchunk"], slice(0, 2))
    conf, sopt = ch.conf, ref["tsopt"]
    nhop, N = conf.nhop, ch.nfrm
    cyc = thm.sample_cycles(ch.f0, nhop, conf.fs, N * nhop)
    whole = tl0._synth_noise(ch, cyc, nhop, conf.fs, sopt.noise_seed)
    i0, n = 17, 23
    part = ch.replace(**{f: getattr(ch, f)[:, i0:i0 + n]
                         for f in LAYER0_FIELDS})
    got = tl0._synth_noise(part, cyc[:, i0 * nhop:(i0 + n) * nhop], nhop,
                           conf.fs, sopt.noise_seed, frame_base=i0)
    assert torch.equal(got[:, :(n - 1) * nhop],
                       whole[:, i0 * nhop:(i0 + n - 1) * nhop])
    other = tl0._synth_noise(part, cyc[:, i0 * nhop:(i0 + n) * nhop], nhop,
                             conf.fs, sopt.noise_seed)
    assert not torch.equal(other, got)


def test_synthesis_upsampled_matches(ref):
    """Rendering at 32 kHz (an integral hop of 160): harmonics above the
    new Nyquist are masked and the noise tapers off above the analysis
    band."""
    j = ref["jchunks"][list(ROWS).index("noisy")]
    chunk = chunk_from_numpy({f: np.asarray(getattr(j, f))[None]
                              for f in LAYER0_FIELDS}, ref["topt"].conf,
                             device="cpu")
    jsopt = dataclasses.replace(ref["jsopt"], fs=32000.0)
    tsopt = dataclasses.replace(ref["tsopt"], fs=32000.0)
    bins = _jax_bins(jsopt.noise_seed, chunk.nfrm, 161)
    out = tl0._synthesize(tsopt, chunk, bins=(bins[0][None], bins[1][None]))
    jout = jl0._synthesize_jit(jsopt, j)
    np.testing.assert_allclose(out.y_sin[0].numpy(), np.asarray(jout.y_sin),
                               atol=1e-3)
    np.testing.assert_allclose(out.y_nos[0].numpy(), np.asarray(jout.y_nos),
                               atol=1e-4)


def test_batched_pipeline_snr_matches(ref):
    nxv = np.full((len(ROWS),), ref["x"].shape[1], np.int32)
    _, jsnr, _ = jcorpus.batched_pipeline(
        ref["jopt"], ref["jsopt"], *(jnp.asarray(ref[k]) for k in ("x", "f0")),
        jnp.asarray(nxv), jnp.asarray(ref["x_ref"]))
    y, tsnr, mean = tcorpus.batched_pipeline(
        ref["topt"], ref["tsopt"], *(torch.tensor(ref[k]) for k in ("x", "f0")),
        torch.tensor(nxv), torch.tensor(ref["x_ref"]))
    assert y.shape == ref["x"].shape and bool(torch.isfinite(y).all())
    np.testing.assert_allclose(tsnr.numpy(), np.asarray(jsnr), atol=0.05)
    assert abs(float(mean) - float(np.mean(jsnr))) <= 0.05


def test_public_single_utterance_api(ref):
    """analyze / synthesize on one utterance (no batch axis) give the
    batched path's row."""
    ch = tpkg.analyze(ref["topt"], ref["x"][2], ref["f0"][2], device="cpu")
    assert ch.ampl.shape == ref["tchunk"].ampl.shape[1:]
    np.testing.assert_allclose(ch.ampl.numpy(), ref["tchunk"].ampl[2].numpy(),
                               atol=1e-6)
    out = tpkg.synthesize(ref["tsopt"], ch)
    assert out.y.shape == (ref["x"].shape[1],)
    assert bool(torch.isfinite(out.y).all())


@pytest.mark.parametrize("change", [
    dict(use_pallas=False), dict(hm_method="pp"), dict(hm_passes=2),
    dict(hm_correction="none"), dict(frame_chunk=32)])
def test_unported_options_raise(ref, change):
    """Options outside the ported slice raise, naming a ROADMAP item."""
    opt = dataclasses.replace(ref["topt"], **change)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tl0._analyze(opt, torch.tensor(ref["x"][:1]), torch.tensor(ref["f0"][:1]))


@pytest.mark.parametrize("change", [
    dict(track_denoise_spectral=False), dict(track_spectral_decimate=1),
    dict(track_lowpass_hz=30.0)])
def test_denoiser_options_match(change):
    """The denoiser's other settings (time gate only, the full-rate FFT
    gate, the opt-in track lowpass) run through _analyze and give the JAX
    Pallas branch's harmonic tracks on a noisy fixture."""
    x, f0, _ = _fixtures()
    jopt, _ = _opts(jpkg, True, **change)
    topt, _ = _opts(tpkg, True, **change)
    j = jl0._analyze_jit(jopt, jnp.asarray(x[0]), jnp.asarray(f0[0]))
    t = tl0._analyze(topt, torch.tensor(x[:1]), torch.tensor(f0[:1]))
    ja, jp = np.asarray(j.ampl), np.asarray(j.phse)
    scale = float(np.abs(ja).max())
    np.testing.assert_allclose(t.ampl[0].numpy(), ja, atol=1e-3 * scale)
    np.testing.assert_allclose(t.ampl[0].numpy() * np.exp(1j * t.phse[0].numpy()),
                               ja * np.exp(1j * jp), atol=1e-3 * scale)
