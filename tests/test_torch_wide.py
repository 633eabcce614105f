"""The configurations past the first CUDA kernels' shape limits, on the CPU
against the JAX package (its Pallas branch in interpret mode), at small
sizes from numpy seeds: analyze -> synthesize with use_pallas=True at a 2 ms
hop (the denoiser's 33 + 17 taps), at creaky voice's K = 160, at 48 kHz
with a 10 ms hop (noise hop 480) and at full band with a 2 ms hop (the
deconvolution at K = 200, D = 26); the deconvolution's twin against
deconv_full_pallas at full-band shapes; the noise kernel's twin against
noise_mod_ola_pallas at nine bands, nine envelope harmonics and hop 480;
the Viterbi twin against the JAX scans past 256 states; the envelope
render's twin past Ke = 8 and the cycle track's past a 512-sample hop
against the JAX package; and the wide kernels' launch geometry by hand
(the denoiser's K chunks, the noise kernel's frames a block and its band
table in shared memory, the deconvolution's frame tile and K chunks).
Tolerances: the chunk fields as test_torch_layer0.py holds them (ampl and
the complex track 1e-3 of the peak), y_sin 1e-3, the noise 5e-5 (1e-4
through the whole synthesis), SNR 0.05 dB, the Viterbi paths exactly.
test_torch_cuda.py holds each wide kernel against its twin on a card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import layer1 as jl1

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import (LAYER0_FIELDS, chunk_from_numpy,
                                          chunk_to_numpy)
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.ops import kernels
from libllsm2_tpu_torch.utils import testsig
from test_torch_cuda import _noise_tensors, _wide_noise_inputs
from test_torch_f0 import _jax_viterbi
from test_torch_cuda import _deconv_inputs
from test_torch_kernels import _jax_eq, _jax_noise
from test_torch_layer0 import _jax_bins
from test_torch_viterbi import LAM, _order_inputs

torch.set_num_threads(1)

SMALL = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
# name -> (ChunkConf keywords, seconds): a 2 ms hop (track_denoise_hz = 15
# gives 33 + 17 denoiser taps), creaky voice's tests/test_creaky.py conf
# (K = 160), tests/test_edgecases.py's 48 kHz conf at the 10 ms hop of its
# sweep (nhop 480)
CASES = {
    "hop 2 ms": (dict(SMALL, thop=0.002), 0.3),
    "K 160": (dict(SMALL, maxnhar=160), 0.3),
    "48 kHz 10 ms": (dict(fs=48000.0, thop=0.01, fnyq=12000.0,
                          chanfreq=(3000.0, 6000.0, 9000.0), nspec=513),
                     0.6),
    # full band at 16 kHz with a 2 ms hop: maxnhar = fs / 2 / f0_floor, the
    # deconvolution's band D = 26 (halfwin_max 800) at K = 200
    "full band": (dict(SMALL, thop=0.002, f0_floor=40.0, maxnhar=200,
                       fnyq=8000.0), 0.3),
}


def _opts(pkg, conf):
    opt = dataclasses.replace(pkg.create_aoptions(),
                              conf=pkg.ChunkConf(**conf), use_pallas=True)
    return opt, dataclasses.replace(pkg.create_soptions(fs=opt.conf.fs),
                                    use_pallas=True)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """A noisy and a clean row through both packages' analysis, the port's
    a batch of two."""
    conf, seconds = CASES[request.param]
    topt, tsopt = _opts(tpkg, conf)
    jopt, jsopt = _opts(jpkg, conf)
    fs, thop = topt.conf.fs, topt.conf.thop
    rows = testsig.make_test_utterances([(0, 0.05), (1, 0.0)],
                                        duration=seconds, fs=fs, thop=thop)
    x, f0, x_harm = (np.stack([r[j] for r in rows]).astype(np.float32)
                     for j in range(3))
    jchunks = [jl0._analyze_jit(jopt, jnp.asarray(x[i]), jnp.asarray(f0[i]))
               for i in range(2)]
    tchunk = tl0._analyze(topt, torch.tensor(x), torch.tensor(f0))
    return dict(name=request.param, x=x, f0=f0, x_harm=x_harm, topt=topt,
                tsopt=tsopt, jopt=jopt, jsopt=jsopt, jchunks=jchunks,
                tchunk=tchunk)


def test_wide_confs_reach_the_lifted_limits(case):
    """Each case is past a limit of the first kernels: the denoiser's
    taps, its K, or the noise kernel's hop."""
    conf = case["topt"].conf
    if case["name"] == "hop 2 ms":
        # _track_denoise's tap counts: round(frame rate / (1 or 2) 15 Hz) | 1
        rate, hz = 1.0 / conf.thop, case["topt"].track_denoise_hz
        M, Mp = int(round(rate / hz)) | 1, int(round(rate / (2 * hz))) | 1
        assert conf.nhop == 32 and (M, Mp) == (33, 17)
        assert M > kernels._DENOISE_MAX_TAPS
    elif case["name"] == "K 160":
        assert conf.maxnhar == 160 > kernels._DENOISE_MAX_K
    elif case["name"] == "full band":
        # layer0._deconv_correction's band and quadrature points
        D = -(-conf.halfwin_max // conf.nhop) + 1
        nq = 2 * conf.nhop // min(8, conf.nhop)
        assert (conf.maxnhar, D, nq) == (200, 26, 8)
        assert kernels._deconv_smem(D, 200, nq) == 240368 > kernels._SMEM_MAX
        assert kernels._deconv_geometry(D, 200, nq)[:3] == (64, 50, 4)
    else:
        assert conf.nhop == 480 > kernels._NOISE_MAX_HOP


@pytest.mark.parametrize("row", [0, 1])
def test_wide_analysis_matches(case, row):
    """The port's analysis chunk against the JAX package's: f0 1e-4
    relative, the mask exactly, ampl 1e-3, the complex tracks 1e-3 of
    their peaks, psd and edc 1e-3 relative above 1e-5 of their peaks (the
    residual's quiet noise channels carry the float32 rounding of a 160-
    or 48 kHz-harmonic render: ~5e-6 of the peak apart)."""
    j = case["jchunks"][row]
    t = {f: v[row] for f, v in chunk_to_numpy(case["tchunk"]).items()}
    np.testing.assert_allclose(t["f0"], np.asarray(j.f0), rtol=1e-4)
    np.testing.assert_array_equal(t["hm_mask"], np.asarray(j.hm_mask))
    ja, jp = np.asarray(j.ampl), np.asarray(j.phse)
    assert t["ampl"].shape == ja.shape
    np.testing.assert_allclose(t["ampl"], ja, atol=1e-3)
    np.testing.assert_allclose(t["ampl"] * np.exp(1j * t["phse"]),
                               ja * np.exp(1j * jp),
                               atol=1e-3 * float(np.abs(ja).max()))
    je = np.asarray(j.eenv_a)
    np.testing.assert_allclose(
        t["eenv_a"] * np.exp(1j * t["eenv_p"]),
        je * np.exp(1j * np.asarray(j.eenv_p)),
        atol=1e-3 * float(np.abs(je).max()))
    for f in ("psd", "edc"):
        jv = np.asarray(getattr(j, f))
        np.testing.assert_allclose(t[f], jv, rtol=1e-3,
                                   atol=1e-5 * float(np.abs(jv).max()))


@pytest.mark.parametrize("row", [0, 1])
def test_wide_synthesis_matches(case, row):
    """The JAX chunk carried across and synthesized by the port with the
    JAX noise bins injected: y_sin 1e-3, y_nos 1e-4, y 1e-3 of the JAX
    synthesis."""
    j = case["jchunks"][row]
    chunk = chunk_from_numpy({f: np.asarray(getattr(j, f))[None]
                              for f in LAYER0_FIELDS}, case["topt"].conf,
                             device="cpu")
    nbin = case["topt"].conf.nhop + 1
    bins = _jax_bins(case["jsopt"].noise_seed, chunk.nfrm, nbin)
    out = tl0._synthesize(case["tsopt"], chunk,
                          bins=(bins[0][None], bins[1][None]))
    jout = jl0._synthesize_jit(case["jsopt"], j)
    for name, atol in (("y_sin", 1e-3), ("y_nos", 1e-4), ("y", 1e-3)):
        np.testing.assert_allclose(getattr(out, name)[0].numpy(),
                                   np.asarray(getattr(jout, name)),
                                   atol=atol, err_msg=name)


def _snr(ref, y, fs):
    lo, hi = int(0.1 * len(ref)), int(0.9 * len(ref))
    e = ref[lo:hi] - y[lo:hi]
    return 10.0 * np.log10(np.sum(ref[lo:hi] ** 2)
                           / max(float(np.sum(e ** 2)), 1e-20))


def test_wide_round_trip_snr_matches(case):
    """analyze -> synthesize through each package alone (the port a batch
    of two on its own chunk, its own noise draw): y_sin finite, of the
    input's length, and its SNR against the clean harmonic part within
    0.05 dB of the JAX package's, row by row."""
    out = tl0._synthesize(case["tsopt"], case["tchunk"])
    fs = case["topt"].conf.fs
    assert out.y_sin.shape == case["x"].shape
    assert bool(torch.isfinite(out.y).all())
    for row in range(2):
        jy = np.asarray(jl0._synthesize_jit(case["jsopt"],
                                            case["jchunks"][row]).y_sin)
        ref = case["x_harm"][row]
        assert abs(_snr(ref, out.y_sin[row].numpy(), fs)
                   - _snr(ref, jy, fs)) <= 0.05


@pytest.mark.parametrize("nhop,C,Ke,Nf", [(480, 4, 4, 12), (80, 9, 9, 40),
                                          (480, 9, 9, 9)])
def test_noise_twin_matches_pallas_past_the_first_kernel(nhop, C, Ke, Nf):
    """noise_mod_ola (its twin on the CPU) against the JAX package's band
    iDFT and noise_mod_ola_pallas (interpret mode) at hop 480, nine bands
    and nine envelope harmonics, where the card runs the wide kernel:
    5e-5 absolute (test_pallas.py's)."""
    args, bands = _wide_noise_inputs(nhop, C, Ke, Nf, nhop + C)
    assert kernels._noise_geometry(nhop, C, Ke, bands)[0] > 0
    got = kernels.noise_mod_ola(*_noise_tensors(args), bands)
    fs = 100.0 * nhop
    edges = tuple(fs / 2 * c / C for c in range(C)) + (fs / 2 + 1.0,)
    for b in range(2):
        np.testing.assert_allclose(got[b].numpy(),
                                   _jax_noise(args, edges, fs, b), atol=5e-5)


@pytest.mark.parametrize("S", [257, 512])
@pytest.mark.parametrize("renorm", [True, False])
def test_viterbi_twin_matches_the_jax_scans_past_256_states(S, renorm):
    """viterbi_scan (its twin on the CPU) against the JAX tracker's
    renormalized scan and layer 1's _rd_viterbi on S states, scores in
    eighths with ties and -inf entries: paths equal (tolerance 0)."""
    obs, lt, score, voiced = _order_inputs(S, renorm, S + renorm, N=60)
    path = kernels.viterbi_scan(obs, lt, renorm)
    for b in range(obs.shape[0]):
        if renorm:
            ref = _jax_viterbi(jnp.asarray(obs[b].numpy()),
                               jnp.asarray(lt.numpy()))
        else:
            ref = jl1._rd_viterbi(jnp.asarray(score[b].numpy()),
                                  jnp.asarray(voiced[b].numpy()), LAM)
        np.testing.assert_array_equal(path[b].numpy(), np.asarray(ref))


def _denoise_wide_bytes(n1, n2, cw=64):
    """denoise_stats.cu's wide path's walk width and shared bytes a block:
    cw, then its first launch's cw staged columns [64 + 2 h1, cw] float2,
    vo [64 + 2 h1] and taps1; its second's r_inc [R, cw] float2 (R = 64 +
    2 h2), the fit [R, 4] and taps2."""
    SR, R = 64 + 2 * (n1 // 2), 64 + 2 * (n2 // 2)
    return cw, 8 * SR * cw + 4 * (SR + n1), 8 * R * cw + 4 * (4 * R + n2)


@pytest.mark.parametrize("K,n1,n2,geometry", [
    # the first kernel: [RA + R, K] float2 tracks, RA = 64 + 2 (h1 + h2), R
    # = 64 + 2 h2, then vo [RA] and the taps
    (80, 13, 7, (0, 0, 8 * (82 + 70) * 80 + 4 * (82 + 20), 0)),
    (128, 31, 15, (0, 0, 8 * (108 + 78) * 128 + 4 * (108 + 46), 0)),
    # the wide path: KC columns a chunk (the fit sums' chunk, as the
    # one-block kernel chose it), the columns a walk, then each launch's
    # bytes
    (160, 13, 7, (128, *_denoise_wide_bytes(13, 7))),
    (129, 13, 7, (128, *_denoise_wide_bytes(13, 7))),
    (80, 33, 17, (80, *_denoise_wide_bytes(33, 17))),
    (80, 41, 21, (80, *_denoise_wide_bytes(41, 21))),
    (160, 41, 21, (128, *_denoise_wide_bytes(41, 21))),
    # 20e: full band at 48 kHz (K 600, 13 + 7 taps: five chunks, the last
    # of 88) and at 16 kHz with a 2 ms hop (K 200, 33 + 17: 128 + 72)
    (600, 13, 7, (128, *_denoise_wide_bytes(13, 7))),
    (200, 33, 17, (128, *_denoise_wide_bytes(33, 17))),
    # h1 + 2 h2 = 100: one block's 128, 112, 96 columns overflowed 232448
    # bytes, so the sums run in chunks of 80
    (200, 101, 51, (80, *_denoise_wide_bytes(101, 51))),
    # the Pallas kernel's widest halo, h1 + 2 h2 = 510 at its 512 block:
    # 574 rows of r_inc fit 32 columns at a time, not 64
    (80, 1, 511, (16, *_denoise_wide_bytes(1, 511, 32))),
    # a one-tap probe: no frame beyond the ends reaches it
    (140, 13, 1, (128, *_denoise_wide_bytes(13, 1))),
])
def test_denoise_geometry_by_hand(K, n1, n2, geometry):
    """kernels._denoise_geometry: the first kernel up to K = 128 and 31
    taps with h1 + 2 h2 < 64; past them the wide path in chunks of the
    columns (a multiple of 16, at most 128) that the one-block kernel it
    replaced chose (its fit sums' order), so K = 160 runs in chunks of 128
    and 32, and two launches, each walking a chunk 64 columns at a time
    (32 or 16 where the halo's rows fill the H100's shared memory)."""
    assert kernels._denoise_geometry(K, n1, n2) == geometry
    assert max(geometry[2:]) <= kernels._SMEM_MAX


@pytest.mark.parametrize("N,block", [(1600, 400), (4000, 400), (150, 128),
                                     (1536, 128), (64, 64), (1000, 200)])
def test_denoise_frame_block_is_the_pallas_kernels(N, block):
    """The tap limit the port shares with the JAX package: the Pallas
    denoiser's frame block at N frames (pallas_osc.py:1176-1179)."""
    assert kernels._denoise_frame_block(N) == block


@pytest.mark.parametrize("nhop,C,Ke,bands,geometry", [
    # 16 kHz default: the first kernel, 16 frames; L = 4 bands' even slots;
    # its threads are the C entry's own (0)
    (80, 4, 4, (0, 15, 15, 30, 30, 45, 45, 81),
     (0, 16 + 16 + 16 + 38,
      8 * 16 * 86 + 8 * 16 * 4 * 80 + 24 * 80 + 4 * 16 * 8 * 5 + 4 * 86, 0,
      0)),
    # 48 kHz at 10 ms: nhop 480; 16 frames, a thread a sample pair (240
    # pairs: 256 threads), no (E, O) buffer: spectra [L / 2, 17] float4,
    # the three tables, the accumulators [15, 2, 256], the coefficients,
    # the slots' bins and the band table [5, C] ints
    (480, 4, 4, (0, 60, 60, 120, 120, 180, 180, 480),
     (16, 480, 16 * 240 * 17 + 24 * 480 + 4 * 15 * 2 * 256 + 4 * 16 * 8 * 5
      + 4 * (480 + 20), 256, 0)),
    # nine bands of 9 bins (odd ranges: slots from each band's even bin):
    # 40 pairs, 64 threads
    (80, 9, 9, (0, 9, 9, 18, 18, 27, 27, 36, 36, 45, 45, 54, 54, 63, 63, 72,
                72, 81),
     (16, 10 + 10 + 10 + 10 + 10 + 10 + 10 + 10 + 10,
      16 * 45 * 17 + 24 * 80 + 4 * 15 * 2 * 64 + 4 * 16 * 18 * 10
      + 4 * (90 + 45), 64, 0)),
    # 96 kHz at 200 ms: nhop 19200, past the wide kernel's 16-frame block;
    # the long kernel, 16 frames, 128 threads, two chunk buffers of 64
    # slots [32, 17] float4, e^{2 pi j cyc} [15, 4, 128] float2, the
    # accumulators [15, 4, 128], the coefficients and the band table [5, C]
    # ints (the tables and staged spectra in device memory)
    (19200, 4, 4, (0, 800, 800, 1600, 1600, 2400, 2400, 19201),
     (16, 800 + 800 + 800 + 16802,
      2 * 16 * 32 * 17 + 12 * 15 * 4 * 128 + 4 * 16 * 8 * 5 + 4 * 5 * 4,
      128, 64)),
])
def test_noise_geometry_by_hand(nhop, C, Ke, bands, geometry):
    """kernels._noise_geometry: (frames a block, 0 for the first kernel;
    staged slots a frame, each band's from its first even bin, an even
    count; shared bytes; threads a block; the long kernel's slots a chunk,
    0: all staged at once).  The first
    kernel's bytes: spectra [F, L] and (E, O) [F, C, nhop] float2, three
    [2 nhop] tables, coefficients [F, 2 C (Ke + 1)], the slots' bins [L];
    the wide kernel's: spectra [L / 2, F + 1] float4, tables, y
    accumulators [F - 1, 2, threads], coefficients, bins and the band
    table [5, C]."""
    assert kernels._noise_geometry(nhop, C, Ke, bands) == geometry
    assert geometry[2] <= kernels._SMEM_MAX


def _equal_bands(nhop, C):
    fs = 100.0 * nhop
    edges = tuple(fs / 2 * c / C for c in range(C)) + (fs / 2 + 1.0,)
    return kernels.band_ranges(nhop + 1, fs, edges)


# the long noise kernel's slots a chunk where test_noise_wide_geometry_fits
# expects it (by hand)
NOISE_LONG = {(480, 9, 9): 32, (882, 4, 12): 48, (960, 3, 12): 64,
              (2048, 4, 4): 64}


@pytest.mark.parametrize("nhop,C,Ke", [
    (257, 4, 4), (480, 4, 4), (480, 9, 9), (80, 9, 9), (80, 4, 9),
    (333, 5, 3), (481, 4, 4), (882, 4, 12), (960, 3, 12), (2048, 4, 4)])
def test_noise_wide_geometry_fits(nhop, C, Ke):
    """The launch past the first kernel's limits: the wide kernel (16
    frames) where its block leaves room for two an SM, a warp multiple of
    threads, at most 256, one a sample pair (half = ceil(nhop / 2)) up to
    256, its shared bytes as counted by hand; elsewhere (NOISE_LONG: hop
    480 with 9 bands of 9 harmonics, 882 and longer) the long kernel, 16
    frames, 128 threads, chunks of 64 slots, or of 32 / 48 where the
    coefficients take the room of two blocks an SM at 64, its bytes by
    hand; each within the H100's 227 KB a block, two blocks an SM."""
    bands = _equal_bands(nhop, C)
    F, L, nbytes, threads, chunk = kernels._noise_geometry(nhop, C, Ke,
                                                            bands)
    half = (nhop + 1) // 2
    if (nhop, C, Ke) not in NOISE_LONG:
        assert (F, chunk) == (16, 0)
        assert threads % 32 == 0 and min(half, 256) <= threads <= 256
        assert nbytes == (8 * 17 * L + 24 * nhop + 8 * 15 * threads
                          + 8 * 16 * C * (Ke + 1) + 4 * (L + 5 * C))
    else:
        assert (F, chunk, threads) == (16, NOISE_LONG[nhop, C, Ke], 128)
        assert nbytes == (16 * chunk * 17 + 12 * 15 * 4 * 128
                          + 8 * 16 * C * (Ke + 1) + 20 * C)
    assert nbytes <= kernels._SMEM_MAX
    assert 2 * (nbytes + 1024) <= 233472


def test_noise_geometry_gives_20b_two_blocks_an_sm():
    """At chip_smoke.py's phase 20b (48 kHz at a 10 ms hop, its channel
    edges) the wide kernel runs 16 frames a block (15 hops, not the
    parent's 7 of 8) and two blocks fit an SM's 228 KB."""
    bands = kernels.band_ranges(481, 48000.0,
                                (0.0, 3000.0, 6000.0, 9000.0, 24000.0))
    assert bands == (0, 60, 60, 120, 120, 180, 180, 480)
    F, L, nbytes, threads, chunk = kernels._noise_geometry(480, 4, 4, bands)
    assert (F, L, threads, chunk) == (16, 480, 256, 0)
    assert 2 * (nbytes + 1024) <= 233472


def _apply_warp_bytes(K):
    """The wide denoise_apply's buffer a warp: 5 planes of two rows
    row_floats(K) apart (K + 3 rounded up to 16 modulo 32, so the two half
    warps' rows start 16 banks apart), then v and wmul of each half warp's
    utterance (odd16(K) floats each)."""
    odd16 = lambda n: (n + 15) // 32 * 32 + 16
    return 4 * (2 * 5 * odd16(K + 3) + 4 * odd16(K))


@pytest.mark.parametrize("K,rows,geometry", [
    # the first kernel up to K = 128
    (80, 204800, (0, 0, 0, 0, 0)),
    (128, 7, (0, 0, 0, 0, 0)),
    # 20e 48 kHz: rows 624 floats apart; six one-warp blocks an SM
    (600, 204800, (1, 788, 130, 1, 4 * (10 * 624 + 4 * 624))),
    # 20e 16 kHz at 2 ms and 20a creaky voice: sixteen blocks an SM
    (200, 512000, (1, 2099, 122, 1, 4 * (10 * 208 + 4 * 208))),
    (160, 204800, (1, 2090, 49, 1, 4 * (10 * 176 + 4 * 176))),
    # a row alone at 48 kHz: 800 pairs, two a warp
    (600, 1600, (1, 400, 2, 1, _apply_warp_bytes(600))),
    (129, 602, (1, 301, 1, 1, _apply_warp_bytes(129))),
    (1500, 204800, (1, 264, 388, 1, _apply_warp_bytes(1500))),
    # past one warp's buffer in a block: no staging, four warps a block
    (5000, 10, (4, 2, 1, 0, 0)),
])
def test_apply_geometry_by_hand(K, rows, geometry):
    """kernels._apply_geometry: (warps a block, 0 for the first kernel;
    blocks; row pairs a warp; stage; shared bytes) on a 132-SM H100."""
    assert kernels._apply_geometry(K, rows, 132) == geometry


@pytest.mark.parametrize("K", [129, 160, 203, 600, 2000, 5000])
@pytest.mark.parametrize("rows", [1, 301, 204800, 512000])
def test_apply_geometry_covers_every_pair(K, rows):
    """Every row pair of the wide denoise_apply falls to exactly one warp
    (blocks x warps x pairs a warp covers them and no block is idle), the
    blocks fit the card at once (shared memory, at most 16 an SM) and the
    shared bytes are the warp's buffer and within 227 KB a block."""
    W, blocks, per, stage, nbytes = kernels._apply_geometry(K, rows, 132)
    pairs = (rows + 1) // 2
    assert W in (1, 4) and blocks >= 1 and per >= 1
    assert blocks * W * per >= pairs > (blocks - 1) * W * per
    assert nbytes == stage * W * _apply_warp_bytes(K)
    assert nbytes <= kernels._SMEM_MAX
    per_sm = min(16, 233472 // (nbytes + 1024))
    assert blocks <= 132 * per_sm


@pytest.mark.parametrize("C,Ke,nhop", [(4, 9, 80), (3, 12, 480), (1, 9, 80),
                                        (9, 9, 80), (4, 16, 80),
                                        (2, 24, 160)])
def test_env_render_twin_matches_pallas_past_8_harmonics(C, Ke, nhop):
    """env_render (its twin on the CPU) against env_render_pallas
    (interpret mode) past Ke = 8, where the card runs the wide kernel: Ke 9
    and 12 (chip_smoke.py's 20f), one channel and nine (a group of 8 and
    one), 16 and 24 harmonics (four and six ladder chunks): env 2e-5, base
    2e-6 (test_pallas.py:231)."""
    from libllsm2_tpu.ops import pallas_osc
    rng = np.random.default_rng(Ke)
    nfrm = 24
    cyc = (np.cumsum(rng.uniform(0.0, 0.02, nfrm * nhop)) % 1.0).astype(
        np.float32)
    edc = rng.uniform(0, 1, (nfrm, C)).astype(np.float32)
    ar = rng.uniform(-0.15, 0.15, (nfrm, C, Ke)).astype(np.float32)
    ai = rng.uniform(-0.15, 0.15, (nfrm, C, Ke)).astype(np.float32)
    base = rng.uniform(0.5, 1.5, (nfrm, C)).astype(np.float32)
    env, bs = kernels.env_render(*(torch.tensor(a)[None] for a in
                                   (cyc, edc, ar, ai, base)))
    jenv, jbs = pallas_osc.env_render_pallas(*map(jnp.asarray,
                                                  (cyc, edc, ar, ai, base)))
    np.testing.assert_allclose(env[0].numpy(), np.asarray(jenv), atol=2e-5)
    np.testing.assert_allclose(bs[0].numpy(), np.asarray(jbs), atol=2e-6)


@pytest.mark.parametrize("nhop", [960, 2048])
def test_cycle_track_twin_matches_jax_past_a_512_sample_hop(nhop):
    """sample_cycles (its twin on the CPU) against the JAX package's at
    hops 960 (48 kHz at 20 ms) and 2048, where the card runs its long-hop
    kernel (64 or 128 lanes a hop, runs of up to 16 samples): within 1e-5
    cycles mod 1."""
    import jax
    from libllsm2_tpu.ops import harmonics as jhm
    fs, n = 100.0 * nhop, 60
    f0 = testsig.make_f0_track(n, 0.01, unvoiced_tail_frac=0.1).astype(
        np.float32)
    got = kernels.sample_cycles(torch.tensor(f0)[None], nhop, fs,
                                n * nhop)[0].numpy().astype(np.float64)
    ref = np.asarray(jax.jit(jhm.sample_cycles, static_argnums=(1, 2, 3))(
        jnp.asarray(f0), nhop, fs, n * nhop)).astype(np.float64)
    d = got - ref
    assert float(np.abs(d - np.round(d)).max()) <= 1e-5


@pytest.mark.parametrize("K,D,nhop", [(600, 11, 240), (342, 16, 96)])
def test_deconv_twin_matches_pallas_at_full_band(K, D, nhop):
    """deconv_full (its twin on the CPU) against deconv_full_pallas
    (interpret mode) at full-band shapes the card's first kernel refuses:
    K = 600, D = 11, nq = 60 (48 kHz, 5 ms hop, f0_floor 40) and K = 342,
    D = 16, nq = 24 (48 kHz, 2 ms hop, f0_floor 70), halfwidths up to the
    band's (D - 1) nhop, over a few frames: 5e-4 (test_pallas.py's)."""
    from libllsm2_tpu.ops import pallas_osc
    stride, Nf = 8, 2 * D + 3
    nq = 2 * nhop // stride
    assert kernels._deconv_smem(D, K, nq) > kernels._SMEM_MAX
    ampl, phse, cyc, hw, mask = _deconv_inputs(nhop, K + D, B=1, Nf=Nf, K=K)
    hw = np.random.default_rng(D).uniform(30, (D - 1) * nhop, hw.shape)
    hw = hw.astype(np.float32)
    got = kernels.deconv_full(*map(torch.tensor, (ampl, phse, cyc, hw, mask)),
                              D, nhop, stride)
    rj, ij = pallas_osc.deconv_full_pallas(
        *(jnp.asarray(a[0]) for a in (ampl, phse)),
        jnp.asarray(cyc[0, ::nhop]), jnp.asarray(hw[0]),
        *_jax_eq(cyc[0], Nf, nhop, stride), D, nhop, stride)
    zj = (np.asarray(rj) + 1j * np.asarray(ij)) * mask[0]
    np.testing.assert_allclose(got[0][0].numpy() + 1j * got[1][0].numpy(),
                               zj, atol=5e-4)


def _deconv_bytes(FT, D, KC):
    """deconv_full.cu's wide output block: the taps of FT frames, the chunk
    of KC columns with a halo column each side (and two unread, for the
    float4 loads) of FT + 2 D halo rows, and a float a halo row."""
    FH = FT + 2 * D
    return FT * (2 * D + 1) * 16 + FH * (KC + 4) * 8 + FH * 4


@pytest.mark.parametrize("D,K,nq,geometry", [
    # the first kernel where its 64-frame block fits
    (7, 80, 20, (64, 0, 1, 64 * 15 * 16 + 78 * 80 * 8 + 98 * 4, 0, 0)),
    (56, 80, 20, (64, 0, 1, 229136, 0, 0)),
    (11, 160, 20, (64, 0, 1, 134056, 0, 0)),
    # 48 kHz full band: 10 chunks of 60 (64 fit), three blocks an SM
    (11, 600, 60, (64, 60, 10, _deconv_bytes(64, 11, 60), 64, 1)),
    (11, 551, 55, (64, 62, 9, _deconv_bytes(64, 11, 62), 64, 1)),
    (16, 342, 24, (64, 58, 6, _deconv_bytes(64, 16, 58), 64, 1)),
    # 16 kHz at a 2 ms hop: 60 columns leave two blocks an SM, so 4 chunks
    # of 50
    (26, 200, 8, (64, 50, 4, _deconv_bytes(64, 26, 50), 64, 1)),
    # an odd K: the chunk rounded up to even
    (26, 201, 8, (64, 52, 4, _deconv_bytes(64, 26, 52), 64, 1)),
    # D past 56 at K = 80: 64 frames' taps leave no room for 16 columns in
    # half the SM, 32 frames do: two chunks of 40
    (57, 80, 20, (32, 40, 2, _deconv_bytes(32, 57, 40), 64, 1)),
    # the taps of 32 frames fill half the SM past D = 113: 16-frame tiles
    (113, 80, 20, (16, 20, 4, _deconv_bytes(16, 113, 20), 32, 1)),
    (128, 80, 20, (16, 16, 5, _deconv_bytes(16, 128, 16), 32, 1)),
    (128, 600, 120, (16, 18, 34, _deconv_bytes(16, 128, 18), 32, 0)),
    # one harmonic
    (128, 1, 120, (16, 2, 1, _deconv_bytes(16, 128, 2), 32, 0)),
    # nothing fits far past the JAX branch's D <= 128
    (1000, 80, 20, None),
])
def test_deconv_geometry_by_hand(D, K, nq, geometry):
    """kernels._deconv_geometry: the first kernel where its 64-frame block
    fits the H100's shared memory; past it the wide path's output kernel
    at the frame tile (64, 32, 16, 8) whose block leaves room for two an SM
    with a chunk of min(K, 16) columns or more, the widest even chunk of
    at most 64 evened out over K; its tap build at the widest tile whose
    taps fit a block, the quadrature field staged beside them where it
    fits too (past D = 113 at nq 20 the taps of 64 frames alone fill a
    block; at nq 120 the field of 32 frames and a 256-frame halo does not
    fit beside their taps); a refusal only where nothing fits."""
    assert kernels._deconv_geometry(D, K, nq) == geometry
    if geometry is not None:
        assert geometry[3] <= kernels._SMEM_MAX
        if geometry[1]:
            FT, KC, n, _, TT, stage = geometry
            assert n * KC >= K > (n - 1) * KC and KC % 2 == 0 and KC <= 64
            nb = 2 * D + 1
            taps = TT * nb * 16 + nq * 4 \
                + stage * (TT + 2 * D) * (nq + 1) * 8
            assert taps <= kernels._SMEM_MAX
            assert TT == 64 or (2 * TT) * nb * 16 + nq * 4 \
                > kernels._SMEM_MAX
            assert stage or taps + (TT + 2 * D) * (nq + 1) * 8 \
                > kernels._SMEM_MAX


@pytest.mark.parametrize("return_complex", [True, False])
def test_chip_smoke_counts_deconv_full_by_hand(return_complex):
    """chip_smoke.kernel_ops for deconv_full at [2, 5, 3], D 2, hop 8,
    stride 4 (5 taps, 4 quadrature points): a slot's 5 taps of 6 FMAs (12
    a tap), its 4 adds of c_{k+1} +- c_{k-1}, the alignment and
    un-alignment (40) and the mask (2), 30 more for the polar track; a
    frame's taps (10 a tap a point) and field (20 a point)."""
    import chip_smoke
    ampl, cyc, hw = torch.zeros(2, 5, 3), torch.zeros(2, 40), torch.ones(2, 5)
    slot = 12 * 5 + 4 + 40 + 2 + (0 if return_complex else 30)
    assert chip_smoke.kernel_ops(
        torch, "deconv_full", (ampl, ampl, cyc, hw, ampl, 2, 8, 4),
        {"return_complex": return_complex}) \
        == 2 * 5 * (3 * slot + 4 * (10 * 5 + 20))


@pytest.mark.parametrize("thop,fs,seconds,grouped", [
    (0.005, 16000.0, 8.0, False),    # phase 5: 512 points, 1600 frames
    (0.005, 11000.0, 8.0, False),    # phase 7
    (0.002, 16000.0, 8.0, True),     # 20e: 128 points but 4000 frames
    (0.005, 48000.0, 8.0, True),     # 20e: 1024 points
    (0.005, 16000.0, 10.0, True),    # 2000 frames
])
def test_warped_psd_row_groups(monkeypatch, thop, fs, seconds, grouped):
    """layer0._warped_psd with rows: row groups (layer0._row_groups) past
    a 512-point periodogram or past 1600 frames, one call otherwise (the
    card gave a row alone other PSD bits than its row in a batch at 16 kHz
    with a 2 ms hop's 4000 frames); grouped or not, the same values on the
    CPU."""
    conf = tpkg.ChunkConf(fs=fs, thop=thop)
    N = int(round(seconds / thop))
    x = torch.tensor(np.random.default_rng(N).standard_normal(
        (2, N * conf.nhop)).astype(np.float32))
    calls = []
    groups = tl0._row_groups
    monkeypatch.setattr(tl0, "_row_groups", lambda *a: calls.append(1)
                        or groups(*a))
    got = tl0._warped_psd(x, N, conf, rows=tl0._group_rows(N))
    assert bool(calls) == grouped
    np.testing.assert_allclose(got.numpy(), tl0._warped_psd(x, N, conf)
                               .numpy(), rtol=1e-5, atol=1e-12)
