"""Long hops on the CPU: the port's analysis and synthesis with the kernels
on (their plain twins here) against the JAX package (its Pallas branch in
interpret mode) at hops where the card runs the projection's smaller
tiles, the cycle track's hop kernel (past 2048 samples) or the noise's
long kernel: 48 kHz and 44.1 kHz at 50 ms (hops 2400 and 2205, odd), 96
kHz at 20 ms and 16 kHz at 120 ms (1920), at verification widths on 2 s
of a noisy row; then every geometry helper of the analysis and synthesis
path over rates 8-96 kHz and hops 5-200 ms: each launch within the
H100's 232448 bytes of shared memory a block; the noise routed to its
long kernel wherever the wide kernel's 16-frame block would not leave
room for two an SM (from hop 520 on the grid), its launch by hand.  test_torch_cuda.py runs the kernels
themselves on a card at these hops (LONG_HOP_GRID)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import Chunk
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.ops import harmonics as thm
from libllsm2_tpu_torch.ops import kernels
from test_torch_cuda import LONG_HOP_GRID
from test_torch_layer0 import _jax_bins
from test_torch_methods import CONF, FIELDS, _close

torch.set_num_threads(1)

# (fs, thop): hops 2400, 2205 (odd), 1920 and 1920
LONG_HOPS = ((48000.0, 0.05), (44100.0, 0.05), (96000.0, 0.02),
             (16000.0, 0.12))
SMEM_BLOCK = 232448          # the H100's shared memory a block, opted in


def _opts(pkg, conf, **change):
    opt = dataclasses.replace(pkg.create_aoptions(),
                              conf=pkg.ChunkConf(**conf), use_pallas=True)
    return opt, dataclasses.replace(pkg.create_soptions(fs=opt.conf.fs),
                                    use_pallas=True, **change)


@pytest.fixture(scope="module", params=LONG_HOPS,
                ids=lambda p: f"{p[0] / 1000:g}kHz-{p[1] * 1000:g}ms")
def hop(request):
    """A 2 s noisy row through both packages' analysis, the kernels on."""
    fs, thop = request.param
    conf = dict(CONF, fs=fs, thop=thop)
    x, f0 = jts.make_test_utterance(duration=2.0, fs=fs, thop=thop, seed=3,
                                    noise_level=0.05)
    x, f0 = x.astype(np.float32), f0.astype(np.float32)
    j = jl0._analyze_jit(_opts(jpkg, conf)[0], jnp.asarray(x),
                         jnp.asarray(f0))
    kernels.reset_launches()
    t = tl0._analyze(_opts(tpkg, conf)[0], torch.tensor(x)[None],
                     torch.tensor(f0)[None])
    return dict(conf=conf, j=j, t=t, launches=dict(kernels.LAUNCHES))


def test_long_hop_analysis_matches_jax(hop):
    """_analyze with the kernels on at the hop against the JAX package's
    _analyze_jit (Pallas in interpret mode): every field within 1e-3 of
    its largest value (_close; up to 7.7e-5 measured, at 16 kHz / 120
    ms), nothing launched on the CPU."""
    assert hop["t"].conf.nhop == round(hop["conf"]["fs"]
                                       * hop["conf"]["thop"])
    assert all(v == 0 for v in hop["launches"].values())
    _close(hop["t"], hop["j"], 1e-3)


@pytest.mark.parametrize("idft", ["matmul", "fft"])
def test_long_hop_synthesis_matches_jax(hop, idft):
    """_synthesize with the kernels on, of the JAX chunk carried across
    with the JAX noise bins, against the JAX package's _synthesize_jit at
    both noise_idft values.  The JAX package's float32 cycle track drifts
    from the port's float64 sums with the hop: 6.7e-6, 4.3e-6, 3.3e-6 and
    5.7e-6 cycles at 48 kHz / 50 ms, 44.1 kHz / 50 ms, 96 kHz / 20 ms and
    16 kHz / 120 ms over the 2 s row (1.7e-6 at 48 kHz / 20 ms), which
    moves y_sin by up to 1.4e-4 of its peak (5.7e-5, 5.4e-5, 1.8e-5,
    1.4e-4) and y_nos, through the envelope's phase, by up to 1.8e-4 of
    its rms (1.4e-4, 6.5e-5, 1.7e-4, 1.8e-4): y_sin within 3e-4 of its
    peak, y_nos within 3e-4 of its rms."""
    conf = hop["conf"]
    j = hop["j"]
    tch = Chunk(conf=tpkg.ChunkConf(**conf), **{
        f: torch.tensor(np.asarray(getattr(j, f)))[None] for f in FIELDS})
    jsopt = _opts(jpkg, conf, noise_idft=idft)[1]
    tsopt = _opts(tpkg, conf, noise_idft=idft)[1]
    jr = jl0._synthesize_jit(jsopt, j)
    bins = _jax_bins(jsopt.noise_seed, tch.nfrm, tch.conf.nhop + 1)
    kernels.reset_launches()
    tr = tl0._synthesize(tsopt, tch, bins=(torch.tensor(bins[0])[None],
                                           torch.tensor(bins[1])[None]))
    assert all(v == 0 for v in kernels.LAUNCHES.values())
    ys, yn = np.asarray(jr.y_sin), np.asarray(jr.y_nos)
    assert tr.y_sin.shape[-1] == len(ys) == tch.nfrm * tch.conf.nhop
    np.testing.assert_allclose(tr.y_sin[0].numpy(), ys,
                               atol=3e-4 * np.abs(ys).max())
    np.testing.assert_allclose(tr.y_nos[0].numpy(), yn,
                               atol=3e-4 * np.sqrt(np.mean(yn ** 2)))


def _grid():
    """(fs, thop) over 8, 16, 22.05, 32, 44.1, 48 and 96 kHz and every 5
    ms from 5 to 200 ms, and LONG_HOP_GRID."""
    return sorted({(fs, t / 1000.0)
                   for fs in (8000.0, 16000.0, 22050.0, 32000.0, 44100.0,
                              48000.0, 96000.0)
                   for t in range(5, 205, 5)} | set(LONG_HOP_GRID))


def _launches(fs, thop):
    """Each kernel launch of analyze -> synthesize at the default ChunkConf
    of (fs, thop) (create_aoptions: a rate with a fractional hop moves to
    the nearest integral one) on an 8 s row -> {name: shared bytes}, from
    the wrappers' own geometry helpers."""
    conf = tpkg.create_aoptions(fs=fs, thop=thop).conf
    nhop, H, K = conf.nhop, conf.halfwin_max, conf.maxnhar
    nx = int(8.0 * conf.fs) // nhop * nhop
    out = {}
    # the projection: the main pass and the envelope pass (at the envelope
    # decimation's rate); a window outside the cosine series on frame
    # buffers through harmonic_project
    D = tl0._env_decimation(conf, 4, nx)
    for name, hop, h, k in (("main", nhop, H, K),
                            ("envelope", nhop // D, -(-H // D), 4)):
        C = -(-h // hop) * hop
        F, Q, nbytes = kernels._proj_win_geometry(hop, C, k)
        assert F in (kernels._PROJ_TILE, 0)
        out[f"harmonic_project_win {name}"] = nbytes + kernels._PROJ_STATIC
    C = -(-H // nhop) * nhop
    out["harmonic_project"] = (kernels._project_geometry(2 * C, K)[1]
                               + kernels._PROJECT_STATIC)
    # the noise: its bands' bins at the hop's rate
    bands = kernels.band_ranges(nhop + 1, conf.fs, tuple(conf.chan_edges))
    geo = kernels._noise_geometry(nhop, conf.nchannel, conf.maxnhar_e, bands)
    assert geo is not None
    out["noise_mod_ola"] = geo[2]
    if geo[4]:
        # the long kernel: its prep's band table, and room for the two
        # blocks an SM its launch bounds are built for
        out["noise_mod_ola prep"] = 4 * 4 * conf.nchannel
        assert 2 * (geo[2] + 1024) <= 233472
    # the refine, decimated or at the full rate (odd hops)
    Dr, taps, _, _ = thm.refine_decimation(nhop, nx, conf.fs, conf.f0_ceil)
    dm = kernels._refine_full_dims(nhop, conf.fs, H) if Dr == 1 else \
        kernels._refine_dims(nx, Dr, nhop, conf.fs, H)
    out["refine"] = kernels._refine_geometry(128, nx // nhop, Dr,
                                             len(taps or ()), dm)["smem"]
    # the deconvolution: its first kernel, else its wide path's two
    Dd = -(-H // nhop) + 1
    nq = 2 * nhop // max(min(8, nhop), 1)
    first = kernels._deconv_smem(Dd, K, nq)
    if first <= kernels._SMEM_MAX:
        out["deconv_full"] = first
    else:
        geo = kernels._deconv_geometry(Dd, K, nq)
        assert geo is not None
        out["deconv_full output"] = geo[3]
        out["deconv_full taps"] = kernels._deconv_taps_tile(Dd, nq)[2]
    # the denoiser's taps at the frame rate
    rate = 1.0 / conf.thop
    M, Mp = int(round(rate / 15.0)) | 1, int(round(rate / 30.0)) | 1
    for i, b in enumerate(kernels._denoise_geometry(K, M, Mp)[2:]):
        out[f"denoise_stats {i}"] = b
    return out


def test_every_geometry_fits_a_block_at_every_hop():
    """Every geometry helper of the analysis and synthesis path (the
    projection's tiles and column chunks, harmonic_project's chunks, the
    noise kernels, the refines, the deconvolution, the denoiser) returns a
    launch within 232448 bytes of shared memory a block at every rate and
    hop of _grid (280 configurations and LONG_HOP_GRID): no hop the JAX
    package takes is refused for shared memory on the card; where the
    noise runs its long kernel, its block leaves room for two an SM."""
    over = {}
    for fs, thop in _grid():
        for name, nbytes in _launches(fs, thop).items():
            if nbytes > SMEM_BLOCK:
                over[(fs, thop, name)] = nbytes
    assert not over, over


@pytest.mark.parametrize("fs,thop,f0_floor,F", [
    (16000.0, 0.005, 40.0, 16), (48000.0, 0.01, 70.0, 16),
    (48000.0, 0.01, 40.0, 16), (48000.0, 0.02, 70.0, 0),
    (48000.0, 0.02, 40.0, 0), (48000.0, 0.05, 70.0, 0),
    (96000.0, 0.0125, 40.0, 0), (16000.0, 0.25, 40.0, 0),
    (96000.0, 0.2, 40.0, 0)])
def test_projection_tile_by_hop(fs, thop, f0_floor, F):
    """_proj_win_geometry at the main pass's C (hh whole hops of the
    window's reach), by hand: the 16-frame tile where its span's 8 (15 nhop
    + 2 C) bytes and the frame records leave room for two blocks an SM
    (phase 5's 16 kHz, 20b's 48 kHz at 10 ms: 96000 bytes at f0_floor 40);
    elsewhere the warp kernel, a warp a frame and two a block, staging its
    live columns in chunks of 1792 (two buffers of x and cyc: 57344 bytes a
    block, four blocks an SM, as its registers allow; 512 at K 4, the
    envelope pass's): 20g (hop 960, C 1920 at
    f0_floor 70: 145920 bytes, one block an SM), 48 kHz at 20 ms with
    f0_floor 40 (C 2880), 20h (hop 2400), 96 kHz at 12.5 ms (C 4800: 220800
    bytes, one block), 16 kHz at 250 ms and 96 kHz at 200 ms, whose frame
    alone (2 C = 38400 columns) is past a block's shared memory."""
    conf = tpkg.create_aoptions(fs=fs, thop=thop, f0_floor=f0_floor).conf
    C = -(-conf.halfwin_max // conf.nhop) * conf.nhop
    span = 8 * (15 * conf.nhop + 2 * C)
    geo = kernels._proj_win_geometry(conf.nhop, C, conf.maxnhar)
    assert geo == ((16, 0, span) if F else (0, 1792, 2 * 16 * 1792))
    assert 4 * (2 * 16 * 1792 + 1024) <= 233472
    assert kernels._proj_win_geometry(conf.nhop, C, 4)[1:] == (
        (0, span) if F else (512, 2 * 16 * 512))
    assert (2 * (span + 256 + 1024) <= 233472) == (F == 16)
    if (fs, thop, f0_floor) == (48000.0, 0.02, 70.0):
        assert (conf.nhop, C, span) == (960, 1920, 145920)


@pytest.mark.parametrize("span,chunked", [(1, False), (5487, False),
                                          (6144, False), (6145, True),
                                          (9601, True)])
def test_project_layout_by_live_span(span, chunked):
    """harmonic_project's row kernel (K > 8) at 96 kHz / 200 ms (W = 2 C =
    38400 columns), by hand: its block stages S = 6144 columns (49152
    bytes, beside the 1280 of a pass's block sums: four blocks an SM), so
    a frame whose live span fits -- every F0 of 70 Hz or more, 2
    ceil(2 fs / F0) + 1 = 5487 columns -- is staged once, and a longer one
    (to 9601 at f0_floor 40) streams through two buffers of S / 2 = 3072
    columns, a multiple of the block's 128 threads; a pass walks the
    columns for five groups of 8 harmonics on such a row (past 2048
    columns) and for two on a short row (631 columns: a whole row staged,
    eight blocks an SM); K <= 8 stages nothing."""
    conf = tpkg.create_aoptions(fs=96000.0, thop=0.2).conf
    W = 2 * (-(-conf.halfwin_max // conf.nhop) * conf.nhop)
    assert W == 38400 and 2 * conf.halfwin_max + 1 == 9601
    S, nbytes, G = kernels._project_geometry(W, 80)
    assert (S, nbytes, G) == (6144, 49152, 5)
    assert 4 * (nbytes + kernels._PROJECT_STATIC + 1024) <= 233472
    assert (span > S) == chunked and (S // 2) % 128 == 0
    assert 2 * int(np.ceil(2 * 96000.0 / 70.0)) + 1 == 5487
    assert kernels._project_geometry(W, 8) == (0, 0, 0)
    assert kernels._project_geometry(631, 80) == (631, 8 * 631, 2)
    assert kernels._project_geometry(2048, 80)[2] == 2
    assert kernels._project_geometry(2049, 80)[2] == 5


# hops whose noise runs the long kernel at the default ChunkConf: 44.1 kHz
# / 20 ms, 48 kHz / 20, 30, 40 and 50 ms, 96 kHz / 20 ms, 16 kHz / 120 and
# 250 ms, 96 kHz / 200 ms
LONG_NOISE_HOPS = {(44100.0, 0.02): 882, (48000.0, 0.02): 960,
                   (48000.0, 0.03): 1440, (48000.0, 0.04): 1920,
                   (96000.0, 0.02): 1920, (16000.0, 0.12): 1920,
                   (48000.0, 0.05): 2400, (16000.0, 0.25): 4000,
                   (96000.0, 0.2): 19200}


def test_noise_routes_the_long_kernel_wherever_the_wide_block_is_short():
    """_noise_geometry over _grid (rates 8-96 kHz, hops 5-200 ms and
    LONG_HOP_GRID) at the default ChunkConf (4 bands, 4 envelope
    harmonics): the first kernel (F 0) to hop 256 (240 on the grid); the
    wide kernel at 16 frames a block (slots a chunk 0) to hop 480, whose
    block leaves room for two an SM (20b); the long kernel (16 frames,
    chunks of 64 slots, 128 threads) from the grid's next hop, 520, on,
    where the wide kernel's block (its spectra [L / 2, 17] float4 grow
    with the hop) would not, among them hops 882, 960, 1440, 1920, 2400,
    4000 and 19200."""
    seen = set()
    for fs, thop in sorted(set(_grid()) | set(LONG_NOISE_HOPS)):
        conf = tpkg.create_aoptions(fs=fs, thop=thop).conf
        nhop, C, Ke = conf.nhop, conf.nchannel, conf.maxnhar_e
        bands = kernels.band_ranges(nhop + 1, conf.fs,
                                    tuple(conf.chan_edges))
        F, L, nbytes, threads, chunk = kernels._noise_geometry(nhop, C, Ke,
                                                                bands)
        assert (C, Ke) == (4, 4)
        if nhop <= 256:
            assert (F, threads, chunk) == (0, 0, 0), (fs, thop)
        elif nhop <= 480:
            assert (F, chunk) == (16, 0) and threads > 0, (fs, thop)
        else:
            assert (F, threads, chunk) == (16, 128, 64), (fs, thop)
            seen.add(nhop)
        if (fs, thop) in LONG_NOISE_HOPS:
            assert nhop == LONG_NOISE_HOPS[fs, thop] and chunk > 0
    assert {882, 960, 1440, 1920, 2400, 4000, 19200} <= seen


@pytest.mark.parametrize("fs,thop", sorted(LONG_NOISE_HOPS))
def test_long_noise_geometry_by_hand(fs, thop):
    """The long kernel's launch at each hop of LONG_NOISE_HOPS (default
    ChunkConf: 4 bands, 4 envelope harmonics): 16 frames, 128 threads,
    chunks of 64 slots; shared bytes two chunk buffers [32, 17] float4,
    e^{2 pi j cyc} [15, 4, 128] float2, the accumulators [15, 4, 128], the
    coefficients [16, 2 C (Ke + 1)] and the band table [5, C] ints; two
    blocks an SM; L the bands' slots from each band's even bin; its device
    scratch the tables [3, 2 nhop] (16-byte aligned) and the staged
    spectra [B, N, L / 2] float4."""
    conf = tpkg.create_aoptions(fs=fs, thop=thop).conf
    nhop, C, Ke = conf.nhop, conf.nchannel, conf.maxnhar_e
    assert (C, Ke) == (4, 4)
    bands = kernels.band_ranges(nhop + 1, conf.fs, tuple(conf.chan_edges))
    L = sum((hi - (lo & ~1) + 1) & ~1 if hi > lo else 0
            for lo, hi in zip(bands[::2], bands[1::2]))
    nbytes = 2 * 32 * 17 * 16 + 15 * 4 * 128 * 12 + 4 * 16 * 8 * 5 + 80
    assert kernels._noise_geometry(nhop, C, Ke, bands) == (16, L, nbytes,
                                                           128, 64)
    assert 2 * (nbytes + 1024) <= 233472
    assert kernels._noise_long_floats(128, 160, nhop, L) == (
        -(-6 * nhop // 4) * 4 + 128 * 160 * L // 2 * 4)
