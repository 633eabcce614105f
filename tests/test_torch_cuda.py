"""On a CUDA card only: each of the port's hand-written kernels against its
plain PyTorch twin on the card, and its launch counted.  Elsewhere every
test here skips.  The file imports neither jax nor the JAX package (the
card's machine has neither), and holds the random-input generators that
the CPU parity tests share with it.  Run on the card without the
repository's jax-importing conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m requires_cuda
"""
import numpy as np
import pytest
import torch

from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.ops import kernels

T = lambda a: torch.tensor(np.asarray(a))
# (fs, thop): hops the JAX package takes (thop fs integral) that the card
# ran only in part before harmonic_project_win's smaller tiles and column
# chunks, the cycle track's hop kernels and the chunked noise kernel: 20 ms
# at 48 kHz (the last that fit), 35 ms (the 16-frame tile's span past
# shared memory), 44.1 kHz at 40 / 50 ms (odd hop 2205), 48 kHz at 50 / 100
# ms, 96 kHz at 12.5 / 15 / 20 / 200 ms, 16 kHz at 120 / 250 ms
LONG_HOP_GRID = ((48000.0, 0.02), (48000.0, 0.035), (44100.0, 0.04),
                 (44100.0, 0.05), (48000.0, 0.05), (96000.0, 0.0125),
                 (96000.0, 0.015), (96000.0, 0.02), (16000.0, 0.12),
                 (16000.0, 0.25), (48000.0, 0.1), (96000.0, 0.2))


N = 300   # ragged: three 128-frame blocks of the TPU kernels, the last partial
# the default path's denoiser taps: 15 Hz split at a 5 ms hop -> M = 13, Mp = 7
TAPS1, TAPS2 = tuple(tl0._hann_taps(13)), tuple(tl0._hann_taps(7))
STATS_NAMES = ("pp", "cs2", "r2", "guard", "cre", "cim", "csr", "csi")


def _win_inputs(nhop, W, seed, B=2, Nf=N // 2):
    """B utterances for harmonic_project_win at hop nhop and frame width W
    (center C = W // 2): x [B, Nf*nhop], the mod-1 cycle track of an F0
    that differs by row (so frames mixing utterances show), halfwidths
    [B, Nf] in [2, C - 1] and their live columns lo, hi -> (x, cyc, hw, lo,
    hi, C)."""
    rng = np.random.default_rng(seed)
    C = W // 2
    nx = Nf * nhop
    f0 = 100.0 + 70.0 * np.arange(B)[:, None] \
        + 20.0 * np.sin(np.arange(nx)[None, :] / (40.0 * nhop))
    cyc = (np.cumsum(f0 / (200.0 * nhop), axis=-1) % 1.0).astype(np.float32)
    x = rng.standard_normal((B, nx)).astype(np.float32)
    hw = rng.uniform(2.0, C - 1, (B, Nf)).astype(np.float32)
    hw_int = np.ceil(hw).astype(np.int32)
    return x, cyc, hw, C - hw_int, C + hw_int + 1, C


def _render_inputs(K, notch, B=2, Nf=N // 2, nhop=80):
    """B utterances for osc_bank: cyc [B, Nf*nhop] (_win_inputs' mod-1
    track, its F0 different by row), ampl/phse/mask [B, Nf, K] with each
    frame's live slots below a random top (interior slots notched, as
    edited chunks notch them, with `notch`) and a residual input x [B, nx]
    -> (cyc, ampl, phse, mask, x)."""
    x, cyc = _win_inputs(nhop, 2 * nhop, K + 100 * notch, B=B, Nf=Nf)[:2]
    rng = np.random.default_rng(K + notch)
    ampl = rng.uniform(0, 1, (B, Nf, K)).astype(np.float32)
    phse = rng.uniform(-3, 3, (B, Nf, K)).astype(np.float32)
    top = rng.integers(1, K + 1, (B, Nf))
    mask = (np.arange(K) < top[..., None]).astype(np.float32)
    if notch:
        mask[..., 2] = 0.0
        mask[:, ::3, K // 2] = 0.0
    return cyc, ampl, phse, mask, x


def _deconv_inputs(nhop, seed, B=2, Nf=N, K=80):
    """B utterances for deconv_full at hop nhop: ampl, phse, mask [B, Nf, K]
    (~10% dead slots, unvoiced (zero) frames at both ends of each row, the
    amplitudes masked), the mod-1 cycle track cyc [B, Nf*nhop] (its F0
    different by row) and halfwidths hw [B, Nf] up to 458 samples."""
    cyc = _win_inputs(nhop, 2 * nhop, seed, B=B, Nf=Nf)[1]
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(B, Nf, K)) > 0.1).astype(np.float32)
    mask[0, :12] = mask[0, -20:] = 0.0
    mask[-1, :3] = mask[-1, -9:] = 0.0
    ampl = rng.uniform(0, 1, (B, Nf, K)).astype(np.float32) * mask
    phse = rng.uniform(-3, 3, (B, Nf, K)).astype(np.float32) * mask
    hw = rng.uniform(30, 458, (B, Nf)).astype(np.float32)
    return ampl, phse, cyc, hw, mask


def _noise_inputs(nhop, per_row, seed, B=2, Nf=N, C=4, Ke=4):
    """B utterances for noise_mod_ola at hop nhop (fs = 200 nhop): cyc
    [B, Nf*nhop] (its F0 different by row), edc/base [B, Nf, C], ar/ai
    [B, Nf, C, Ke], the standard-normal spectra re, im [B, Nf, nbin] (one
    [Nf, nbin] draw expanded to the batch, or with per_row a draw a row),
    gains [B, Nf, nbin] and the band ranges of the default channel edges at
    that rate -> (cyc, edc, ar, ai, base, re, im, gain), bands, fs."""
    from libllsm2_tpu_torch.config import ChunkConf
    cyc = _win_inputs(nhop, 2 * nhop, seed, B=B, Nf=Nf)[1]
    rng = np.random.default_rng(seed)
    nbin = nhop + 1
    edc = rng.uniform(0, 1, (B, Nf, C)).astype(np.float32)
    ar = rng.uniform(-0.3, 0.3, (B, Nf, C, Ke)).astype(np.float32)
    ai = rng.uniform(-0.3, 0.3, (B, Nf, C, Ke)).astype(np.float32)
    base = rng.uniform(0.5, 1.5, (B, Nf, C)).astype(np.float32)
    shape = (B, Nf, nbin) if per_row else (1, Nf, nbin)
    re, im = (np.broadcast_to(rng.standard_normal(shape).astype(np.float32),
                              (B, Nf, nbin)) for _ in range(2))
    gain = rng.uniform(0, 1, (B, Nf, nbin)).astype(np.float32)
    fs = 200.0 * nhop
    bands = kernels.band_ranges(nbin, fs, ChunkConf(fs=fs).chan_edges)
    return (cyc, edc, ar, ai, base, re, im, gain), bands, fs


def _noise_tensors(args, dev="cpu"):
    """_noise_inputs' arrays as tensors; an expanded draw stays expanded."""
    ts = [T(np.ascontiguousarray(a)).to(dev) for a in args]
    for i in (5, 6):
        if args[i].strides[0] == 0:
            ts[i] = ts[i][:1].expand_as(ts[7])
    return ts


def _stats_inputs(Nf, K, seed, complex_input):
    """One utterance of denoise_stats inputs (a, p, cyc_c, mask, voiced):
    mod-1 cycles, ~10% dead slots, unvoiced at both ends."""
    rng = np.random.default_rng(seed)
    ampl = rng.uniform(0.0, 1.0, (Nf, K)).astype(np.float32)
    phse = rng.uniform(-3.1, 3.1, (Nf, K)).astype(np.float32)
    cyc_c = (np.cumsum(rng.uniform(0.4, 0.6, Nf)) % 1.0).astype(np.float32)
    mask = (rng.uniform(size=(Nf, K)) > 0.1).astype(np.float32)
    voiced = ((np.arange(Nf) >= 5) & (np.arange(Nf) < int(0.85 * Nf))
              ).astype(np.float32)
    if complex_input:
        ampl, phse = ampl * np.cos(phse), ampl * np.sin(phse)
    return ampl * mask, phse * mask, cyc_c, mask, voiced


def _apply_inputs(B, Nf, K, seed):
    """denoise_apply inputs of B utterances, each with its own v and wmul."""
    rng = np.random.default_rng(seed)
    c = [rng.standard_normal((B, Nf, K)).astype(np.float32) for _ in range(4)]
    c[2] = c[0] + 0.3 * c[2]          # slow track near the track
    c[3] = c[1] + 0.3 * c[3]
    cyc_c = rng.uniform(0, 1, (B, Nf)).astype(np.float32)
    mask = (rng.uniform(size=(B, Nf, K)) > 0.1).astype(np.float32)
    guard = rng.uniform(size=(B, Nf)) > 0.2
    v = rng.uniform(0.0, 0.05, (B, K)).astype(np.float32)
    v[:, ::5] = 0.0
    wmul = np.clip(rng.uniform(-0.2, 1.2, (B, K)), 0, 1).astype(np.float32)
    return (*c, cyc_c, mask, guard, v, wmul)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (CUDA kernels have no CPU "
                    "or interpret mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_cuda_kernels_match_plain_on_card():
    """The four kernels of the denoiser-off path."""
    dev = _card()
    kernels.reset_launches()
    cyc, ampl, phse, mask, _ = (T(a).to(dev) for a in _render_inputs(80, True))
    torch.testing.assert_close(kernels.osc_bank(cyc, ampl, phse, mask, 80),
                               kernels.osc_bank_ref(cyc, ampl, phse, mask, 80),
                               atol=2e-4, rtol=0)
    x, cyc, hw, lo, hi, C = _win_inputs(80, 960, 3)
    args = [T(a).to(dev) for a in (x, cyc, hw)]
    lo, hi = T(lo).to(dev), T(hi).to(dev)
    kl = torch.randint(0, 80, hw.shape, device=dev, dtype=torch.int32)
    kw = dict(nhop=80, center=C, kl=kl)
    for g, r in zip(kernels.harmonic_project_win(*args, 80, lo, hi, **kw),
                    kernels.harmonic_project_win_ref(*args, 80, lo, hi, **kw)):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=1e-5)
    d_args = tuple(T(a).to(dev) for a in _deconv_inputs(80, 1)) + (7, 80, 8)
    for g, r in zip(kernels.deconv_full(*d_args), kernels.deconv_full_ref(*d_args)):
        torch.testing.assert_close(g, r, atol=5e-4, rtol=0)
    n_args, bands, _ = _noise_inputs(80, False, 2)
    n_args = _noise_tensors(n_args, dev) + [bands]
    torch.testing.assert_close(kernels.noise_mod_ola(*n_args),
                               kernels.noise_mod_ola_ref(*n_args),
                               atol=5e-5, rtol=0)
    assert {k: kernels.LAUNCHES[k] for k in
            ("osc_bank", "harmonic_project_win", "deconv_full",
             "noise_mod_ola")} == {"osc_bank": 1, "harmonic_project_win": 1,
                                   "deconv_full": 1, "noise_mod_ola": 1}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,notch,resid,nhop", [
    (80, True, False, 80), (80, True, True, 80), (24, False, True, 55),
    (7, False, False, 160)])
def test_osc_bank_kernel_matches_plain_on_card(K, notch, resid, nhop):
    """Synthesis and the analysis residual at the 16 kHz hop, the 11 kHz
    hop (a sample group partly idle) and a 32 kHz render (a second sample
    group), on 3 utterances of 301 frames (a ragged last 16-frame tile):
    2e-4 against the twin (test_pallas.py's), and each utterance's rows
    equal to the kernel on it alone."""
    dev = _card()
    cyc, ampl, phse, mask, x = (T(a).to(dev) for a in _render_inputs(
        K, notch, B=3, Nf=301, nhop=nhop))
    x = x if resid else None
    kernels.reset_launches()
    got = kernels.osc_bank(cyc, ampl, phse, mask, nhop, x)
    ref = kernels.osc_bank_ref(cyc, ampl, phse, mask, nhop, x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["osc_bank"] == 1
    torch.testing.assert_close(got, ref, atol=2e-4, rtol=0)
    for b in range(3):
        one = lambda t: None if t is None else t[b:b + 1]
        alone = kernels.osc_bank(*map(one, (cyc, ampl, phse, mask)), nhop,
                                 one(x))
        assert torch.equal(got[b], alone[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed,frame_base,N_,nbin", [
    (0, 0, 1600, 81), (12345, 1537, 301, 161), (-1, 3, 7, 3)])
def test_noise_bins_kernel_matches_plain_on_card(seed, frame_base, N_, nbin):
    """The draw on the card against the twin on the card: the bits equal,
    the normals within 1e-6; every batch row the same draw."""
    dev = _card()
    kernels.reset_launches()
    got = kernels.noise_bins(seed, frame_base, 2, N_, nbin, dev, bits=True)
    ref = kernels.noise_bins_ref(seed, frame_base, 2, N_, nbin, dev,
                                 bits=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["noise_bins"] == 1
    assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])
    for g, r in zip(got[:2], ref[:2]):
        assert g.shape == (2, N_, nbin) and torch.equal(g[0], g[1])
        torch.testing.assert_close(g, r, atol=1e-6, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("complex_input,Nf", [(True, 1600), (False, 1600),
                                              (True, 301), (False, 9)])
def test_denoise_stats_kernel_matches_plain_on_card(complex_input, Nf):
    """Two utterances of 1600 frames (the bench length), of 301 (a ragged
    last tile) and of 9 (shorter than the FIR halo), K = 80.  The kernel
    reduces k*cyc mod 1 with the product's rounding error added back, the
    twin as the Pallas kernel does: ~1e-5 apart at k = 80."""
    dev = _card()
    ins = [np.stack(v) for v in zip(*(_stats_inputs(Nf, 80, s, complex_input)
                                      for s in (1, 2)))]
    args = [T(v).to(dev) for v in ins]
    kernels.reset_launches()
    got = kernels.denoise_stats(*args, TAPS1, TAPS2,
                                complex_input=complex_input)
    ref = kernels.denoise_stats_ref(*args, TAPS1, TAPS2,
                                    complex_input=complex_input)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["denoise_stats"] == 1
    for name, g, r in zip(STATS_NAMES, got, ref):
        if name == "guard":
            assert torch.equal(g, r)
        else:
            torch.testing.assert_close(g, r, atol=2e-4, rtol=1e-3, msg=name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spectral,B,Nf,K", [
    (False, 2, 1600, 80), (True, 2, 1600, 80), (True, 1, 301, 24),
    (False, 1, 301, 81), (True, 3, 7, 81), (False, 2, 33, 24)])
def test_denoise_apply_kernel_matches_plain_on_card(spectral, B, Nf, K):
    """Both launches of pass B against their twins: the bench shape (K = 80,
    the float4 layout), K = 24 and 81 (the scalar layout, 81 with a ragged
    last slot pass), an odd row count (the last block's rows past the end)
    and B = 1; with spectral, the finish on a random delta too (an odd slot
    count at K = 81, 3 x 7 frames).  2e-4 absolute, 1e-4 relative (the
    kernel reduces k cyc mod 1 with the product's rounding error added
    back); (ampl, phse) compared as ampl e^{j phse}."""
    dev = _card()
    args = [T(v).to(dev) for v in _apply_inputs(B, Nf, K, 3)]
    polar = lambda ap: torch.polar(ap[0], ap[1])
    kernels.reset_launches()
    got = kernels.denoise_apply(*args, 8.0, spectral=spectral)
    ref = kernels.denoise_apply_ref(*args, 8.0, spectral=spectral)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["denoise_apply"] == 1
    if not spectral:
        torch.testing.assert_close(got[0], ref[0], atol=2e-4, rtol=1e-4)
        torch.testing.assert_close(polar(got), polar(ref), atol=2e-4,
                                   rtol=1e-4)
        return
    for g, r in zip(got, ref):
        assert g.dtype == torch.complex64
        torch.testing.assert_close(g, r, atol=2e-4, rtol=1e-4)
    gen = torch.Generator(dev).manual_seed(K)
    delta = 0.1 * torch.randn((B, Nf, K), dtype=torch.complex64, device=dev,
                              generator=gen)
    cyc_c, mask = args[4], args[5]
    fin = kernels.denoise_finish(got[0], delta, cyc_c, mask)
    fin_ref = kernels.denoise_finish_ref(got[0], delta, cyc_c, mask)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["denoise_finish"] == 1
    torch.testing.assert_close(fin[0], fin_ref[0], atol=2e-4, rtol=1e-4)
    torch.testing.assert_close(polar(fin), polar(fin_ref), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spectral", [False, True])
def test_denoise_apply_takes_offset_views_on_card(spectral):
    """Both launches on contiguous views that start one float (or one
    complex) into their buffers, off the 16-byte boundary their vector
    loads need: the wrappers copy them to aligned memory, and the results
    equal the launches on aligned copies bit for bit (K = 80, the float4
    layout)."""
    dev = _card()
    args = [T(v).to(dev) for v in _apply_inputs(2, 301, 80, 5)]

    def offset(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    moved = [offset(t) for t in args]
    assert all(t.data_ptr() % 16 for t in moved)
    got = kernels.denoise_apply(*moved, 8.0, spectral=spectral)
    ref = kernels.denoise_apply(*args, 8.0, spectral=spectral)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if spectral:
        gen = torch.Generator(dev).manual_seed(1)
        delta = torch.randn(ref[0].shape, dtype=torch.complex64, device=dev,
                            generator=gen)
        fin = kernels.denoise_finish(offset(ref[0]), offset(delta),
                                     offset(args[4]), offset(args[5]))
        fin_ref = kernels.denoise_finish(ref[0], delta, args[4], args[5])
        for g, r in zip(fin, fin_ref):
            assert torch.equal(g, r)


@pytest.mark.requires_cuda
def test_denoise_finish_past_2_31_slots_on_card():
    """The finish on 16778 x 1600 x 80 slots, past 2^31 (its 64-bit index
    path): the first and the last utterance equal the twin on the same
    slices (2e-4 absolute, 1e-4 relative, as the bench-shape test).  Needs
    ~56 GiB of the card's memory."""
    dev = _card()
    if torch.cuda.get_device_properties(dev).total_memory < 64 * 2 ** 30:
        pytest.skip("needs a card with 64 GiB of memory or more")
    B, Nf, K = 16778, 1600, 80
    assert B * Nf * K > 2 ** 31
    gen = torch.Generator(dev).manual_seed(2)
    a = torch.randn((B, Nf, K), dtype=torch.complex64, device=dev,
                    generator=gen)
    delta = 0.1 * torch.randn((B, Nf, K), dtype=torch.complex64, device=dev,
                              generator=gen)
    cyc_c = torch.rand((B, Nf), device=dev, generator=gen)
    mask = (torch.rand((B, Nf, K), device=dev, generator=gen) > 0.1).float()
    try:
        ampl, phse = kernels.denoise_finish(a, delta, cyc_c, mask)
        for b in (0, B - 1):
            s = slice(b, b + 1)
            ra, rp = kernels.denoise_finish_ref(a[s], delta[s], cyc_c[s],
                                                mask[s])
            torch.testing.assert_close(ampl[s], ra, atol=2e-4, rtol=1e-4)
            torch.testing.assert_close(torch.polar(ampl[s], phse[s]),
                                       torch.polar(ra, rp), atol=2e-4,
                                       rtol=1e-4)
    finally:
        del a, delta, mask
        torch.cuda.empty_cache()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,nhop,W,rep,Nf", [
    (80, 80, 960, 1, 301), (4, 20, 240, 4, 301),
    # where the 16-frame tile would not leave room for two blocks an SM
    # (the warp kernel): 48 kHz at 20 ms (20g: hop 960, C 1920) and at 35
    # ms, 96 kHz at 20 ms, 48 kHz at 50 ms (20h), 16 kHz at 250 ms, 96 kHz
    # at 200 ms and its envelope pass (hop 4800, W 9600), K 120 at 20h
    (80, 960, 3840, 1, 37), (80, 1680, 6720, 1, 37),
    (80, 1920, 11520, 1, 37), (80, 2400, 4800, 1, 37),
    (80, 4000, 8000, 1, 37), (80, 19200, 38400, 1, 13),
    (4, 4800, 9600, 4, 13), (120, 2400, 4800, 1, 37)])
def test_harmonic_project_win_kernel_matches_plain_on_card(K, nhop, W, rep,
                                                           Nf):
    """The main pass (K = 80, hop 80, W = 960) and the envelope pass (K = 4,
    hop 20, W = 240, four x rows on each cycle row) on 3 utterances of 301
    frames: a ragged last 16-frame tile, and the first and last frames
    reaching past both ends (zero x, edge cyc); where the 16-frame tile
    would not leave room for two blocks an SM (kernels._proj_win_geometry)
    the warp kernel, on rows of 37 or 13 frames (ragged for its 4-frame
    blocks).  re/im/xsum within 2e-3, wsum 1e-5 relative (test_pallas.py's),
    slots at or above kl exact zeros, and each utterance's rows equal to
    the kernel on it alone."""
    dev = _card()
    x, cyc, hw, lo, hi, C = (T(a).to(dev) if isinstance(a, np.ndarray) else a
                             for a in _win_inputs(nhop, W, K, B=3 * rep,
                                                  Nf=Nf))
    F = kernels._proj_win_geometry(nhop, C, K)[0]
    assert F == (16 if nhop <= 80 else 0)
    cyc = cyc[::rep].contiguous()
    kl = torch.randint(0, K + 1, hw.shape, device=dev, dtype=torch.int32,
                       generator=torch.Generator(dev).manual_seed(K))
    kl[:, :5] = K                         # voiced frames at the left edge
    kw = dict(nhop=nhop, center=C, kl=kl)
    kernels.reset_launches()
    got = kernels.harmonic_project_win(x, cyc, hw, K, lo, hi, **kw)
    ref = kernels.harmonic_project_win_ref(x, cyc, hw, K, lo, hi, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["harmonic_project_win"] == 1
    for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=0, rtol=1e-5)
    dead = torch.arange(K, device=dev) >= kl[..., None]
    assert not got[0][dead].any() and not got[1][dead].any()
    for b in range(x.shape[0]):
        alone = kernels.harmonic_project_win(
            x[b:b + 1], cyc[b // rep:b // rep + 1], hw[b:b + 1], K,
            lo[b:b + 1], hi[b:b + 1], nhop=nhop, center=C, kl=kl[b:b + 1])
        for g, a in zip(got, alone):
            assert torch.equal(g[b], a[0])


# the warp kernel's layouts (frames a block 0, columns a chunk, bytes):
# chunks of 32, 96 (ragged against a frame's span), 512 (the envelope
# pass's), 1792 (the main pass's) and 2048 columns
PROJ_WARP_LAYOUTS = ((0, 32, 1024), (0, 96, 3072), (0, 512, 16384),
                     (0, 1792, 57344), (0, 2048, 65536))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,nhop,W,rep", [(80, 80, 960, 1), (4, 20, 240, 4),
                                          (120, 80, 960, 1)])
def test_harmonic_project_win_tiles_equal_the_16_frame_tile_on_card(
        K, nhop, W, rep, monkeypatch):
    """harmonic_project_win forced onto the warp kernel, each of
    PROJ_WARP_LAYOUTS, at shapes the 16-frame tile takes, the main pass,
    the envelope pass and K = 120 (groups of 80): every output the
    16-frame tile's bits, one launch counted each."""
    dev = _card()
    x, cyc, hw, lo, hi, C = (T(a).to(dev) if isinstance(a, np.ndarray) else a
                             for a in _win_inputs(nhop, W, K + 1, B=2 * rep,
                                                  Nf=301))
    cyc = cyc[::rep].contiguous()
    kl = torch.randint(0, K + 1, hw.shape, device=dev, dtype=torch.int32,
                       generator=torch.Generator(dev).manual_seed(K))
    kw = dict(nhop=nhop, center=C, kl=kl)
    assert kernels._proj_win_geometry(nhop, C, K)[0] == 16
    ref = kernels.harmonic_project_win(x, cyc, hw, K, lo, hi, **kw)
    for geo in PROJ_WARP_LAYOUTS:
        monkeypatch.setattr(kernels, "_proj_win_geometry",
                            lambda *a, g=geo: g)
        n0 = kernels.LAUNCHES["harmonic_project_win"]
        got = kernels.harmonic_project_win(x, cyc, hw, K, lo, hi, **kw)
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert kernels.LAUNCHES["harmonic_project_win"] == n0 + 1
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), geo


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,nhop,W,Nf", [(80, 960, 3840, 37),
                                         (80, 2400, 4800, 37),
                                         (120, 2400, 4800, 37),
                                         (80, 19200, 38400, 13)])
def test_harmonic_project_win_warp_layouts_at_long_hops_on_card(
        K, nhop, W, Nf, monkeypatch):
    """The warp kernel at 20g's, 20h's and 96 kHz / 200 ms's hops and
    centres (and K 120 at 20h: groups of 80) on 65 utterances of 37 or 13
    frames (its 4-frame blocks ragged at every row's end and across rows):
    the route's layout against the twin (re/im/xsum 2e-3, wsum 1e-5
    relative), every other layout of PROJ_WARP_LAYOUTS its bits, and rows
    0, 1 and 64 each alone equal to their rows of the batch."""
    dev = _card()
    x, cyc, hw, lo, hi, C = (T(a).to(dev) if isinstance(a, np.ndarray) else a
                             for a in _win_inputs(nhop, W, K + 2, B=65,
                                                  Nf=Nf))
    kl = torch.randint(0, K + 1, hw.shape, device=dev, dtype=torch.int32,
                       generator=torch.Generator(dev).manual_seed(K + 2))
    kw = dict(nhop=nhop, center=C, kl=kl)
    assert kernels._proj_win_geometry(nhop, C, K)[0] == 0
    got = kernels.harmonic_project_win(x, cyc, hw, K, lo, hi, **kw)
    ref = kernels.harmonic_project_win_ref(x, cyc, hw, K, lo, hi, **kw)
    for g, r in zip(got[:2] + got[3:], ref[:2] + ref[3:]):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=0, rtol=1e-5)
    del ref
    for geo in PROJ_WARP_LAYOUTS:
        monkeypatch.setattr(kernels, "_proj_win_geometry",
                            lambda *a, g=geo: g)
        one = kernels.harmonic_project_win(x, cyc, hw, K, lo, hi, **kw)
        monkeypatch.undo()
        assert all(torch.equal(o, g) for o, g in zip(one, got)), geo
    for b in (0, 1, 64):
        alone = kernels.harmonic_project_win(
            x[b:b + 1], cyc[b:b + 1], hw[b:b + 1], K, lo[b:b + 1],
            hi[b:b + 1], nhop=nhop, center=C, kl=kl[b:b + 1])
        assert all(torch.equal(g[b], a[0]) for g, a in zip(got, alone)), b


def _mxu_inputs(B, Nf, nhop, H, seed):
    """B distinct utterances for harmonic_project_mxu: x, a mod-1 cycle
    track of a wandering F0, and window halfwidths in [2, H] (x and cyc
    [B, Nf*nhop], hw [B, Nf])."""
    rng = np.random.default_rng(seed)
    nx = Nf * nhop
    x = rng.standard_normal((B, nx)).astype(np.float32)
    f0 = 100.0 + 80.0 * rng.uniform(size=(B, 1)) \
        + 20.0 * np.sin(np.arange(nx)[None, :] / 900.0)
    cyc = (np.cumsum(f0 / 16000.0, axis=-1) % 1.0).astype(np.float32)
    hw = rng.uniform(2.0, H, (B, Nf)).astype(np.float32)
    return x, cyc, hw


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,W,R", [(1, 631, N), (4, 631, N), (80, 631, N),
                                   (80, 38400, 40), (12, 38400, 40)])
def test_harmonic_project_kernel_matches_plain_on_card(K, W, R):
    """K = 1 (the full-rate refine probe's shape: one warp per row), K = 4
    (the same kernel rotating) and K = 80 (one block per row), with each
    row's live columns [lo, hi); at W = 38400 (a frame of 96 kHz at a 200
    ms hop) on frames as the analysis windows them, rows 0-1 with live
    spans of 5487 columns (F0 70 Hz) and 6144 (the block's staged columns:
    staged once) and rows 2-3 of 6145 and 9601 (f0_floor 40: through the
    chunk buffers), the rest random; 2e-3 absolute (test_pallas.py:46),
    the long rows also each equal to the kernel on it alone."""
    dev = _card()
    rng = np.random.default_rng(K + W)
    dc = rng.uniform(-2, 2, (R, W)).astype(np.float32)
    col = np.arange(W)[None, :]
    if W > 29000:
        # a frame's live columns: its window's 2 hw + 1 <= 9601 around the
        # centre (f0_floor 40 at 96 kHz), xw a Hann-windowed signal of rms
        # 0.25
        C, hw = W // 2, rng.integers(2, 4801, R)
        hw[:4] = (2743, 3072, 3072, 4800)
        lo, hi = (C - hw).astype(np.int32), (C + hw + 1).astype(np.int32)
        hi[1] -= 1
        win = np.where(np.abs(col - C) <= hw[:, None],
                       0.5 + 0.5 * np.cos(np.pi * (col - C) / hw[:, None]),
                       0.0)
        xw = (0.25 * rng.standard_normal((R, W)) * win).astype(np.float32)
        S = kernels._project_geometry(W, K)[0]
        assert list(hi[:4] - lo[:4]) == [5487, 6144, 6145, 9601]
        assert list(hi[:4] - lo[:4] > S) == [False, False, True, True]
    else:
        lo = rng.integers(0, W // 3, R).astype(np.int32)
        hi = (lo + rng.integers(1, W - lo)).astype(np.int32)
        xw = np.where((col >= lo[:, None]) & (col < hi[:, None]),
                      rng.standard_normal((R, W)), 0.0).astype(np.float32)
    args = [T(a).to(dev) for a in (dc, xw)]
    lo, hi = T(lo).to(dev), T(hi).to(dev)
    kernels.reset_launches()
    got = kernels.harmonic_project(*args, K, lo, hi)
    ref = kernels.harmonic_project_ref(*args, K, lo, hi)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["harmonic_project"] == 1
    if K > 8:
        assert (kernels._project_geometry(W, K)[0] < W) == (W > 29000)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=0)
    if W > 29000:
        for n in (0, 1, 2, 3, R - 1):
            alone = kernels.harmonic_project(args[0][n:n + 1],
                                             args[1][n:n + 1], K,
                                             lo[n:n + 1], hi[n:n + 1])
            assert all(torch.equal(a[0], g[n]) for a, g in zip(alone, got))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("W,K", [(631, 80), (631, 12), (631, 200),
                                 (38400, 80)])
def test_harmonic_project_chunks_equal_the_whole_row_on_card(W, K,
                                                             monkeypatch):
    """harmonic_project's row kernel forced to stream its live columns
    through two chunk buffers of 128 and 384 columns (S 256 and 768), and
    at W = 38400 with S 6144 (the route's: spans to 6143, each staged once)
    and 12288, each at 2 and 5 groups of 8 harmonics a pass, at K 80, 12
    (two groups: one pass) and 200: every output the bits of the route's
    own layout -- each row's span staged once (all of W = 631, two groups
    a pass; five at W = 38400), whose sums are those of the one-group walk
    it replaced (port_wide_bits.py what=proj holds them to it)."""
    dev = _card()
    rng = np.random.default_rng(3 + W)
    R = N if W < 1000 else 40
    dc, xw = (T(rng.uniform(-2, 2, (R, W)).astype(np.float32)).to(dev)
              for _ in range(2))
    lo = T(rng.integers(0, W // 3, R).astype(np.int32)).to(dev)
    hi = T(rng.integers(W // 2, W, R).astype(np.int32)).to(dev)
    if W > 29000:
        hw = T(rng.integers(2, 3072, R).astype(np.int32)).to(dev)
        lo, hi = W // 2 - hw, W // 2 + hw + 1
    S, _, G = kernels._project_geometry(W, K)
    assert S == min(W, 6144) and bool(((hi - lo) <= S).all())
    assert G == (5 if W > 29000 else 2)
    ref = kernels.harmonic_project(dc, xw, K, lo, hi)
    for S in (256, 768) + ((6144, 12288) if W > 29000 else ()):
        for G in (2, 5):
            monkeypatch.setattr(kernels, "_project_geometry",
                                lambda *a, g=(S, 8 * S, G): g)
            got = kernels.harmonic_project(dc, xw, K, lo, hi)
            torch.cuda.synchronize()
            monkeypatch.undo()
            assert all(torch.equal(g, r) for g, r in zip(got, ref)), (S, G)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,nhop,H,B", [(80, 80, 458, 3), (4, 20, 115, 3),
                                        (24, 80, 458, 1), (81, 80, 458, 2)])
def test_harmonic_project_mxu_kernel_matches_plain_on_card(K, nhop, H, B):
    """B utterances of 301 frames (not a multiple of the 32-frame tile) at
    main-pass and envelope-pass widths, K = 80, 4, 24 and 81 (column
    counts that are not multiples of the 4-column thread tile and rotation
    chains cut short), the first and last three frames' windows at the
    largest halfwidth (reaching past both ends of the utterance): kernel
    against twin within 2e-3 x the twin's largest |re + j im| (raw window
    sums scale with the window), the window sums 1e-5 relative, and each
    utterance's rows equal to the kernel on that utterance alone -- no
    frame's window reads its neighbour."""
    dev = _card()
    x, cyc, hw = _mxu_inputs(B, 301, nhop, H, K)
    hw[:, :3] = hw[:, -3:] = H
    x, cyc, hw = (T(a).to(dev) for a in (x, cyc, hw))
    hh = -(-H // nhop)
    kernels.reset_launches()
    got = kernels.harmonic_project_mxu(x, cyc, hw, K, nhop, hh)
    ref = kernels.harmonic_project_mxu_ref(x, cyc, hw, K, nhop, hh)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["harmonic_project_mxu"] == 1
    zscale = float(torch.max(torch.hypot(ref[0], ref[1])))
    torch.testing.assert_close(torch.complex(got[0], got[1]),
                               torch.complex(ref[0], ref[1]),
                               atol=2e-3 * zscale, rtol=0)
    torch.testing.assert_close(got[2], ref[2], atol=0, rtol=1e-5)
    torch.testing.assert_close(got[3], ref[3],
                               atol=2e-3 * float(ref[3].abs().max()), rtol=0)
    for b in range(B):
        alone = kernels.harmonic_project_mxu(x[b:b + 1], cyc[b:b + 1],
                                             hw[b:b + 1], K, nhop, hh)
        for g, a in zip(got, alone):
            assert torch.equal(g[b], a[0])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,ntaps,cplx", [((3, 300, 80), 13, False),
                                              ((2, 1600, 1), 13, False),
                                              ((2, 150, 24), 31, True)])
def test_fir_frames_kernel_matches_plain_on_card(shape, ntaps, cplx):
    """The kernel sums in tap order with separate float32 multiply and add,
    as the twin does: equal within 1e-6; each utterance's rows equal to the
    kernel on that utterance alone (the zero edges stop at its ends)."""
    dev = _card()
    g = torch.Generator().manual_seed(ntaps)
    v = torch.randn(shape + ((2,) if cplx else ()), generator=g).to(dev)
    v = torch.view_as_complex(v) if cplx else v
    taps = tuple(tl0._hann_taps(ntaps))
    kernels.reset_launches()
    got = kernels.fir_frames(v, taps)
    ref = kernels.fir_frames_ref(v, taps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fir_frames"] == 1
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=0)
    for b in range(shape[0]):
        assert torch.equal(kernels.fir_frames(v[b:b + 1], taps)[0], got[b])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shapes,ntaps", [
    (((128, 200, 80), (128, 200, 80)), 3),  # the spectral gate's pair
    (((3, 150, 1), (3, 150, 24)), 7)])       # voicing column, complex track
def test_fir_frames_pair_kernel_matches_plain_on_card(shapes, ntaps):
    """A pair in one launch (float4 columns and single ones), bit-equal to
    the twin on each tensor."""
    dev = _card()
    g = torch.Generator().manual_seed(ntaps)
    v = (torch.rand(shapes[0], generator=g).to(dev),
         torch.randn(shapes[1], generator=g, dtype=torch.complex64).to(dev)
         if ntaps == 7 else torch.rand(shapes[1], generator=g).to(dev))
    taps = tl0._hann_taps(ntaps)
    kernels.reset_launches()
    got = kernels.fir_frames(v, taps)
    ref = kernels.fir_frames_ref(v, taps)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fir_frames"] == 1
    assert isinstance(got, tuple) and len(got) == 2
    for g_, r in zip(got, ref):
        assert g_.dtype == r.dtype and torch.equal(g_, r)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cut", [0, 45])
def test_env_render_kernel_matches_plain_on_card(cut):
    """Two utterances of 301 frames (not a multiple of the 16-frame tile),
    C = 4, Ke = 4, nhop = 80, whole and `cut` samples short of N*nhop (the
    last tile stops early): env 2e-5, base 2e-6 (test_pallas.py:231)."""
    dev = _card()
    g = torch.Generator().manual_seed(5)
    B, Nf, C, Ke, nhop = 2, 301, 4, 4, 80
    r = lambda *s: torch.rand(*s, generator=g).to(dev)
    args = (r(B, Nf * nhop)[:, :Nf * nhop - cut], r(B, Nf, C),
            0.3 * r(B, Nf, C, Ke) - 0.15, 0.3 * r(B, Nf, C, Ke) - 0.15,
            r(B, Nf, C) + 0.5)
    kernels.reset_launches()
    env, base = kernels.env_render(*args, nhop=nhop)
    env_r, base_r = kernels.env_render_ref(*args, nhop=nhop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["env_render"] == 1
    assert env.shape == (B, C, Nf * nhop - cut)
    torch.testing.assert_close(env, env_r, atol=2e-5, rtol=0)
    torch.testing.assert_close(base, base_r, atol=2e-6, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,Nf,C,Ke,nhop,cut", [
    (1, 301, 4, 4, 80, 2),      # nx % 4 == 2: the scalar path
    (2, 301, 4, 4, 80, 44),     # a cut render on the float4 path
    (2, 2, 4, 4, 80, 0),        # N = 2, one partial tile
    (1, 130, 1, 1, 80, 0),
    (2, 130, 5, 3, 55, 0),
    (2, 130, 4, 6, 80, 3),
    (3, 64, 4, 4, 160, 0),      # a whole tile
    (2, 130, 4, 9, 80, 0),      # Ke past 8: the wide kernel
    (1, 70, 3, 12, 480, 5),     # and at 48 kHz's 10 ms hop, cut
    (2, 130, 4, 16, 80, 0),     # 16 and 24 harmonics: four and six
    (2, 130, 2, 24, 160, 0),    # ladder chunks
    (2, 130, 1, 9, 80, 0),      # one channel
    (2, 130, 9, 9, 80, 0),      # nine: a group of 8, then one
    (2, 301, 4, 9, 80, 44),     # a cut render
    (2, 2, 4, 9, 80, 0),        # one partial tile
    (2, 130, 5, 10, 55, 0),     # an odd hop: single loads and stores
])
def test_env_render_kernel_paths_on_card(B, Nf, C, Ke, nhop, cut):
    """Each of env_render's paths (float4 along samples at C = Ke = 4 with
    nhop and nx multiples of 4, a sample at a time otherwise, and past Ke
    = 8 the wide kernel: runs of 4 samples, 16-byte where the hop allows,
    the ladder in chunks of 4 harmonics for groups of 4 or 8 channels)
    against the twin: env 2e-5, base 2e-6 (test_pallas.py:231)."""
    dev = _card()
    g = torch.Generator().manual_seed(B * 1000 + C * 10 + Ke)
    r = lambda *s: torch.rand(*s, generator=g).to(dev)
    args = (r(B, Nf * nhop)[:, :Nf * nhop - cut], r(B, Nf, C),
            0.3 * r(B, Nf, C, Ke) - 0.15, 0.3 * r(B, Nf, C, Ke) - 0.15,
            r(B, Nf, C) + 0.5)
    kernels.reset_launches()
    env, base = kernels.env_render(*args, nhop=nhop)
    env_r, base_r = kernels.env_render_ref(*args, nhop=nhop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["env_render"] == 1
    assert env.shape == (B, C, Nf * nhop - cut)
    torch.testing.assert_close(env, env_r, atol=2e-5, rtol=0)
    torch.testing.assert_close(base, base_r, atol=2e-6, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop,polar,Nf", [(80, False, N), (80, True, 301),
                                           (55, False, N), (160, False, 130)])
def test_deconv_full_kernel_matches_plain_on_card(nhop, polar, Nf):
    """The quadrature field, centre cycles and mask from the cycle track in
    the kernel, at the 16 kHz, 11 kHz and 32 kHz hops, ragged 64-frame
    tiles: the masked (re, im) within 5e-4 (test_pallas.py's), or the polar
    track compared as |c| e^{j angle c}."""
    dev = _card()
    args = tuple(T(a).to(dev) for a in _deconv_inputs(nhop, nhop, Nf=Nf))
    kernels.reset_launches()
    got = kernels.deconv_full(*args, 7, nhop, 8, return_complex=not polar)
    ref = kernels.deconv_full_ref(*args, 7, nhop, 8, return_complex=not polar)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deconv_full"] == 1
    z = (lambda p: torch.polar(*p)) if polar else (lambda p: torch.complex(*p))
    torch.testing.assert_close(z(got), z(ref), atol=5e-4, rtol=0)


@pytest.mark.requires_cuda
def test_deconv_full_largest_band_on_card():
    """D = 56, the widest band whose first-kernel block fits the shared
    memory at K = 80, against the twin (5e-4); D = 57 runs the wide kernel
    (two chunks of 40 columns) against the twin too; only a band far past
    the JAX branch's D <= 128 is refused, by the wrapper, not by a failed
    launch."""
    dev = _card()
    args = tuple(T(a).to(dev) for a in _deconv_inputs(80, 3, Nf=130))
    assert kernels._deconv_geometry(56, 80, 20)[1] == 0
    assert kernels._deconv_geometry(57, 80, 20)[1] == 40
    for D in (56, 57):
        got = kernels.deconv_full(*args, D, 80, 8)
        ref = kernels.deconv_full_ref(*args, D, 80, 8)
        torch.testing.assert_close(torch.complex(*got), torch.complex(*ref),
                                   atol=5e-4, rtol=0)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.deconv_full(*args, 1000, 80, 8)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("polar", [False, True])
def test_deconv_full_wide_kernel_equals_the_first_on_card(polar,
                                                         monkeypatch):
    """The wide path forced onto a shape the first kernel takes (K = 80,
    D = 7, ragged 64-frame tiles): chunks of 16, 24, 18, 64 and 2 columns
    (the last chunk short: 8 of 24, 8 of 18), output tiles of 64, 32, 16
    and 8 frames, the taps through device memory, built at tiles of 64,
    32, 16 and 8 frames with the quadrature field staged or computed by
    the tap build -- every output the first kernel's bits, one launch
    counted a call; a row alone under a forced geometry equals its row of
    the batch."""
    dev = _card()
    args = tuple(T(a).to(dev) for a in _deconv_inputs(80, 11, Nf=N))
    kw = dict(return_complex=not polar)
    ref = kernels.deconv_full(*args, 7, 80, 8, **kw)
    for FT, KC, TT, stage in ((64, 16, 64, 1), (32, 24, 32, 0),
                              (16, 18, 16, 1), (8, 64, 8, 0),
                              (64, 2, 64, 0)):
        geo = (FT, KC, 0, 0, TT, stage)
        monkeypatch.setattr(kernels, "_deconv_geometry",
                            lambda *a, geo=geo: geo)
        n0 = kernels.LAUNCHES["deconv_full"]
        got = kernels.deconv_full(*args, 7, 80, 8, **kw)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["deconv_full"] == n0 + 1
        assert all(torch.equal(g, r) for g, r in zip(got, ref)), geo
    row = kernels.deconv_full(*(a[1:] for a in args), 7, 80, 8, **kw)
    assert all(torch.equal(r[0], g[1]) for r, g in zip(row, ref))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,D,nhop,Nf", [
    (200, 26, 32, 400),    # 16 kHz, 2 ms hop, f0_floor 40: full band
    (342, 16, 96, 200),    # 48 kHz, 2 ms hop, f0_floor 70
    (600, 11, 240, 200),   # 48 kHz, 5 ms hop, f0_floor 40
    (80, 113, 16, 300),    # 32-frame tiles: 64 frames' taps fill a block
    (80, 128, 16, 300),    # the JAX branch's widest band
    (120, 128, 480, 300),  # the field computed by the tap build
    (200, 26, 32, 4000),   # a 4000-frame row: 16 kHz at a 2 ms hop, 8 s
    (201, 26, 32, 70),     # an odd K, the last chunk short; two tiles
])
def test_deconv_full_wide_kernel_matches_plain_on_card(K, D, nhop, Nf):
    """deconv_full past the first kernel's shared memory (full-band K, or D
    past 56): the wide path (the taps into device memory, then the output
    in chunks), one launch counted, against the twin, the masked (re, im)
    within 5e-4 and the polar track as |c| e^{j angle c}; a row alone
    equals its row of the batch bit for bit."""
    dev = _card()
    ampl, phse, cyc, hw, mask = _deconv_inputs(nhop, K + D, Nf=Nf, K=K)
    hw = np.random.default_rng(D).uniform(30, (D - 1) * nhop, hw.shape)
    args = tuple(T(a).to(dev) for a in (ampl, phse, cyc,
                                        hw.astype(np.float32), mask))
    assert kernels._deconv_geometry(D, K, 2 * nhop // 8)[1] > 0
    for polar in (True, False):
        z = (lambda p: torch.polar(*p)) if polar else \
            (lambda p: torch.complex(*p))
        n0 = kernels.LAUNCHES["deconv_full"]
        got = kernels.deconv_full(*args, D, nhop, 8, return_complex=not polar)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["deconv_full"] == n0 + 1
        ref = kernels.deconv_full_ref(*args, D, nhop, 8,
                                      return_complex=not polar)
        torch.testing.assert_close(z(got), z(ref), atol=5e-4, rtol=0)
    row = kernels.deconv_full(*(a[1:] for a in args), D, nhop, 8)
    assert all(torch.equal(r[0], g[1]) for r, g in zip(row, got))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop,per_row,Nf", [(80, False, N), (80, True, 301),
                                             (55, False, N), (160, True, 47)])
def test_noise_mod_ola_kernel_matches_plain_on_card(nhop, per_row, Nf):
    """The band iDFT, OLA, modulation and band sum in one launch against
    the twin's segments, 5e-5 (test_pallas.py's): one draw expanded to the
    batch (stride 0) and a draw a row, hops 80, 55 (an empty band) and 160,
    frame counts off the 15-hop tile."""
    dev = _card()
    args, bands, _ = _noise_inputs(nhop, per_row, nhop, Nf=Nf)
    args = _noise_tensors(args, dev) + [bands]
    kernels.reset_launches()
    got = kernels.noise_mod_ola(*args)
    ref = kernels.noise_mod_ola_ref(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["noise_mod_ola"] == 1
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop,Nf,C,Ke", [(80, N, 4, 4), (55, 301, 4, 4),
                                          (160, 47, 3, 4), (80, 301, 9, 9),
                                          (480, 130, 4, 4),
                                          (882, 31, 4, 12), (81, 40, 2, 0)])
def test_noise_mod_ola_seg_kernel_matches_plain_on_card(nhop, Nf, C, Ke):
    """The segment-input entry (noise_idft="fft"): OLA, modulation and
    band sum of given [B, C, N, 2 nhop] segments in one launch against
    its twin, 5e-5 as the fused entry; frame counts off the 32-hop tile,
    an odd channel count, 9 channels of 9 envelope harmonics (the ladder
    in chunks), hops past 256 (16-byte runs at 480, 8-byte ones at 882),
    an odd hop without envelope harmonics."""
    dev = _card()
    args, _, _ = _noise_inputs(nhop, True, nhop + 1, Nf=Nf, C=C, Ke=Ke)
    cyc, edc, ar, ai, base = _noise_tensors(args, dev)[:5]
    segs = torch.randn((2, C, Nf, 2 * nhop), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(nhop))
    kernels.reset_launches()
    got = kernels.noise_mod_ola_seg(cyc, edc, ar, ai, base, segs)
    ref = kernels.noise_mod_ola_seg_ref(cyc, edc, ar, ai, base, segs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["noise_mod_ola_seg"] == 1
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("change", [dict(hm_method="pp"),
                                    dict(hm_passes=2),
                                    dict(hm_correction="none")])
def test_polar_denoise_stats_on_a_library_path_on_card(change):
    """The analysis options whose denoiser takes polar input (no complex
    handoff: HMPP, Gauss-Seidel passes, no correction) on two 2 s rows:
    each call of denoise_stats there has complex_input False and matches
    its twin within 2e-3 of the track's peak (test_pallas.py's)."""
    import dataclasses
    from libllsm2_tpu_torch import create_aoptions
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    opt = dataclasses.replace(create_aoptions(f0_floor=70.0, use_pallas=True),
                              **change)
    utt = testsig.make_test_utterances([(0, 0.05), (1, 0.05)], duration=2.0)
    x, f0 = (torch.tensor(np.stack([u[j] for u in utt]),
                          dtype=torch.float32, device=dev) for j in range(2))
    calls = []
    orig = kernels.denoise_stats

    def hook(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    kernels.denoise_stats = hook
    try:
        tl0._analyze(opt, x, f0)
    finally:
        kernels.denoise_stats = orig
    assert len(calls) == 1 and not calls[0][1].get("complex_input", False)
    args, kw = calls[0]
    got = kernels.denoise_stats(*args, **kw)
    ref = kernels.denoise_stats_ref(*args, **kw)
    scale = float(args[0].abs().max())
    assert torch.equal(got[3], ref[3])
    for g, r in zip(got[:3], ref[:3]):
        torch.testing.assert_close(g / scale, r / scale, atol=2e-3, rtol=0)
    for g, r in zip(got[4:], ref[4:]):
        torch.testing.assert_close(g, r, atol=2e-3 * scale, rtol=0)


@pytest.mark.requires_cuda
def test_plain_branches_launch_no_pallas_counterpart_on_card():
    """use_pallas=False on the card: analyze -> synthesize of two 1 s rows
    runs on the card (the output is a CUDA tensor), launches only the
    noise draw and the cycle track, and its rows equal the CPU's within
    1e-3 of the largest amplitude."""
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    opt, sopt = create_aoptions(f0_floor=70.0), create_soptions()
    utt = testsig.make_test_utterances([(0, 0.05), (64, 0.0)], duration=1.0)
    x, f0 = (torch.tensor(np.stack([u[j] for u in utt]), dtype=torch.float32)
             for j in range(2))
    kernels.reset_launches()
    ch = tl0._analyze(opt, x.to(dev), f0.to(dev))
    out = tl0._synthesize(sopt, ch)
    torch.cuda.synchronize()
    assert out.y.device.type == "cuda"
    assert {k for k, v in kernels.LAUNCHES.items() if v} == {
        "sample_cycles", "noise_bins"}
    cpu = tl0._analyze(opt, x, f0)
    scale = float(cpu.ampl.abs().max())
    torch.testing.assert_close(torch.polar(ch.ampl, ch.phse).cpu(),
                               torch.polar(cpu.ampl, cpu.phse),
                               atol=1e-3 * scale, rtol=0)


def _f0_rows(B, Nf, seed):
    """B F0 tracks of Nf frames, 80-300 Hz, each with unvoiced stretches."""
    rng = np.random.default_rng(seed)
    t = np.arange(Nf)[None, :]
    f0 = 150.0 + 60.0 * np.sin(t / rng.uniform(20, 90, (B, 1))
                               + rng.uniform(0, 6, (B, 1))) \
        + rng.uniform(-40, 40, (B, 1))
    f0[(t % 400) > rng.integers(300, 400, (B, 1))] = 0.0
    return f0.astype(np.float32)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop", [55, 80, 110, 160, 512, 513, 600, 882,
                                  960, 1024, 1025, 2048, 2205, 2400, 4000,
                                  19200])
def test_sample_cycles_kernel_matches_plain_on_card(nhop):
    """The cycle-track kernel against its twin over 1600 hops, both mod 1:
    wrapped |difference| <= 1e-4 cycles from the twin on the card (its
    float32 scan), <= 1e-6 from the twin on the CPU, which sums in the
    kernel's order; past hop 512 the long-hop kernel (64 lanes a hop to
    1024, 128 to 2048), at the lane counts' edges too; past 2048 the hop
    kernels (a block of 256 lanes a hop: 2205 and 2400, 44.1 and 48 kHz
    at 50 ms; 4000, 16 kHz at 250 ms; 19200, 96 kHz at 200 ms)."""
    dev = _card()
    f0 = T(_f0_rows(3, 1600, nhop))
    kernels.reset_launches()
    got = kernels.sample_cycles(f0.to(dev), nhop, 200.0 * nhop, 1600 * nhop)
    ref = kernels.sample_cycles_ref(f0.to(dev), nhop, 200.0 * nhop,
                                    1600 * nhop)
    cpu = kernels.sample_cycles_ref(f0, nhop, 200.0 * nhop, 1600 * nhop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sample_cycles"] == 1
    wrapped = lambda d: float((d - torch.round(d)).abs().max())
    assert wrapped(got.double() - ref.double()) <= 1e-4
    assert wrapped(got.cpu().double() - cpu.double()) <= 1e-6
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop,B,Nf", [(55, 1, 1601), (80, 3, 1600),
                                       (80, 1, 1633), (110, 2, 97),
                                       (160, 3, 1601), (40, 3, 1633),
                                       (400, 2, 301), (80, 1, 210000),
                                       (960, 3, 400), (2048, 2, 187),
                                       (882, 1, 19100)])
def test_sample_cycles_kernel_equals_cpu_twin_on_card(nhop, B, Nf):
    """On _f0_rows tracks (voicing edges included; their in-hop sums are
    exact: tests/test_torch_ops.py) the kernel equals the twin run on the
    CPU bit for bit, for one row, for hop counts that are not a multiple
    of the kernel's tile, for the long-hop kernel (hops 960, 2048) and
    for a row past 2^24 samples at hops 80 and 882 (its positions there
    divided, not read from the table); a row whose hop ramps from 1e-11
    Hz to 1000 Hz (sums not exact) stays within 1e-6 cycles."""
    dev = _card()
    fs, nx = 200.0 * nhop, Nf * nhop
    f0 = T(_f0_rows(B, Nf, nhop))
    got = kernels.sample_cycles(f0.to(dev), nhop, fs, nx).cpu()
    assert torch.equal(got, kernels.sample_cycles_ref(f0, nhop, fs, nx))
    odd = f0[:1].clone()
    odd[0, 10], odd[0, 11] = 1e-11, 1000.0
    got = kernels.sample_cycles(odd.to(dev), nhop, fs, nx).cpu().double()
    d = got - kernels.sample_cycles_ref(odd, nhop, fs, nx).double()
    assert float((d - torch.round(d)).abs().max()) <= 1e-6


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop,fs,B,Nf", [(2205, 44100.0, 2, 150),
                                          (2400, 48000.0, 3, 161),
                                          (4000, 16000.0, 2, 101),
                                          (19200, 96000.0, 3, 41),
                                          (60000, 96000.0, 2, 12)])
def test_sample_cycles_hop_kernels_at_long_hops_on_card(nhop, fs, B, Nf):
    """Past a 2048-sample hop, at the hop's own rate: F0 70-1000 Hz (at 96
    kHz over 19200 samples a hop's partials reach 200 cycles) with
    unvoiced stretches (voicing edges, where a hop's steps start from 0).
    Their in-hop sums are exact (sample_cycles.cu: below 2^29 times the
    smallest step for nhop < 32768), so the kernel equals the twin run on
    the CPU bit for bit, for a row alone too and with base= and start=
    (a frame shard's block); a hop ramping from 1e-11 Hz to 1000 Hz (sums
    not exact) stays within two float32 ulps of the largest sum a hop
    makes, m = 1000 nhop / fs cycles and the offset: 2^-15 at 96 kHz and
    16 kHz (m 200, 250), 2^-17 at 44.1 and 48 kHz (m 50) -- a partial
    rounded the other way, then the offset it carries to the hops after.
    At hop 60000 (96 kHz, 625 ms) a hop's steps overflow the block's
    shared memory and the kernel evaluates them again in its output pass
    (sample_cycles.cu, stash = 0); there a voicing edge's sum can round in
    its float64's last bit (the hop's total past 2^30 times the smallest
    step), which moves a float32 output with odds of ~2^-29 a sample, and
    these seeded tracks keep the twin's bits.
    The profiler sees one kernel past the prep that zeroes its words."""
    dev = _card()
    rng = np.random.default_rng(nhop)
    t = np.arange(Nf)[None, :]
    f0 = 535.0 + 465.0 * np.sin(t / rng.uniform(3, 9, (B, 1))
                                 + rng.uniform(0, 6, (B, 1)))
    f0[(t % 20) > rng.integers(12, 18, (B, 1))] = 0.0
    f0 = T(f0.astype(np.float32))
    nx = Nf * nhop
    kernels.reset_launches()
    got = kernels.sample_cycles(f0.to(dev), nhop, fs, nx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sample_cycles"] == 1
    # one kernel past the prep that zeroes its words; a profile's first
    # launches can go unrecorded, so the second call's are read
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            kernels.sample_cycles(f0.to(dev), nhop, fs, nx)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events() if "sample_cycles" in e.name
             and e.device_type == torch.autograd.DeviceType.CUDA]
    assert all("sample_cycles_prep" in n or "sample_cycles_hop_kernel" in n
               for n in names), names
    assert len(names) >= 2 and "sample_cycles_prep" in names[-2] \
        and "sample_cycles_hop_kernel" in names[-1], names
    assert torch.equal(got.cpu(), kernels.sample_cycles_ref(f0, nhop, fs, nx))
    alone = kernels.sample_cycles(f0[1:2].to(dev), nhop, fs, nx)
    assert torch.equal(alone[0], got[1])
    base = torch.tensor([0.25, 17.5, 3.0][:B], dtype=torch.float64)
    for start in (5, -2):
        blk = kernels.sample_cycles(f0.to(dev), nhop, fs, nx,
                                    base=base.to(dev), start=start).cpu()
        assert torch.equal(blk, kernels.sample_cycles_ref(
            f0, nhop, fs, nx, base=base, start=start))
    odd = f0[:1].clone()
    odd[0, 10], odd[0, 11] = 1e-11, 1000.0
    got = kernels.sample_cycles(odd.to(dev), nhop, fs, nx).cpu().double()
    d = got - kernels.sample_cycles_ref(odd, nhop, fs, nx).double()
    m = nhop * 1000.0 / fs + 1.0
    ulp = 2.0 ** (np.floor(np.log2(m)) - 23)
    assert float((d - torch.round(d)).abs().max()) <= 2.0 * ulp


@pytest.mark.requires_cuda
def test_sample_cycles_rows_do_not_depend_on_the_batch_on_card():
    """A row's cycle track on the card is the same, bit for bit, alone, in
    a 128-row batch and in that batch permuted."""
    dev = _card()
    f0 = T(_f0_rows(128, 1600, 7)).to(dev)
    perm = torch.randperm(128, generator=torch.Generator().manual_seed(1))
    whole = kernels.sample_cycles(f0, 80, 16000.0, 128000)
    permuted = kernels.sample_cycles(f0[perm.to(dev)], 80, 16000.0, 128000)
    for r in (0, 1, 64, 127):
        alone = kernels.sample_cycles(f0[r:r + 1], 80, 16000.0, 128000)
        assert torch.equal(alone[0], whole[r])
    assert torch.equal(permuted, whole[perm.to(dev)])


@pytest.mark.requires_cuda
def test_layer1_and_pbp_on_card_match_cpu():
    """A 0.5 s LF utterance analyzed on the CPU, then layer 1 and PbP on
    the card against the same calls on the CPU: rd within 1e-3 relative
    (an in-model source, where the Rd score has a clear peak), the
    regenerated harmonics within 1e-4 x scale, PbP y_sin within 2e-4 x
    peak (the pulses add in one order on both and their onsets are summed
    exactly; the LF spectra's float32 transcendentals round otherwise on
    the two devices: 1.1e-4 measured on an H100, 2.1e-4 when the card
    summed the cycle count in float32 and added pulses by index_add_),
    and the noise part through noise_mod_ola."""
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.models import layer1 as tl1, pbp as tpbp
    from libllsm2_tpu_torch.utils import testsig
    import dataclasses
    dev = _card()
    f0 = testsig.make_f0_track(100, 0.005)
    x, f0 = testsig.synth_lf_speech(f0, rd=1.2)
    opt = create_aoptions(use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    ch = tl0.analyze(opt, x.astype(np.float32), f0.astype(np.float32),
                     device="cpu")
    to_dev = lambda c: c.replace(**{f: getattr(c, f).to(dev) for f in
                                    ("f0", "ampl", "phse", "hm_mask", "psd",
                                     "edc", "eenv_a", "eenv_p")})
    l1_cpu, l1_dev = tl1.chunk_to_layer1(ch), tl1.chunk_to_layer1(to_dev(ch))
    torch.testing.assert_close(l1_dev.rd.cpu(), l1_cpu.rd, rtol=1e-3, atol=0)
    b_cpu, b_dev = tl1.chunk_to_layer0(l1_cpu), tl1.chunk_to_layer0(l1_dev)
    z = lambda c: torch.polar(c.ampl, c.phse)
    scale = float(b_cpu.ampl.abs().max())
    torch.testing.assert_close(z(b_dev).cpu(), z(b_cpu), atol=1e-4 * scale,
                               rtol=0)
    kernels.reset_launches()
    y_dev = tpbp.pbp_synthesize(sopt, l1_dev)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["noise_mod_ola"] == 1
    y_cpu = tpbp.pbp_synthesize(sopt, l1_cpu)
    peak = float(y_cpu.y_sin.abs().max())
    print("pbp y_sin card - cpu: max |difference| / peak "
          f"{float((y_dev.y_sin.cpu() - y_cpu.y_sin).abs().max()) / peak:.3e}")
    torch.testing.assert_close(y_dev.y_sin.cpu(), y_cpu.y_sin,
                               atol=2e-4 * peak, rtol=0)


@pytest.mark.requires_cuda
def test_layer1_pbp_and_edits_rows_do_not_depend_on_the_batch_on_card():
    """66 LF rows of 1 s (Rd 0.4 / 1.0 / 1.8 / 2.7 by row) analyzed on the
    card, then chunk_to_layer1, chunk_to_layer0, pbp_synthesize and the
    edit chain pitch_shift(2.0) -> time_stretch(1.5) -> synthesize_batch:
    rows 0, 1 and 64, each alone (a batch of one fed that row of the
    stage's batch input), equal their rows of the batch bit for bit, field
    by field and in y, y_sin and y_nos; two runs of the batch are equal."""
    import dataclasses
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.container import CHUNK_FIELDS, LAYER1_FIELDS
    from libllsm2_tpu_torch.models import edits, layer1 as tl1, pbp as tpbp
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    f0 = testsig.make_f0_track(200, 0.005)
    utt = [testsig.synth_lf_speech(f0, rd=(0.4, 1.0, 1.8, 2.7)[i % 4],
                                   seed=i) for i in range(66)]
    x, f0 = (torch.tensor(np.stack([u[j] for u in utt]),
                          dtype=torch.float32, device=dev) for j in range(2))
    ys = ("y", "y_sin", "y_nos")
    chains = [
        [(tl1.chunk_to_layer1, LAYER1_FIELDS),
         (tl1.chunk_to_layer0, ("ampl", "phse", "hm_mask")),
         (lambda c: tl0._synthesize(sopt, c), ys)],
        [(tl1.chunk_to_layer1, ()),
         (lambda c: tpbp._pbp_synthesize(sopt, c), ys)],
        [(tl1.chunk_to_layer1, ()),
         (lambda c: edits.pitch_shift(c, 2.0), CHUNK_FIELDS),
         (lambda c: edits.time_stretch(c, 1.5), CHUNK_FIELDS),
         (lambda c: tl0.synthesize_batch(sopt, c), ys)]]
    for chain in chains:
        inp = tl0._analyze(opt, x, f0)
        for fn, names in chain:
            whole, again = fn(inp), fn(inp)
            for name in names:
                assert torch.equal(getattr(whole, name),
                                   getattr(again, name)), name
            for r in (0, 1, 64):
                alone = fn(inp.map(lambda a: a[r:r + 1]))
                for name in names:
                    assert torch.equal(getattr(alone, name)[0],
                                       getattr(whole, name)[r]), (r, name)
            inp = whole


@pytest.mark.requires_cuda
@pytest.mark.parametrize("D", [1, 4])
def test_band_envelopes_rows_do_not_depend_on_the_batch_on_card(D):
    """The envelope FFTs run in calls of layer0.ROW_GROUP rows: rows 0, 1
    and 99 of a 100-row batch of 8 s residuals (forward in groups whose
    last is zero-padded, the 400 band rows back) equal, bit for bit, the
    same rows alone and in a 3-row batch."""
    from libllsm2_tpu_torch.config import ChunkConf
    dev = _card()
    conf = ChunkConf()
    res = torch.randn((100, 128000), generator=torch.Generator().manual_seed(D))
    res = res.to(dev)
    whole = tl0._band_envelopes(res, conf, D)
    rows = [0, 1, 99]
    three = tl0._band_envelopes(res[rows], conf, D)
    for i, r in enumerate(rows):
        alone = tl0._band_envelopes(res[r:r + 1], conf, D)
        assert torch.equal(alone[0], whole[r])
        assert torch.equal(three[i], whole[r])


@pytest.mark.requires_cuda
def test_analysis_rows_do_not_depend_on_the_batch_on_card():
    """The library-default analysis and synthesis of 6 bench-like rows (2 s,
    3 noisy, 3 clean) on the card: rows 0, 1 and 4 alone give, bit for bit,
    every field of their chunk and y, y_sin, y_nos of the 6-row batch."""
    import dataclasses
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.container import LAYER0_FIELDS
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    utt = testsig.make_test_utterances(
        [(i, 0.05 if i < 3 else 0.0) for i in range(6)], duration=2.0)
    x, f0 = (torch.tensor(np.stack([u[j] for u in utt]),
                          dtype=torch.float32, device=dev) for j in range(2))
    whole = tl0._analyze(opt, x, f0)
    y_whole = tl0._synthesize(sopt, whole)
    for r in (0, 1, 4):
        alone = tl0._analyze(opt, x[r:r + 1], f0[r:r + 1])
        for name in LAYER0_FIELDS:
            assert torch.equal(getattr(alone, name)[0],
                               getattr(whole, name)[r]), name
        y_alone = tl0._synthesize(sopt, alone)
        for i in range(3):
            assert torch.equal(y_alone[i][0], y_whole[i][r]), i


@pytest.mark.requires_cuda
def test_f0_tracker_rows_do_not_depend_on_the_batch_on_card():
    """ops/f0.py on the card: rows 0, 1 and 69 of a 70-row batch of 4 s
    bench-like rows (two row groups, the last padded) equal, bit for bit,
    the same rows alone and in a 3-row batch; the track agrees with the
    CPU's on voicing in >= 99% of frames and on voiced F0 within 1e-3
    relative."""
    from libllsm2_tpu_torch.ops import f0 as tf0
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    utt = testsig.make_test_utterances(
        [(i, 0.05 * (i % 2)) for i in range(70)], duration=4.0)
    x = torch.tensor(np.stack([u[0] for u in utt]), dtype=torch.float32)
    cfg = tf0.F0Config(f0_floor=70.0)
    whole = tf0.track_batch(cfg, x.to(dev))
    rows = [0, 1, 69]
    three = tf0.track_batch(cfg, x[rows].to(dev))
    for i, r in enumerate(rows):
        assert torch.equal(tf0.track(cfg, x[r].to(dev)), whole[r])
        assert torch.equal(three[i], whole[r])
    cpu = tf0.track_batch(cfg, x[:2], device="cpu")
    got = whole[:2].cpu()
    assert float(((got > 0) == (cpu > 0)).float().mean()) >= 0.99
    v = (got > 0) & (cpu > 0)
    assert float(torch.max(torch.abs(got[v] / cpu[v] - 1.0))) <= 1e-3


@pytest.mark.requires_cuda
def test_run_corpus_files_equals_run_corpus_on_card(tmp_path):
    """run_corpus_files on the card on 10 WAVs cut from 2 s bench-like rows
    (half with an F0 sidecar, the rest tracked; buckets (200, 400), batch
    8): every file once, and the rows of each batch equal run_corpus on the
    same int16-quantized float signals (x_i16 * float32(1 / 32767)) with
    the sidecar F0 and, for tracked files, the tracker's F0 on the padded
    row, bit for bit: SNR and y."""
    import dataclasses
    import os
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.ops import f0 as tf0
    from libllsm2_tpu_torch.parallel import corpus
    from libllsm2_tpu_torch.utils import dataio, testsig
    dev = _card()
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = dataclasses.replace(create_soptions(), use_pallas=True)
    utt = testsig.make_test_utterances(
        [(i, 0.05 if i < 4 else 0.0) for i in range(8)], duration=2.0)
    rows = {r: (u[0].astype(np.float32), u[1].astype(np.float32))
            for r, u in enumerate(utt)}
    paths = testsig.write_test_corpus(
        tmp_path, 10, lambda i: rows[testsig.corpus_row(i, half=4)],
        min_s=0.5, max_s=2.0)
    buckets = (200, 400)
    got = list(corpus.run_corpus_files(opt, sopt, paths, buckets, 8,
                                       want_audio=True))
    assert sorted(p for r in got for p in r["paths"]) == sorted(paths)
    cfg = tf0.F0Config(fs=opt.conf.fs, nhop=80, f0_floor=70.0)
    for r in got:
        P, b = r["paths"], r["bucket"]
        x16, ln, _ = dataio.load_wav_batch(P, b * 80, dtype="int16")
        xq = x16.astype(np.float32) * np.float32(1.0 / 32767.0)
        tracked = tf0.track_batch(cfg, torch.tensor(xq, device=dev)).cpu()
        f0s = [np.load(p[:-4] + ".f0.npy")
               if os.path.exists(p[:-4] + ".f0.npy") else tracked[j].numpy()
               for j, p in enumerate(P)]
        ref = list(corpus.run_corpus(opt, sopt,
                                     [xq[j, :n] for j, n in enumerate(ln)],
                                     f0s, buckets, 8))
        assert len(ref) == 1 and ref[0]["bucket"] == b
        np.testing.assert_array_equal(r["snr"], ref[0]["snr"])
        np.testing.assert_array_equal(r["y"], ref[0]["y"][:len(P)].cpu()
                                      .numpy())
        np.testing.assert_array_equal(r["nx"], ln)


@pytest.mark.requires_cuda
def test_refine_f0_rows_do_not_depend_on_the_batch_on_card():
    """harmonics.refine_f0 on the card (one launch of refine_f0.cu: a block
    a run of frames of one row, a thread a frame summing in an order of
    its frame's alone, the block's width chosen by the batch): rows 0, 1
    and 63 of
    a 64-row batch of 8 s bench-like rows, with zeroed tails of different
    lengths, equal bit for bit the same rows alone and in the first 3 rows
    of a 128-row batch."""
    from libllsm2_tpu_torch.ops import harmonics
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    utt = testsig.make_test_utterances(
        [(i, 0.05 * (i % 2)) for i in range(64)], duration=8.0)
    x = torch.tensor(np.stack([u[0] for u in utt]), dtype=torch.float32)
    f0 = torch.tensor(np.stack([u[1] for u in utt]), dtype=torch.float32)
    for r in range(64):
        x[r, 128000 - 977 * r:] = 0.0
    x, f0 = x.to(dev), f0.to(dev)
    kw = dict(nhop=80, fs=16000.0, halfwin_max=458, rel_winsize=4.0,
              f0_ceil=600.0)
    whole = harmonics.refine_f0(x, f0, **kw)
    big = harmonics.refine_f0(torch.cat([x[[0, 1, 63]], x]),
                              torch.cat([f0[[0, 1, 63]], f0]), **kw)
    for i, r in enumerate((0, 1, 63)):
        alone = harmonics.refine_f0(x[r:r + 1], f0[r:r + 1], **kw)
        assert torch.equal(alone[0], whole[r])
        assert torch.equal(big[i], whole[r])


def _refine_rows(B, seconds, dev):
    """B bench-like rows (noisy and clean alternating) -> (x [B, nx], f0
    [B, N]) on dev."""
    from libllsm2_tpu_torch.utils import testsig
    utt = testsig.make_test_utterances(
        [(i, 0.05 * (i % 2)) for i in range(B)], duration=seconds)
    return tuple(torch.tensor(np.stack([u[j] for u in utt]),
                              dtype=torch.float32, device=dev)
                 for j in range(2))


def _dec_args(nx, window="hanning"):
    from libllsm2_tpu_torch.ops import harmonics
    D, taps, g, pass_hz = harmonics.refine_decimation(80, nx, 16000.0, 600.0)
    return taps, dict(D=D, g=g, nhop=80, fs=16000.0, halfwin_max=458,
                      rel_winsize=4.0, window=window, iters=2,
                      max_rel_dev=0.05, pass_hz=pass_hz)


def _f0_rel(got, ref):
    """Largest relative |difference| of two F0 tracks; a frame voiced in
    one and not the other is infinite."""
    if not torch.equal(got == 0, ref == 0):
        return float("inf")
    return float(((got - ref).abs() / ref.abs().clamp(min=1e-6)).max())


@pytest.mark.requires_cuda
def test_refine_f0_dec_matches_twin_on_card():
    """kernels.refine_f0_dec at the main path's shape (128 rows x 8 s, D =
    8, 97 taps, Wf = 140; one launch that decimates into shared memory and
    probes a thread a frame): within 1e-4 relative of its twin on the
    card, one launch counted; harmonics.refine_f0 on card tensors reaches
    neither the twin nor layer0._row_groups."""
    from libllsm2_tpu_torch.ops import harmonics
    dev = _card()
    x, f0 = _refine_rows(128, 8.0, dev)
    taps, kw = _dec_args(x.shape[1])
    n0 = kernels.LAUNCHES["refine_f0_dec"]
    got = kernels.refine_f0_dec(x, f0, taps, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refine_f0_dec"] == n0 + 1
    ref = kernels.refine_f0_dec_ref(x, f0, taps, **kw)
    assert _f0_rel(got, ref) <= 1e-4
    twin, groups = kernels.refine_f0_dec_ref, tl0._row_groups

    def refuse(*a, **k):
        raise AssertionError("refine_f0 on the card left the kernel")
    kernels.refine_f0_dec_ref = tl0._row_groups = refuse
    try:
        out = harmonics.refine_f0(x, f0, nhop=80, fs=16000.0,
                                  halfwin_max=458, rel_winsize=4.0,
                                  f0_ceil=600.0)
    finally:
        kernels.refine_f0_dec_ref, tl0._row_groups = twin, groups
    assert torch.equal(out, got)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("window", ["hanning", "hamming", "blackman",
                                    "blackman_harris", "nuttall98",
                                    "mltsine"])
def test_refine_f0_dec_windows_on_card(window):
    """Every window window_centered takes (the kernel's window is a
    template argument, its support the frame's integer offsets |noff| <=
    hw): the kernel within 1e-4 relative of its twin on 4 rows of 2 s."""
    dev = _card()
    x, f0 = _refine_rows(4, 2.0, dev)
    taps, kw = _dec_args(x.shape[1], window)
    got = kernels.refine_f0_dec(x, f0, taps, **kw)
    assert _f0_rel(got, kernels.refine_f0_dec_ref(x, f0, taps, **kw)) <= 1e-4


def _refine_case(case, dev):
    """(x [B, nx], f0 [B, N], window) of a refine_f0_dec card case."""
    if case == "edges":               # first and last frames voiced
        x, f0 = _refine_rows(2, 2.0, dev)
        f0[:, :3] = torch.where(f0[:, :3] > 0, f0[:, :3], 120.0)
        f0[:, -3:] = torch.where(f0[:, -3:] > 0, f0[:, -3:], 180.0)
        return x, f0, "hanning"
    if case == "ragged":              # N = 1563: no block width divides it
        x, f0 = _refine_rows(3, 8.0, dev)
        return x[:, :1563 * 80], f0[:, :1563], "hanning"
    if case == "rtanalyzer":          # B = 1, N = 160: a RTAnalyzer block
        x, f0 = _refine_rows(1, 8.0, dev)
        return x[:, 800 * 80:960 * 80], f0[:, 800:960], "hanning"
    x, f0 = _refine_rows(4, 2.0, dev)
    if case == "voicing":             # a row unvoiced, a row alternating
        f0[0] = 0.0
        f0[1, ::2] = 0.0
        return x, f0, "hanning"
    return x, f0, "mltsine"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["edges", "ragged", "rtanalyzer", "voicing",
                                  "mltsine"])
def test_refine_f0_dec_cases_on_card(case):
    """kernels.refine_f0_dec on the first and last frames of a row, on N =
    1563 frames (a multiple of no block width), on one 160-frame row (a
    RTAnalyzer block), on an unvoiced and an alternating row and with the
    mltsine window: within 1e-4 relative of its twin, voicing equal, and
    each row alone (a batch of one: 16 lanes a frame) bit for bit equal to
    its row in the batch and in a batch of >= 128 rows (a thread a
    frame)."""
    dev = _card()
    x, f0, window = _refine_case(case, dev)
    taps, kw = _dec_args(x.shape[1], window)
    got = kernels.refine_f0_dec(x, f0, taps, **kw)
    ref = kernels.refine_f0_dec_ref(x, f0, taps, **kw)
    assert _f0_rel(got, ref) <= 1e-4
    B = x.shape[0]
    reps = -(-128 // B)
    big = kernels.refine_f0_dec(x.repeat(reps, 1), f0.repeat(reps, 1), taps,
                                **kw)
    for r in range(B):
        alone = kernels.refine_f0_dec(x[r:r + 1], f0[r:r + 1], taps, **kw)
        assert torch.equal(alone[0], got[r]), r
        assert torch.equal(big[r + B * (reps - 1)], got[r]), r
    if case == "edges":
        assert bool((got[:, [0, 1, -2, -1]] > 0).all())
    if case == "voicing":
        assert bool((got[0] == 0).all()) and bool((got[1, ::2] == 0).all())
        assert bool((got[1, 1::2] > 0).any())


def _full_rows(B, seconds, dev):
    """B bench-like rows at 11 kHz (hop 55: the full-rate refine; noisy and
    clean alternating) -> (x [B, nx], f0 [B, N]) on dev."""
    from libllsm2_tpu_torch.utils import testsig
    utt = testsig.make_test_utterances(
        [(i, 0.05 * (i % 2)) for i in range(B)], duration=seconds,
        fs=11000.0)
    return tuple(torch.tensor(np.stack([u[j] for u in utt]),
                              dtype=torch.float32, device=dev)
                 for j in range(2))


# refine_f0_full's arguments at 11 kHz, f0_floor 70 (H = 315, delta = 39)
FULL_KW = dict(nhop=55, fs=11000.0, halfwin_max=315, rel_winsize=4.0,
               window="hanning", iters=2, max_rel_dev=0.05)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["2 rows", "16 rows", "3200 frames"])
def test_refine_f0_full_matches_twin_on_card(case):
    """kernels.refine_f0_full (one launch: F frames of a row a block, a
    thread or 16 lanes a frame) on 2 and 16 rows of 8 s at 11 kHz and on
    one row of 3200 frames: within 1e-4 relative of its twin on the card,
    voicing equal, one launch counted; harmonics.refine_f0 on card
    tensors at hop 55 reaches the kernel, never the twin."""
    from libllsm2_tpu_torch.ops import harmonics
    dev = _card()
    B = {"2 rows": 2, "16 rows": 16, "3200 frames": 2}[case]
    x, f0 = _full_rows(B, 8.0, dev)
    if case == "3200 frames":
        x, f0 = x.reshape(1, -1), f0.reshape(1, -1)
    n0 = kernels.LAUNCHES["refine_f0_full"]
    got = kernels.refine_f0_full(x, f0, **FULL_KW)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refine_f0_full"] == n0 + 1
    assert _f0_rel(got, kernels.refine_f0_full_ref(x, f0, **FULL_KW)) <= 1e-4
    twin = kernels.refine_f0_full_ref

    def refuse(*a, **k):
        raise AssertionError("refine_f0 on the card left the kernel")
    kernels.refine_f0_full_ref = refuse
    try:
        out = harmonics.refine_f0(x, f0, nhop=55, fs=11000.0,
                                  halfwin_max=315, rel_winsize=4.0,
                                  f0_ceil=600.0)
    finally:
        kernels.refine_f0_full_ref = twin
    assert torch.equal(out, got)


def _full_case(case, dev):
    """(x [B, nx], f0 [B, N], window) of a refine_f0_full card case."""
    x, f0 = _full_rows(4, 2.0, dev)
    if case == "edges":       # voiced within H + delta of both ends
        f0[:, :8] = torch.where(f0[:, :8] > 0, f0[:, :8], 120.0)
        f0[:, -8:] = torch.where(f0[:, -8:] > 0, f0[:, -8:], 180.0)
    elif case == "voicing":   # a row unvoiced, a row alternating
        f0[0] = 0.0
        f0[1, ::2] = 0.0
    elif case == "floor and ceiling":   # hw = H; hw near its least
        f0[0, 50:150] = 62.0
        f0[1, 50:150] = 590.0
    return x, f0, case if case in ("mltsine", "blackman_harris") else "hanning"


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["edges", "voicing", "floor and ceiling",
                                  "mltsine", "blackman_harris"])
def test_refine_f0_full_cases_on_card(case):
    """kernels.refine_f0_full on frames voiced within H + delta of both
    ends of a row (probes reading the zero padding), on an unvoiced and an
    alternating row (unvoiced frames give 0), at F0 62 Hz (hw = H) and 590
    Hz, and with mltsine and blackman_harris: within 1e-4 relative of its
    twin, voicing equal, and each row alone (a batch of one: 16 lanes a
    frame) bit for bit equal to its row in the batch and in a batch of
    128 rows (a thread a frame)."""
    dev = _card()
    x, f0, window = _full_case(case, dev)
    kw = dict(FULL_KW, window=window)
    got = kernels.refine_f0_full(x, f0, **kw)
    assert _f0_rel(got, kernels.refine_f0_full_ref(x, f0, **kw)) <= 1e-4
    big = kernels.refine_f0_full(x.repeat(32, 1), f0.repeat(32, 1), **kw)
    for r in range(4):
        alone = kernels.refine_f0_full(x[r:r + 1], f0[r:r + 1], **kw)
        assert torch.equal(alone[0], got[r]), r
        assert torch.equal(big[r + 4 * 31], got[r]), r
    if case == "edges":
        assert bool((got[:, [0, 1, -2, -1]] > 0).all())
    if case == "voicing":
        assert bool((got[0] == 0).all()) and bool((got[1, ::2] == 0).all())
        assert bool((got[1, 1::2] > 0).any())


@pytest.mark.requires_cuda
def test_refine_f0_full_every_block_gives_the_same_bits_on_card():
    """Every (F, G) of kernels._REFINE_BLOCKS, forced through the C entry
    on 16 rows of 2 s at 11 kHz, gives the same F0 bits: no block width or
    lane count enters a sum."""
    dev = _card()
    x, f0 = _full_rows(16, 2.0, dev)
    lib = kernels._build.library()
    outs = []
    for F, G in kernels._REFINE_BLOCKS:
        out = torch.empty_like(f0)
        args = list(kernels._refine_full_launch_args(x, f0, out, **FULL_KW))
        args[-3:-1] = [F, G]
        assert lib.llsm_refine_f0_full(*args) == 0, (F, G)
        torch.cuda.synchronize()
        outs.append(out)
    for (F, G), out in zip(kernels._REFINE_BLOCKS[1:], outs[1:]):
        assert torch.equal(out, outs[0]), (F, G)


@pytest.mark.requires_cuda
def test_refine_f0_full_refuses_what_it_cannot_launch_on_card():
    """A launch the C entry refuses (3 lanes a frame) raises from
    kernels._launch, counting nothing; a window too long for a block's
    shared memory raises from the wrapper before any launch."""
    dev = _card()
    x, f0 = _full_rows(2, 1.0, dev)
    out = torch.empty_like(f0)
    args = list(kernels._refine_full_launch_args(x, f0, out, **FULL_KW))
    args[-2] = 3
    n0 = kernels.LAUNCHES["refine_f0_full"]
    with pytest.raises(RuntimeError, match="refine_f0_full"):
        kernels._launch("refine_f0_full", *args)
    with pytest.raises(ValueError, match="shared"):
        kernels.refine_f0_full(x, f0, **dict(FULL_KW, halfwin_max=60000))
    assert kernels.LAUNCHES["refine_f0_full"] == n0


@pytest.mark.requires_cuda
def test_refine_f0_block_with_bounds_equals_one_process_on_card():
    """A frame shard's hop-aligned blocks of an 8 s row (400 frames each,
    24 frames of halo, zeros past the signal's edges fenced off by bounds,
    as parallel.seqparallel cuts them) refine their core frames to the
    one-process F0 bit for bit: each frame decimates its window's samples
    from x itself, in the block that holds it, whatever the block."""
    from libllsm2_tpu_torch.ops import harmonics
    dev = _card()
    x, f0 = _refine_rows(2, 8.0, dev)
    kw = dict(nhop=80, fs=16000.0, halfwin_max=458, rel_winsize=4.0,
              f0_ceil=600.0)
    whole = harmonics.refine_f0(x, f0, **kw)
    N, h, nl = f0.shape[1], 24, 400
    F = torch.nn.functional
    for r in range(2):
        for a in range(0, N, nl):
            lo_f, hi_f = a - h, a + nl + h
            pad_l, pad_r = max(-lo_f, 0), max(hi_f - N, 0)
            xb = F.pad(x[r, max(lo_f, 0) * 80:min(hi_f, N) * 80],
                       (pad_l * 80, pad_r * 80))
            fb = F.pad(f0[r, max(lo_f, 0):min(hi_f, N)], (pad_l, pad_r))
            bounds = (pad_l * 80, xb.shape[0] - pad_r * 80)
            block = harmonics.refine_f0(xb[None], fb[None], bounds=bounds,
                                        **kw)[0]
            assert torch.equal(block[h:h + nl], whole[r, a:a + nl]), (r, a)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("synth_mode", ["harmonic", "pbp"])
def test_stream_pool_equals_solo_on_card(synth_mode):
    """runtime.rtserve.StreamPool on the card: 5 streams of 1 s bench-like
    rows (the library-default analysis; layer 1 for PbP) fed 7 frames at a
    time, each equal bit for bit to its solo stream_chunk(block=16) on the
    card, which lies within 2e-5 (PbP 2e-4) of the same stream on the
    CPU."""
    import dataclasses
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.models import layer1
    from libllsm2_tpu_torch.runtime import rtsynth
    from libllsm2_tpu_torch.runtime.rtserve import StreamPool
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    opt = create_aoptions(f0_floor=70.0, use_pallas=True)
    sopt = create_soptions()
    utt = testsig.make_test_utterances(
        [(i, 0.05 * (i % 2)) for i in range(5)], duration=1.0)
    chunks = [tl0.analyze(opt, u[0].astype(np.float32),
                          u[1].astype(np.float32), device=dev) for u in utt]
    if synth_mode == "pbp":
        chunks = [layer1.chunk_to_layer1(c) for c in chunks]
    frames = [rtsynth.RTSynthesizer.chunk_frames_np(c) for c in chunks]
    pool = StreamPool(sopt, opt.conf, n_streams=5, feed_block=16,
                      synth_mode=synth_mode, device=dev)
    outs = [[] for _ in chunks]
    for p in range(0, max(map(len, frames)), 7):
        for s, fr in enumerate(frames):
            if p < len(fr):
                pool.feed(s, fr[p:p + 7])
        while pool.service():
            pass
        for s in range(5):
            outs[s].append(pool.fetch(s, pool.readable(s)))
    for s in range(5):
        pool.end_stream(s)
        outs[s].append(pool.fetch(s, pool.readable(s)))
    tol = 2e-5 if synth_mode == "harmonic" else 2e-4
    for s, c in enumerate(chunks):
        so = dataclasses.replace(sopt, noise_seed=sopt.noise_seed + s)
        solo = rtsynth.stream_chunk(so, c, block=16, synth_mode=synth_mode)
        assert np.array_equal(np.concatenate(outs[s]), solo), s
        cpu = rtsynth.stream_chunk(so, c.map(lambda a: a.cpu()), block=16,
                                   synth_mode=synth_mode)
        np.testing.assert_allclose(solo, cpu, atol=tol)


def _viterbi_inputs(B, N, S, seed, eighths):
    """obs [B, N, S] in [-20, 0) and lt [S, S] in [-6, 0), both in
    multiples of 1/8 with `eighths` (tied candidates)."""
    rng = np.random.default_rng(seed)
    obs = rng.uniform(-20.0, 0.0, (B, N, S))
    lt = rng.uniform(-6.0, 0.0, (S, S))
    if eighths:
        obs, lt = np.round(obs * 8.0) / 8.0, np.round(lt * 8.0) / 8.0
    return T(obs.astype(np.float32)), T(lt.astype(np.float32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,N,S,renorm,eighths", [
    (3, 300, 97, True, False), (3, 300, 64, False, False),
    (4, 257, 97, True, True), (4, 257, 64, False, True),      # ties
    (2, 1, 97, True, False), (2, 1, 64, False, True),         # N = 1
    (2, 2, 64, False, False), (2, 2, 97, True, True),         # N = 2
    (2, 120, 256, True, True), (2, 120, 256, False, False),   # lt in HBM
    (2, 3000, 97, True, False),                # backpointers in HBM
    (1, 1600, 97, True, False), (5, 40, 1, True, False),
    (3, 50, 33, False, True)])
def test_viterbi_scan_kernel_equals_twin_on_card(B, N, S, renorm, eighths):
    """kernels.viterbi_scan (one launch, counted) against its twin on the
    card and on the CPU: paths and last scores equal bit for bit, with
    and without renormalization, ties, N = 1 and 2, S = 256 (lt in device
    memory), 3000 frames (backpointers in device memory), one state; the
    first and last rows alone equal their rows in the batch."""
    dev = _card()
    obs, lt = (t.to(dev) for t in _viterbi_inputs(B, N, S, N + S, eighths))
    n0 = kernels.LAUNCHES["viterbi_scan"]
    path, score = kernels.viterbi_scan(obs, lt, renorm, scores=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["viterbi_scan"] == n0 + 1
    ref_path, ref_score = kernels.viterbi_scan_ref(obs, lt, renorm,
                                                   scores=True)
    assert torch.equal(path, ref_path) and torch.equal(score, ref_score)
    cpu_path, cpu_score = kernels.viterbi_scan_ref(obs.cpu(), lt.cpu(),
                                                   renorm, scores=True)
    assert torch.equal(path.cpu(), cpu_path)
    assert torch.equal(score.cpu(), cpu_score)
    for r in (0, B - 1):
        p, s = kernels.viterbi_scan(obs[r:r + 1], lt, renorm, scores=True)
        assert torch.equal(p[0], path[r]) and torch.equal(s[0], score[r])


def _viterbi_inf_inputs(B, N, S, renorm, seed):
    """_viterbi_inputs in eighths with 10% -inf entries and frames 5-14
    all tied: with renorm each of those frames one constant, the last
    state never -inf (no renormalized frame all -inf); without, those
    frames all zero (an unvoiced stretch as layer1._rd_viterbi masks it)."""
    obs, lt = _viterbi_inputs(B, N, S, seed, True)
    g = torch.Generator().manual_seed(seed)
    hole = torch.rand(obs.shape, generator=g) < 0.1
    if renorm:
        hole[..., -1] = False
    obs[hole] = -float("inf")
    obs[:, 5:15] = obs[:, 5:15, -1:] if renorm else 0.0
    return obs, lt


@pytest.mark.requires_cuda
@pytest.mark.parametrize("B,N,S,renorm", [
    (4, 300, 97, True), (4, 300, 64, False),
    (2, 3000, 97, True), (2, 3000, 64, False),   # backpointers in HBM
    (2, 120, 200, True), (2, 120, 256, False),   # lt in shared / HBM
    (3, 90, 12, True), (3, 90, 24, False),       # 8, 16 and 64 slots a
    (3, 90, 120, True)])                         # lane in registers
def test_viterbi_scan_kernel_inf_and_ties_on_card(B, N, S, renorm):
    """-inf entries and all-tied frames, inside viterbi.cu's contract:
    paths and last scores (the -inf ones too) equal the twin's on the card
    and on the CPU bit for bit, also where the backpointers go to device
    memory, where lt is in shared or device memory, and at the lt-in-
    registers kernels the other card tests leave out."""
    dev = _card()
    obs, lt = _viterbi_inf_inputs(B, N, S, renorm, 7 * N + S)
    path, score = kernels.viterbi_scan(obs.to(dev), lt.to(dev), renorm,
                                       scores=True)
    cpu_path, cpu_score = kernels.viterbi_scan_ref(obs, lt, renorm,
                                                   scores=True)
    assert torch.isfinite(cpu_score).any(-1).all() or not renorm
    assert torch.equal(path.cpu(), cpu_path)
    assert torch.equal(score.cpu(), cpu_score)


@pytest.mark.requires_cuda
def test_viterbi_callers_launch_the_kernel_on_card():
    """f0.viterbi and layer1._rd_viterbi on card tensors launch the kernel
    once each and never reach the twin, and give the CPU's paths; past
    256 states (uint16 backpointers, one lane a state) the kernel equals
    the twin at S = 257 and 512; the wrapper refuses lt of another
    shape."""
    from libllsm2_tpu_torch.models import layer1 as tl1
    from libllsm2_tpu_torch.ops import f0 as tf0
    dev = _card()
    rng = np.random.default_rng(9)
    logobs = T(rng.uniform(-30.0, 0.0, (2, 400, 97)).astype(np.float32))
    lt = tf0._tables(tf0.F0Config(), "cpu")["lt"]
    score = T(rng.uniform(0.0, 1.0, (2, 400, 64)).astype(np.float32))
    voiced = T(rng.uniform(size=(2, 400)) > 0.2)
    twin = kernels.viterbi_scan_ref

    def refuse(*a, **k):
        raise AssertionError("a card path reached the twin")
    n0 = kernels.LAUNCHES["viterbi_scan"]
    kernels.viterbi_scan_ref = refuse
    try:
        p_f0 = tf0.viterbi(logobs.to(dev), lt.to(dev))
        p_rd = tl1._rd_viterbi(score.to(dev), voiced.to(dev), 10.0)
    finally:
        kernels.viterbi_scan_ref = twin
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["viterbi_scan"] == n0 + 2
    assert torch.equal(p_f0.cpu(), tf0.viterbi(logobs, lt))
    assert torch.equal(p_rd.cpu(), tl1._rd_viterbi(score, voiced, 10.0))
    for S in (257, 512):
        obs = T(np.round(rng.uniform(-12.0, 0.0, (2, 300, S)) * 8.0) / 8.0)
        lt = T(np.round(rng.uniform(-4.0, 0.0, (S, S)) * 8.0) / 8.0)
        for renorm in (True, False):
            got = kernels.viterbi_scan(obs.to(dev), lt.to(dev), renorm,
                                       scores=True)
            ref = kernels.viterbi_scan_ref(obs, lt, renorm, scores=True)
            assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
    obs = torch.zeros((1, 4, 257), device=dev)
    with pytest.raises(ValueError):
        kernels.viterbi_scan(obs[..., :8], torch.zeros((8, 9), device=dev),
                             True)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,n1,n2,complex_input", [
    (160, 13, 7, True), (160, 13, 7, False), (80, 33, 17, True),
    (80, 41, 21, False), (200, 101, 51, True), (600, 13, 7, False),
    (200, 33, 17, True)])
def test_denoise_stats_wide_kernel_matches_plain_on_card(K, n1, n2,
                                                         complex_input):
    """denoise_stats past the first kernel's K <= 128 and 31-tap limits
    (creaky voice's K = 160; a 2 ms hop's 33 + 17 taps; 5 Hz at a 5 ms
    hop's 41 + 21; K = 200 with 101 + 51 taps, three chunks of 80, 80 and
    40 and a halo past the 64-frame tile; full band's K = 600 at 48 kHz,
    five chunks, the last of 88, and K = 200 with 33 + 17 taps at 16 kHz
    with a 2 ms hop, 128 + 72): the wide path, one launch counted, against
    the twin within the bench shape's tolerance, on 1600 frames, 301 (a
    ragged tile) and for 16 kHz at 2 ms a 4000-frame row; a row alone
    equals its row of the batch bit for bit.  Past K = 200 the absolute
    tolerance grows with K: the twin rotates harmonic k by a float32
    product k cyc, whose rounding (~k 2^-24 cycles) the kernel's
    compensated product (common.cuh's kmul_c) does not make."""
    dev = _card()
    t1, t2 = tuple(tl0._hann_taps(n1)), tuple(tl0._hann_taps(n2))
    assert kernels._denoise_geometry(K, n1, n2)[0] > 0
    atol = 2e-4 * max(1.0, K / 200)
    for Nf in (1600, 301) + ((4000,) if (K, n1) == (200, 33) else ()):
        ins = [np.stack(v) for v in zip(*(
            _stats_inputs(Nf, K, s, complex_input) for s in (1, 2)))]
        args = [T(v).to(dev) for v in ins]
        kernels.reset_launches()
        got = kernels.denoise_stats(*args, t1, t2,
                                    complex_input=complex_input)
        ref = kernels.denoise_stats_ref(*args, t1, t2,
                                        complex_input=complex_input)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["denoise_stats"] == 1
        for name, g, r in zip(STATS_NAMES, got, ref):
            if name == "guard":
                assert torch.equal(g, r)
            else:
                torch.testing.assert_close(g, r, atol=atol, rtol=1e-3,
                                           msg=name)
        row = kernels.denoise_stats(*(a[1:] for a in args), t1, t2,
                                    complex_input=complex_input)
        for name, r, g in zip(STATS_NAMES, row, got):
            assert torch.equal(r[0], g[1]), (Nf, name)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,n1,n2", [(80, 13, 7), (128, 13, 7),
                                     (37, 31, 15), (80, 3, 31)])
def test_denoise_stats_wide_path_equals_the_first_on_card(K, n1, n2,
                                                          monkeypatch):
    """The wide path forced onto shapes the first kernel takes (one chunk
    of K rounded up to 16 columns, walked 32 at a time; h1 + 2 h2 up to
    63; a ragged tile): the slow and aligned tracks, both powers and the
    guard are denoise_stats_kernel's bits.  pp is the wide kernel's own:
    the one-block wide kernel this path replaced contracted r_inc's
    products otherwise than the first kernel (its bits, which the path
    keeps, are held by chip_smoke.py's phase 20 and
    scripts/port_ab_steps.py), so pp is held to the first kernel within
    the bench shape's tolerance."""
    dev = _card()
    t1, t2 = tuple(tl0._hann_taps(n1)), tuple(tl0._hann_taps(n2))
    assert kernels._denoise_geometry(K, n1, n2)[0] == 0
    for complex_input in (False, True):
        ins = [np.stack(v) for v in zip(*(
            _stats_inputs(301, K, s, complex_input) for s in (1, 2)))]
        args = [T(v).to(dev) for v in ins]
        ref = kernels.denoise_stats(*args, t1, t2,
                                    complex_input=complex_input)
        kc = -(-K // 16) * 16
        monkeypatch.setattr(kernels, "_denoise_geometry",
                            lambda *a, kc=kc: (kc, 32, 0, 0))
        got = kernels.denoise_stats(*args, t1, t2,
                                    complex_input=complex_input)
        monkeypatch.undo()
        for name, g, r in zip(STATS_NAMES, got, ref):
            if name == "pp":
                torch.testing.assert_close(g, r, atol=2e-4, rtol=1e-3)
            else:
                assert torch.equal(g, r), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spectral,K", [(True, 160), (False, 160),
                                        (True, 203), (False, 129)])
def test_denoise_apply_wide_kernel_matches_plain_on_card(spectral, K):
    """denoise_apply past K = 128 (the wide kernel: each row pair staged
    once in a one-warp block's shared memory) and denoise_finish at the
    same K, against their twins within
    test_denoise_apply_kernel_matches_plain_on_card's tolerances."""
    dev = _card()
    args = [T(v).to(dev) for v in _apply_inputs(2, 301, K, 5)]
    polar = lambda ap: torch.polar(ap[0], ap[1])
    kernels.reset_launches()
    got = kernels.denoise_apply(*args, 8.0, spectral=spectral)
    ref = kernels.denoise_apply_ref(*args, 8.0, spectral=spectral)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["denoise_apply"] == 1
    if not spectral:
        torch.testing.assert_close(polar(got), polar(ref), atol=2e-4,
                                   rtol=1e-4)
        return
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-4, rtol=1e-4)
    delta = 0.1 * torch.randn((2, 301, K), dtype=torch.complex64, device=dev,
                              generator=torch.Generator(dev).manual_seed(K))
    fin = kernels.denoise_finish(got[0], delta, args[4], args[5])
    fin_ref = kernels.denoise_finish_ref(got[0], delta, args[4], args[5])
    torch.testing.assert_close(polar(fin), polar(fin_ref), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K", [600, 1500])
def test_denoise_apply_wide_staging_equals_device_reads_on_card(
        K, monkeypatch):
    """At full band's K 600 and at K 1500 the wide denoise_apply staged in
    shared memory (its default) equals, bit for bit and in both modes, the
    same kernel forced to read every slot from device memory (no staging:
    the reads of the kernel it replaced); past a block's shared memory (K
    5000) it reads from device memory, and a row alone equals its row of
    the batch there."""
    dev = _card()
    args = [T(v).to(dev) for v in _apply_inputs(2, 65, K, 11)]
    W, blocks, per, stage, _ = kernels._apply_geometry(K, 130)
    assert stage == 1
    for spectral in (True, False):
        staged = kernels.denoise_apply(*args, 8.0, spectral=spectral)
        geo = (4, -(-65 // (4 * per)), per, 0, 0)
        monkeypatch.setattr(kernels, "_apply_geometry",
                            lambda *a, geo=geo: geo)
        direct = kernels.denoise_apply(*args, 8.0, spectral=spectral)
        monkeypatch.undo()
        assert all(torch.equal(a, b) for a, b in zip(staged, direct))
    args = [T(v).to(dev) for v in _apply_inputs(2, 9, 5000, 12)]
    assert kernels._apply_geometry(5000, 18)[3] == 0
    got = kernels.denoise_apply(*args, 8.0, spectral=True)
    row = kernels.denoise_apply(*(a[1:] for a in args), 8.0, spectral=True)
    assert all(torch.equal(r[0], g[1]) for r, g in zip(row, got))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("spectral", [True, False])
def test_denoise_apply_wide_rows_alone_on_card(spectral):
    """The wide denoise_apply on an odd row count (the last pair's second
    row past the end), rows crossing utterances inside a warp's run (N
    odd), and a row alone equal to its row of the batch bit for bit."""
    dev = _card()
    args = [T(v).to(dev) for v in _apply_inputs(3, 77, 203, 9)]
    assert kernels._apply_geometry(203, 3 * 77)[0] > 0
    got = kernels.denoise_apply(*args, 8.0, spectral=spectral)
    ref = kernels.denoise_apply_ref(*args, 8.0, spectral=spectral)
    if spectral:
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, atol=2e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(torch.polar(*got), torch.polar(*ref),
                                   atol=2e-4, rtol=1e-4)
    row = kernels.denoise_apply(*(a[1:2] for a in args), 8.0,
                                spectral=spectral)
    assert all(torch.equal(r[0], g[1]) for r, g in zip(row, got))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K", [100, 127, 128])
def test_denoise_apply_wide_kernel_forced_onto_the_first_on_card(
        K, monkeypatch):
    """The wide denoise_apply forced onto shapes the first kernel takes
    (its scalar layout, NP4 = 0): one-warp blocks of 1 and 3 pairs a warp,
    two- and four-warp blocks, and no staging -- every forced launch gives
    the same bits, one launch counted each, within the bench shape's
    tolerance of the first kernel.  The wide kernel's own bits, which the
    one it replaced had (its products fused otherwise than the first
    kernel's, up to 3e-7 apart), are held bit for bit against that kernel
    by scripts/port_wide_bits.py what=apply."""
    dev = _card()
    args = [T(v).to(dev) for v in _apply_inputs(2, 301, K, 7)]
    assert kernels._apply_geometry(K, 602)[0] == 0
    odd16 = lambda n: (n + 15) // 32 * 32 + 16
    warp = 4 * (10 * odd16(K + 3) + 4 * odd16(K))
    for spectral in (True, False):
        first = kernels.denoise_apply(*args, 8.0, spectral=spectral)
        seen = None
        for W, per, stage in ((1, 1, 1), (1, 3, 1), (2, 2, 1), (4, 7, 1),
                              (4, 2, 0)):
            geo = (W, -(-301 // (W * per)), per, stage, stage * W * warp)
            monkeypatch.setattr(kernels, "_apply_geometry",
                                lambda *a, geo=geo: geo)
            n0 = kernels.LAUNCHES["denoise_apply"]
            got = kernels.denoise_apply(*args, 8.0, spectral=spectral)
            torch.cuda.synchronize()
            monkeypatch.undo()
            assert kernels.LAUNCHES["denoise_apply"] == n0 + 1
            if seen is None:
                seen = got
            assert all(torch.equal(g, s) for g, s in zip(got, seen)), geo
            for g, f in zip(got, first):
                torch.testing.assert_close(g, f, atol=2e-4, rtol=1e-4)


def _wide_noise_inputs(nhop, C, Ke, Nf, seed):
    """_noise_inputs at hop nhop with C bands of equal width up to fs / 2
    (fs = 100 nhop) and Ke envelope harmonics -> (tensors, bands)."""
    args, _, _ = _noise_inputs(nhop, False, seed, Nf=Nf, C=C, Ke=Ke)
    fs = 100.0 * nhop
    edges = tuple(fs / 2 * c / C for c in range(C)) + (fs / 2 + 1.0,)
    return args, kernels.band_ranges(nhop + 1, fs, edges)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop,C,Ke,Nf", [(480, 4, 4, 130), (80, 9, 9, 301),
                                          (480, 9, 9, 47), (882, 4, 12, 31),
                                          (481, 4, 4, 130), (480, 4, 4, 5),
                                          (2048, 4, 4, 9), (4000, 4, 4, 9),
                                          (4800, 4, 4, 19),
                                          (19200, 2, 4, 5)])
def test_noise_mod_ola_wide_kernel_matches_plain_on_card(nhop, C, Ke, Nf):
    """noise_mod_ola past the first kernel's nhop <= 256, C <= 8, Ke <= 8
    (48 kHz at a 10 ms hop: nhop 480; nine bands; nine and twelve envelope
    harmonics; 44.1 kHz at a 20 ms hop; an odd hop; 5 frames, fewer than a
    block's; hop 2048; 16 kHz at 250 ms, 48 kHz at 100 ms, 96 kHz at 200
    ms): the wide kernel, one launch, where its 16-frame block leaves room
    for two an SM, the long kernel elsewhere (hop 480 with 9 bands of 9
    harmonics, 882 and every longer hop), two launches counted once; each
    against the twin within 5e-5; the segment entry at the same C and Ke
    too."""
    dev = _card()
    args, bands = _wide_noise_inputs(nhop, C, Ke, Nf, nhop + C)
    geo = kernels._noise_geometry(nhop, C, Ke, bands)
    assert geo[0] > 0 and (geo[4] > 0) == (
        nhop > 481 or (nhop, C, Ke) == (480, 9, 9))
    ts = _noise_tensors(args, dev)
    kernels.reset_launches()
    got = kernels.noise_mod_ola(*ts, bands)
    ref = kernels.noise_mod_ola_ref(*ts, bands)
    segs = torch.randn((2, C, Nf, 2 * nhop), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(C))
    got_s = kernels.noise_mod_ola_seg(*ts[:5], segs)
    ref_s = kernels.noise_mod_ola_seg_ref(*ts[:5], segs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["noise_mod_ola"] == 1
    assert kernels.LAUNCHES["noise_mod_ola_seg"] == 1
    torch.testing.assert_close(got, ref, atol=5e-5, rtol=0)
    torch.testing.assert_close(got_s, ref_s, atol=5e-5, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("per_row", [False, True])
def test_noise_mod_ola_wide_kernel_equals_the_first_on_card(per_row,
                                                           monkeypatch):
    """The wide noise kernel forced onto a shape the first kernel takes
    (hop 80, 4 bands, 4 envelope harmonics, 301 frames: a ragged last
    block): 16 frames a block with 64, 32 (a thread looping over two
    sample pairs) or 96 threads -- every output the first kernel's bits,
    one launch counted each; a row alone under a forced geometry equals its
    row of the batch."""
    dev = _card()
    args, bands, _ = _noise_inputs(80, per_row, 17, Nf=301)
    ts = _noise_tensors(args, dev)
    assert kernels._noise_geometry(80, 4, 4, bands)[0] == 0
    ref = kernels.noise_mod_ola(*ts, bands)
    keep = kernels._noise_geometry
    for F, threads in ((16, 64), (16, 32), (16, 96)):
        geo = (F, *keep(80, 4, 4, bands)[1:3], threads, 0)
        monkeypatch.setattr(kernels, "_noise_geometry",
                            lambda *a, geo=geo: geo)
        n0 = kernels.LAUNCHES["noise_mod_ola"]
        got = kernels.noise_mod_ola(*ts, bands)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["noise_mod_ola"] == n0 + 1
        assert torch.equal(got, ref), geo
    row = kernels.noise_mod_ola(*(t[1:] for t in ts), bands)
    monkeypatch.undo()
    assert torch.equal(row[0], ref[1])


def _long_geometry(nhop, C, Ke, bands, F, LC):
    """noise_mod_ola's long kernel forced: F frames a block, LC slots a
    chunk (its shared bytes as _noise_geometry counts them)."""
    L = kernels._noise_geometry(nhop, C, Ke, bands)[1]
    return (F, L, 16 * LC * (F + 1) + 12 * (F - 1) * 4 * 128
            + 8 * F * C * (Ke + 1) + 20 * C, 128, LC)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nhop,C,Ke,Nf", [(480, 4, 4, 130), (481, 9, 9, 47),
                                          (960, 4, 4, 9)])
def test_noise_mod_ola_chunked_kernel_equals_the_wide_on_card(
        nhop, C, Ke, Nf, monkeypatch):
    """The long noise kernel (which replaced the chunked one) against the
    wide kernel forced to 16 frames a block (hop 480, 4 bands; an odd hop
    with 9 bands of 9 envelope harmonics; hop 960, whose 16-frame wide
    block fits one an SM): chunks of 64, 48, 16 and 32 slots, two launches
    counted once -- every output the wide kernel's bits; a row alone
    equals its batch row."""
    dev = _card()
    args, bands = _wide_noise_inputs(nhop, C, Ke, Nf, nhop + C)
    ts = _noise_tensors(args, dev)
    geo = kernels._noise_geometry(nhop, C, Ke, bands)
    wide = (16, geo[1], 0, min(256, -(-((nhop + 1) // 2) // 32) * 32), 0)
    monkeypatch.setattr(kernels, "_noise_geometry", lambda *a: wide)
    ref = kernels.noise_mod_ola(*ts, bands)
    monkeypatch.undo()
    for LC in (64, 48, 16, 32):
        g = _long_geometry(nhop, C, Ke, bands, 16, LC)
        monkeypatch.setattr(kernels, "_noise_geometry", lambda *a, g=g: g)
        n0 = kernels.LAUNCHES["noise_mod_ola"]
        got = kernels.noise_mod_ola(*ts, bands)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["noise_mod_ola"] == n0 + 1
        assert torch.equal(got, ref), g
        row = kernels.noise_mod_ola(*(t[1:] for t in ts), bands)
        monkeypatch.undo()
        assert torch.equal(row[0], ref[1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("nhop,lim,Nf", [(480, 481, 130), (960, 961, 41),
                                         (2400, 800, 23)])
def test_noise_mod_ola_long_kernel_gives_the_wide_kernels_bits_on_card(
        nhop, lim, Nf, per_row, monkeypatch):
    """The long noise kernel on the shapes the wide kernel took at 16, 8
    and 4 frames a block (hops 480, 960 and 2400; 4 bands of the default
    channel edges at fs = 200 nhop, cut at bin `lim` at hop 2400 so that
    the wide kernel's 16-frame block fits for the comparison), one draw for
    the batch and a draw a row: its routed geometry and chunks of 64, 48
    and 32 slots give the wide kernel's bits at 16 frames, and a row alone
    equals its row of the batch."""
    dev = _card()
    args, bands, _ = _noise_inputs(nhop, per_row, nhop + 27, B=3, Nf=Nf)
    bands = tuple(min(v, lim) for v in bands)
    ts = _noise_tensors(args, dev)
    geo = kernels._noise_geometry(nhop, 4, 4, bands)
    assert (geo[4] > 0) == (nhop > 480)
    wide = (16, geo[1], 0, min(256, -(-((nhop + 1) // 2) // 32) * 32), 0)
    monkeypatch.setattr(kernels, "_noise_geometry", lambda *a: wide)
    ref = kernels.noise_mod_ola(*ts, bands)
    monkeypatch.undo()
    for g in (geo if geo[4] else None,
              _long_geometry(nhop, 4, 4, bands, 16, 64),
              _long_geometry(nhop, 4, 4, bands, 16, 48),
              _long_geometry(nhop, 4, 4, bands, 16, 32)):
        if g is None:
            continue
        monkeypatch.setattr(kernels, "_noise_geometry", lambda *a, g=g: g)
        got = kernels.noise_mod_ola(*ts, bands)
        row = kernels.noise_mod_ola(*(t[2:] for t in ts), bands)
        monkeypatch.undo()
        assert torch.equal(got, ref), g
        assert torch.equal(row[0], got[2]), g


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S,N,renorm", [(257, 3200, True), (512, 400, False),
                                        (1025, 200, True), (2049, 60, True),
                                        (2049, 2, False), (4097, 60, False),
                                        (8193, 20, True), (29024, 3, True)])
def test_viterbi_wide_kernel_matches_plain_on_card(S, N, renorm):
    """viterbi_scan past 256 states (uint16 backpointers in device memory:
    the grid kernel to 2048 states, at 3200 frames too; past it the stream
    kernel, lt's columns and the scores through shared memory in chunks,
    at 2 frames, 8193 states and the most, 29024, on 3 frames) against its
    twin, paths and last scores bit for bit, on scores in eighths with
    -inf entries."""
    dev = _card()
    rng = np.random.default_rng(S)
    obs = np.round(rng.uniform(-12.0, 0.0, (2, N, S)) * 8.0) / 8.0
    obs[rng.uniform(size=obs.shape) < 0.1] = -np.inf
    obs[..., 0] = -1.0
    lt = np.round(rng.uniform(-4.0, 0.0, (S, S)) * 8.0) / 8.0
    obs, lt = T(obs.astype(np.float32)), T(lt.astype(np.float32))
    kernels.reset_launches()
    got = kernels.viterbi_scan(obs.to(dev), lt.to(dev), renorm, scores=True)
    ref = kernels.viterbi_scan_ref(obs, lt, renorm, scores=True)
    assert kernels.LAUNCHES["viterbi_scan"] == 1
    assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))


@pytest.mark.requires_cuda
def test_refine_f0_full_past_the_128_frame_block_on_card():
    """44.1 kHz at a 10 ms hop (hop 441, f0_floor 40: H = 2205): 128 frames
    a block would overflow shared memory, so _refine_geometry takes 8
    frames of 16 lanes; refine_f0_full on 64 rows of 2 s against its twin
    within 1e-4 relative, voicing equal, one launch."""
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    utt = testsig.make_test_utterances(
        [(i, 0.05 * (i % 2)) for i in range(64)], duration=2.0, fs=44100.0,
        thop=0.01)
    x, f0 = (torch.tensor(np.stack([u[j] for u in utt]), dtype=torch.float32,
                          device=dev) for j in range(2))
    kw = dict(nhop=441, fs=44100.0, halfwin_max=2205, rel_winsize=4.0,
              window="hanning", iters=2, max_rel_dev=0.05)
    dm = kernels._refine_full_dims(441, 44100.0, 2205)
    assert kernels._refine_geometry(64, f0.shape[1], 1, 0, dm)["G"] == 16
    n0 = kernels.LAUNCHES["refine_f0_full"]
    got = kernels.refine_f0_full(x, f0, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refine_f0_full"] == n0 + 1
    assert _f0_rel(got, kernels.refine_f0_full_ref(x, f0, **kw)) <= 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("S,renorm", [(257, True), (385, True),
                                      (512, False), (1025, True)])
@pytest.mark.parametrize("B,N", [(1, 400), (64, 100), (1, 3200)])
def test_viterbi_grid_kernel_matches_plain_on_card(S, renorm, B, N):
    """The grid kernel (lt mode 4: one cooperative launch, 16 destination
    states a block, its grid from _viterbi_grid) against the twin on the
    card, paths and last scores bit for bit, on the tracker's transitions
    at S = nbins + 1 and scores in eighths with -inf entries and tied
    frames: a row alone, 64 rows (one pass of 2 or 4 row warps) and a
    3200-frame row; rows 0 and B - 1 of the batch alone equal their rows."""
    from libllsm2_tpu_torch.ops import f0 as tf0
    dev = _card()
    obs, _ = _viterbi_inf_inputs(B, N, S, renorm, S + N + B)
    lt = tf0._tables(tf0.F0Config(nbins=S - 1), dev)["lt"]
    obs = obs.to(dev)
    assert kernels._viterbi_geometry(N, S)[3] == 4
    n0 = kernels.LAUNCHES["viterbi_scan"]
    path, score = kernels.viterbi_scan(obs, lt, renorm, scores=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["viterbi_scan"] == n0 + 1
    ref_path, ref_score = kernels.viterbi_scan_ref(obs, lt, renorm,
                                                   scores=True)
    assert torch.equal(path, ref_path) and torch.equal(score, ref_score)
    for r in {0, B - 1}:
        p, s = kernels.viterbi_scan(obs[r:r + 1], lt, renorm, scores=True)
        assert torch.equal(p[0], path[r]) and torch.equal(s[0], score[r])


def _snr_db(ref, y):
    """SNR of y against ref over 10-90 % of the signal."""
    lo, hi = int(0.1 * ref.shape[-1]), int(0.9 * ref.shape[-1])
    e = (ref[lo:hi] - y[lo:hi]).double()
    return float(10.0 * torch.log10(torch.sum(ref[lo:hi].double() ** 2)
                                    / torch.sum(e ** 2).clamp(min=1e-20)))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fs,thop", LONG_HOP_GRID)
def test_analysis_and_synthesis_at_every_hop_on_card(fs, thop):
    """analyze -> synthesize with the kernels on (use_pallas=True, both
    noise_idft values; the main pass by the windowed projection and, with
    hm_kernel="matmul", by the unframed one) at every hop of
    LONG_HOP_GRID, the default ChunkConf at that rate, on a noisy and a
    clean 2 s row: nothing raises, the projection, cycle track and noise
    kernels launch, every output is finite; against the same path on the
    CPU (the kernels' plain twins; its noise by noise_idft="fft", whose
    twin stays small at hop 19200): f0 within 1e-4 relative (the refine's
    tolerance) and each row's y_sin SNR against its clean harmonic part
    within 0.05 dB."""
    import dataclasses
    from libllsm2_tpu_torch import create_aoptions, create_soptions
    from libllsm2_tpu_torch.utils import testsig
    dev = _card()
    rows = testsig.make_test_utterances([(0, 0.05), (1, 0.0)], duration=2.0,
                                        fs=fs, thop=thop)
    x, f0, x_harm = (torch.tensor(np.stack([r[j] for r in rows]),
                                  dtype=torch.float32, device=dev)
                     for j in range(3))
    snr = lambda y: [_snr_db(x_harm[r].to(y.device), y[r]) for r in range(2)]
    for hm, proj in (("rotation", "harmonic_project_win"),
                     ("matmul", "harmonic_project_mxu")):
        opt = create_aoptions(fs=fs, thop=thop, use_pallas=True,
                              hm_kernel=hm)
        assert opt.conf.nhop == round(fs * thop)
        kernels.reset_launches()
        chunk = tl0._analyze(opt, x, f0)
        torch.cuda.synchronize()
        n = dict(kernels.LAUNCHES)
        assert n[proj] >= 1 and n["harmonic_project_win"] >= 1 \
            and n["sample_cycles"] == 1, n
        cpu = tl0._analyze(opt, x.cpu(), f0.cpu())
        ref = snr(tl0._synthesize(dataclasses.replace(
            create_soptions(fs=fs), use_pallas=True, noise_idft="fft"),
            cpu).y_sin)
        torch.testing.assert_close(chunk.f0.cpu(), cpu.f0, rtol=1e-4, atol=0)
        for idft, name in (("matmul", "noise_mod_ola"),
                           ("fft", "noise_mod_ola_seg")):
            sopt = dataclasses.replace(create_soptions(fs=fs),
                                       use_pallas=True, noise_idft=idft)
            kernels.reset_launches()
            out = tl0._synthesize(sopt, chunk)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[name] == 1 \
                and kernels.LAUNCHES["sample_cycles"] == 1, kernels.LAUNCHES
            assert out.y.shape == x.shape \
                and bool(torch.isfinite(out.y).all())
            got = snr(out.y_sin)
            assert all(abs(g - r) <= 0.05 for g, r in zip(got, ref)), \
                (hm, idft, got, ref)
