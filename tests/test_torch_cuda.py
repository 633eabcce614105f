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
    a = torch.rand(2, N, 80, device=dev)
    cyc_c, hw = torch.rand(2, N, device=dev), 30 + 400 * torch.rand(2, N, device=dev)
    ang = 6.3 * torch.rand(2, N, 20, device=dev)
    d_args = (a, 6 * a - 3, cyc_c, hw, torch.cos(ang), torch.sin(ang), 7, 80, 8)
    for g, r in zip(kernels.deconv_full(*d_args), kernels.deconv_full_ref(*d_args)):
        torch.testing.assert_close(g, r, atol=5e-4, rtol=0)
    e = torch.rand(2, N, 4, device=dev)
    n_args = (torch.rand(2, N * 80, device=dev), e, 0.3 * torch.rand(2, N, 4, 4, device=dev),
              0.3 * torch.rand(2, N, 4, 4, device=dev), e + 0.5,
              torch.randn(2, 4, N, 160, device=dev))
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
@pytest.mark.parametrize("emit_resid", [False, True])
def test_denoise_apply_kernel_matches_plain_on_card(emit_resid):
    dev = _card()
    args = [T(v).to(dev) for v in _apply_inputs(2, 1600, 80, 3)]
    kernels.reset_launches()
    got = kernels.denoise_apply(*args, 8.0, emit_resid=emit_resid)
    ref = kernels.denoise_apply_ref(*args, 8.0, emit_resid=emit_resid)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["denoise_apply"] == 1
    assert len(got) == (6 if emit_resid else 2)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-4, rtol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,nhop,W,rep", [(80, 80, 960, 1), (4, 20, 240, 4)])
def test_harmonic_project_win_kernel_matches_plain_on_card(K, nhop, W, rep):
    """The main pass (K = 80, hop 80, W = 960) and the envelope pass (K = 4,
    hop 20, W = 240, four x rows on each cycle row) on 3 utterances of 301
    frames: a ragged last 16-frame tile, and the first and last frames
    reaching past both ends (zero x, edge cyc).  re/im/xsum within 2e-3,
    wsum 1e-5 relative (test_pallas.py's), slots at or above kl exact
    zeros, and each utterance's rows equal to the kernel on it alone."""
    dev = _card()
    x, cyc, hw, lo, hi, C = (T(a).to(dev) if isinstance(a, np.ndarray) else a
                             for a in _win_inputs(nhop, W, K, B=3 * rep,
                                                  Nf=301))
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
@pytest.mark.parametrize("K", [1, 4, 80])
def test_harmonic_project_kernel_matches_plain_on_card(K):
    """K = 1 (the refine probe: one warp per row), K = 4 (the same kernel
    rotating) and K = 80 (one block per row), with each row's live columns
    [lo, hi); 2e-3 absolute (test_pallas.py:46)."""
    dev = _card()
    rng = np.random.default_rng(K)
    W = 631
    dc = rng.uniform(-2, 2, (N, W)).astype(np.float32)
    lo = rng.integers(0, W // 3, N).astype(np.int32)
    hi = (lo + rng.integers(1, W - lo)).astype(np.int32)
    col = np.arange(W)[None, :]
    xw = np.where((col >= lo[:, None]) & (col < hi[:, None]),
                  rng.standard_normal((N, W)), 0.0).astype(np.float32)
    args = [T(a).to(dev) for a in (dc, xw)]
    lo, hi = T(lo).to(dev), T(hi).to(dev)
    kernels.reset_launches()
    got = kernels.harmonic_project(*args, K, lo, hi)
    ref = kernels.harmonic_project_ref(*args, K, lo, hi)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["harmonic_project"] == 1
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=2e-3, rtol=0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,nhop,H", [(80, 80, 458), (4, 20, 115)])
def test_harmonic_project_mxu_kernel_matches_plain_on_card(K, nhop, H):
    """A batch of 3 utterances of 301 frames (not a multiple of the 16-frame
    tile), main-pass and envelope-pass widths: kernel against twin within
    2e-3 x the twin's largest |re + j im| (raw window sums scale with the
    window), and each utterance's rows equal to the kernel on that
    utterance alone -- no frame's window reads its neighbour."""
    dev = _card()
    x, cyc, hw = (T(a).to(dev) for a in _mxu_inputs(3, 301, nhop, H, K))
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
    for g, r in zip(got[2:], ref[2:]):
        torch.testing.assert_close(g, r, atol=2e-3 * float(r.abs().max()),
                                   rtol=0)
    for b in range(3):
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
def test_layer1_and_pbp_on_card_match_cpu():
    """A 0.5 s LF utterance analyzed on the CPU, then layer 1 and PbP on
    the card against the same calls on the CPU: rd within 1e-3 relative
    (an in-model source, where the Rd score has a clear peak), the
    regenerated harmonics within 1e-4 x scale, PbP y_sin within 1e-3 x
    peak (index_add_ on the card adds in no fixed order), and the noise
    part through noise_mod_ola."""
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
    torch.testing.assert_close(y_dev.y_sin.cpu(), y_cpu.y_sin,
                               atol=1e-3 * peak, rtol=0)
