"""The plain PyTorch versions of the port's CUDA kernels against the JAX
package's Pallas kernels (interpret mode on the CPU), on identical
numpy inputs, and the CPU dispatch; test_torch_cuda.py holds each kernel
against its plain version on a CUDA card.  Tolerances are
test_pallas.py's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libllsm2_tpu.ops import harmonics as jhm
from libllsm2_tpu.ops import pallas_osc

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.ops import _build, kernels
from libllsm2_tpu_torch.ops import harmonics as thm

torch.set_num_threads(1)

from test_torch_cuda import (N, T, _deconv_inputs, _noise_inputs,
                             _noise_tensors, _render_inputs, _win_inputs)


def _frames_np(x, cyc, Nf, nhop, C):
    """harmonic_project_win's frames built in numpy from x [B, nx] and cyc
    [B, nx]: (frames, dc) [B Nf, 2C] at centers n*nhop, x zero and cyc
    edge-clamped outside [0, nx), dc the float32 offset from the center
    sample."""
    B, nx = x.shape
    s = np.arange(Nf)[:, None] * nhop - C + np.arange(2 * C)[None, :]
    sc = np.clip(s, 0, nx - 1)
    fr = np.where((s >= 0) & (s < nx), x[:, sc], np.float32(0))
    dc = cyc[:, sc] - cyc[:, np.arange(Nf) * nhop][..., None]
    return fr.reshape(B * Nf, -1), dc.reshape(B * Nf, -1)


@pytest.mark.parametrize("K,notch,resid", [
    (24, False, False), (80, False, False), (80, True, False),
    (80, True, True), (24, False, True)])
def test_osc_bank_plain_matches_pallas(K, notch, resid):
    """osc_bank's twin (render and residual) against the JAX package's
    oscillator_bank(use_pallas=True) + overlap_add_half per utterance, 2e-4
    (test_pallas.py's): two utterances of different F0, a notched mask."""
    cyc, ampl, phse, mask, x = _render_inputs(K, notch, Nf=151)
    B, Nf, _ = ampl.shape
    nhop = 80
    got = kernels.osc_bank(*map(T, (cyc, ampl, phse, mask)), nhop,
                           T(x) if resid else None)
    assert got.shape == (B, Nf * nhop)
    centers = jnp.arange(Nf, dtype=jnp.int32) * nhop
    for b in range(B):
        segs = jhm.oscillator_bank(
            jnp.asarray(cyc[b]), centers,
            *(jnp.asarray(a[b]) for a in (ampl, phse, mask)), nhop=nhop,
            use_pallas=True)
        ref = np.asarray(jhm.overlap_add_half(segs, nhop, Nf * nhop))
        np.testing.assert_allclose(got[b].numpy(), x[b] - ref if resid else ref,
                                   atol=2e-4)


@pytest.mark.parametrize("K,nhop,W,skip", [
    (24, 80, 960, True), (80, 80, 960, True), (80, 80, 960, False),
    (4, 20, 240, False)])
def test_harmonic_project_win_plain_matches_pallas(K, nhop, W, skip):
    """Main-pass (hop 80, Wf = 960) and envelope-pass (hop 20, Wf = 240,
    K = 4) geometries on two utterances of different F0: the twin framing
    x and cyc itself against the Pallas kernel fed frames built in numpy,
    every frame, the first and last hh (zero and edge padding) included.
    With a skipping kl the Pallas kernel computes every slot below its
    128-frame block's maximum, the port below each frame's own kl: the two
    agree on the live slots, and the port's dead slots are exact zeros."""
    x, cyc, hw, lo, hi, C = _win_inputs(nhop, W, K + W)
    B, Nf = hw.shape
    rng = np.random.default_rng(5)
    kl = (rng.integers(0, K, (B, Nf)) if skip else np.full((B, Nf), K)
          ).astype(np.int32)
    fr, dc = _frames_np(x, cyc, Nf, nhop, C)
    re_j, im_j, ws_j, xs_j = map(np.asarray, pallas_osc.harmonic_project_win_pallas(
        *map(jnp.asarray, (dc, fr, hw.reshape(-1))), K,
        lo=jnp.asarray(lo.reshape(-1)), hi=jnp.asarray(hi.reshape(-1)),
        center=C, kl=jnp.asarray(kl.reshape(-1))))
    got = kernels.harmonic_project_win(*map(T, (x, cyc, hw)), K, T(lo),
                                       T(hi), nhop=nhop, center=C, kl=T(kl))
    re, im = (v.numpy().reshape(-1, K) for v in got[:2])
    ws, xs = (v.numpy().reshape(-1) for v in got[2:])
    kl = kl.reshape(-1)
    live = np.arange(K)[None, :] < kl[:, None]
    if skip:
        assert not live.all()
    np.testing.assert_allclose(np.where(live, re, 0), np.where(live, re_j, 0),
                               atol=2e-3)
    np.testing.assert_allclose(np.where(live, im, 0), np.where(live, im_j, 0),
                               atol=2e-3)
    assert not re[~live].any() and not im[~live].any()
    np.testing.assert_allclose(ws, ws_j, rtol=1e-5)
    np.testing.assert_allclose(xs, xs_j, atol=2e-3)


def test_harmonic_project_win_row_map():
    """The envelope pass's layout: x row b*Cn + c (channel c of utterance
    b) reads cyc row b.  The twin on 2 x Cn = 8 x rows with 2 cycle rows
    matches the Pallas kernel on frames built with each row's own track,
    and harmonic_analysis with the shared rows equals it with the rows
    repeated."""
    K, nhop, W, Cn = 4, 20, 240, 4
    x, cyc, hw, lo, hi, C = _win_inputs(nhop, W, 7, B=2 * Cn, Nf=60)
    cyc = cyc[::Cn]
    B, Nf = hw.shape
    cyc_rep = np.repeat(cyc, Cn, axis=0)
    fr, dc = _frames_np(x, cyc_rep, Nf, nhop, C)
    ref = pallas_osc.harmonic_project_win_pallas(
        *map(jnp.asarray, (dc, fr, hw.reshape(-1))), K,
        lo=jnp.asarray(lo.reshape(-1)), hi=jnp.asarray(hi.reshape(-1)),
        center=C)
    got = kernels.harmonic_project_win(*map(T, (x, cyc, hw)), K, T(lo),
                                       T(hi), nhop=nhop, center=C)
    for g, r, tol in zip(got, ref, (2e-3, 2e-3, 0, 2e-3)):
        np.testing.assert_allclose(g.numpy().reshape(np.shape(r)),
                                   np.asarray(r), atol=tol,
                                   rtol=1e-5 if tol == 0 else 0)
    f0 = np.tile(np.linspace(90.0, 220.0, Nf, dtype=np.float32), (B, 1))
    f0[:, :6] = 0.0
    kw = dict(nhop=nhop, fs=4000.0, max_k=K, halfwin_max=115, rel_winsize=4.0,
              fnyq=1600.0, with_dc=True)
    shared = thm.harmonic_analysis(T(x), T(f0), T(cyc), **kw)
    repeated = thm.harmonic_analysis(T(x), T(f0), T(cyc_rep), **kw)
    for a, b in zip(shared, repeated):
        assert torch.equal(a, b)


@pytest.mark.parametrize("envelope", [False, True])
def test_harmonic_analysis_matches(envelope):
    """The module around the projection kernel: the main pass (K = 24)
    and the envelope pass (K = 4 with the windowed DC, at fs/4), on a
    batch of two utterances with unvoiced frames."""
    from libllsm2_tpu.utils import testsig
    rows = [testsig.make_test_utterance(duration=0.5, seed=s, noise_level=nl,
                                        unvoiced_tail_frac=0.2)
            for s, nl in ((0, 0.0), (1, 0.05))]
    fs, nhop, H, K, fnyq = 16000.0, 80, 356, 24, 6000.0
    if envelope:
        fs, nhop, H, K, fnyq = 4000.0, 20, 89, 4, 1600.0
    nfrm = len(rows[0][1])
    nx = nfrm * nhop
    x = np.stack([np.abs(r[0][:nx]) for r in rows]).astype(np.float32)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    kw = dict(fs=fs, max_k=K, halfwin_max=H, rel_winsize=4.0, fnyq=fnyq,
              with_dc=envelope)
    cyc = thm.sample_cycles(T(f0), nhop, fs, nx)
    got = thm.harmonic_analysis(T(x), T(f0), cyc, nhop=nhop, **kw)
    centers = jnp.arange(nfrm, dtype=jnp.int32) * nhop
    for b in range(2):
        ref = jhm.harmonic_analysis(jnp.asarray(x[b]), jnp.asarray(f0[b]),
                                    centers, jnp.asarray(cyc[b].numpy()),
                                    use_pallas=True, nhop=nhop, **kw)
        a_j, p_j, m_j = map(np.asarray, ref[:3])
        a, p, m = (v[b].numpy() for v in got[:3])
        scale = np.abs(a_j).max()
        np.testing.assert_array_equal(m, m_j)
        np.testing.assert_allclose(a, a_j, atol=1e-3 * scale)
        np.testing.assert_allclose(a * np.exp(1j * p), a_j * np.exp(1j * p_j),
                                   atol=1e-3 * scale)
        if envelope:
            np.testing.assert_allclose(got[3][b].numpy(), np.asarray(ref[3]),
                                       atol=1e-5 * np.abs(x).max())


def _jax_eq(cyc, Nf, nhop, stride):
    """The JAX caller's quadrature field of one utterance's cycle track
    (layer0.py:229-233): e^{2 pi j cyc} at frame_hops(mode="edge")'s
    stride points -> (cos, sin) [Nf, nq]."""
    nq = 2 * nhop // stride
    C2 = jhm.frame_hops(jnp.asarray(cyc), Nf, nhop, 1, mode="edge")
    ang = 2.0 * jnp.pi * C2[:, stride // 2::stride][:, :nq]
    return jnp.cos(ang), jnp.sin(ang)


@pytest.mark.parametrize("nhop,polar", [(80, False), (80, True),
                                        (55, False)])
def test_deconv_full_plain_matches_pallas(nhop, polar):
    """D = 7 (halfwin_max 458 at an 80-sample hop), two utterances with
    unvoiced (zero) frames at both ends of each: the plain version's frame
    shifts must stay inside each utterance.  JAX's quadrature field comes
    from frame_hops(..., "edge") of the same cycle track, as its caller
    makes it; the mask after; polar: (|c|, angle c) compared as |c| e^{j
    angle c}, as the JAX caller's sqrt / arctan2."""
    D, stride = 7, 8
    ampl, phse, cyc, hw, mask = _deconv_inputs(nhop, 9 + nhop)
    B, Nf, K = ampl.shape
    got = kernels.deconv_full(*map(T, (ampl, phse, cyc, hw, mask)), D, nhop,
                              stride, return_complex=not polar)
    z = (got[0].numpy() * np.exp(1j * got[1].numpy()) if polar
         else got[0].numpy() + 1j * got[1].numpy())
    for b in range(B):
        rj, ij = pallas_osc.deconv_full_pallas(
            *(jnp.asarray(a[b]) for a in (ampl, phse)),
            jnp.asarray(cyc[b, ::nhop]), jnp.asarray(hw[b]),
            *_jax_eq(cyc[b], Nf, nhop, stride), D, nhop, stride)
        zj = (np.asarray(rj) + 1j * np.asarray(ij)) * mask[b]
        if polar:
            zj = np.abs(zj) * np.exp(1j * np.angle(zj))
        np.testing.assert_allclose(z[b], zj, atol=5e-4)


def _jax_noise(args, band_edges, fs, b):
    """Utterance b's noise part through the JAX package: its shaped
    spectrum and band masks (layer0._synth_noise), _band_segments' matmul
    branch and noise_mod_ola_pallas, in interpret mode."""
    from libllsm2_tpu.models import layer0 as jl0
    cyc, edc, ar, ai, base, re, im, gain = (np.asarray(a[b]) for a in args)
    nbin = gain.shape[-1]
    Tn = 2 * (nbin - 1)
    w = jnp.sqrt(0.5 - 0.5 * jnp.cos(2.0 * jnp.pi * (jnp.arange(Tn) + 0.5)
                                      / Tn)).astype(jnp.float32)
    im = im.copy()
    im[:, 0] = im[:, -1] = 0.0
    scale = np.full((nbin,), np.sqrt(Tn / 2.0))
    scale[0] = scale[-1] = np.sqrt(float(Tn))
    spec = (jnp.asarray(re) + 1j * jnp.asarray(im)) * jnp.asarray(scale)
    f = jnp.arange(nbin) * fs / Tn
    masks = jnp.stack([((f >= band_edges[c]) & (f < band_edges[c + 1]))
                       .astype(jnp.float32)
                       for c in range(len(band_edges) - 1)])
    segs = jl0._band_segments(spec * jnp.asarray(gain), masks, w, Tn,
                              "matmul")
    return np.asarray(pallas_osc.noise_mod_ola_pallas(
        *(jnp.asarray(a) for a in (cyc, edc, ar, ai, base)), segs))


@pytest.mark.parametrize("nhop,per_row,cut", [
    (80, False, None),       # one draw expanded to the batch (stride 0)
    (80, True, None),        # injected [B, N, nbin] bins, a draw a row
    (55, False, None),       # 11 kHz: an empty band, the Nyquist bin in one
    (80, False, (17, 40))])  # a frame_base-style slice of frames [17, 57)
def test_noise_mod_ola_plain_matches_pallas(nhop, per_row, cut):
    """The noise part from its spectra (band iDFT, OLA, modulation, band
    sum) against the JAX package's _band_segments + noise_mod_ola_pallas
    of the same spectra, 5e-5 absolute (test_pallas.py's); a slice of the
    frames renders on its own."""
    from libllsm2_tpu_torch.config import ChunkConf
    args, bands, fs = _noise_inputs(nhop, per_row, 13 + nhop)
    if cut:
        i0, n = cut
        args = tuple(a[:, i0 * nhop:(i0 + n) * nhop] if j == 0
                     else a[:, i0:i0 + n] for j, a in enumerate(args))
    got = kernels.noise_mod_ola(*_noise_tensors(args), bands)
    edges = ChunkConf(fs=fs).chan_edges
    for b in range(2):
        np.testing.assert_allclose(got[b].numpy(),
                                   _jax_noise(args, edges, fs, b), atol=5e-5)


@pytest.mark.parametrize("B,N,C,ntaps,cplx", [
    (1, 137, 30, 7, False),        # test_pallas.py's case
    (3, 300, 80, 13, False),       # ragged blocks, the denoiser's 13 taps
    (2, 150, 24, 31, True),        # a complex track, 31 taps
    (2, 9, 5, 31, False)])         # taps longer than the utterance
def test_fir_frames_plain_matches_pallas(B, N, C, ntaps, cplx):
    """fir_frames' twin against fir_frames_pallas per utterance (complex
    tracks as their (re, im) columns), edge rows included: 1e-6 absolute
    (test_pallas.py:505)."""
    rng = np.random.default_rng(N + ntaps)
    v = rng.standard_normal((B, N, C, 2) if cplx else (B, N, C)).astype(
        np.float32)
    taps = np.hanning(ntaps + 2)[1:-1]
    taps = tuple(taps / taps.sum())
    tv = torch.view_as_complex(T(v)) if cplx else T(v)
    got = kernels.fir_frames(tv, taps)
    got = torch.view_as_real(got) if cplx else got
    assert got.shape == v.shape
    for b in range(B):
        ref = pallas_osc.fir_frames_pallas(jnp.asarray(v[b].reshape(N, -1)),
                                           taps)
        np.testing.assert_allclose(got[b].numpy().reshape(N, -1),
                                   np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("shapes,ntaps", [
    (((2, 200, 80), (2, 200, 80)), 3),      # the spectral gate's pair (D = 4)
    (((2, 150, 1), (2, 150, 24, 2)), 7)])   # track lowpass: voicing, complex
def test_fir_frames_pair_plain_matches_pallas(shapes, ntaps):
    """A pair through fir_frames gives a pair, each output against
    fir_frames_pallas per utterance within 1e-6 (test_pallas.py:505)."""
    rng = np.random.default_rng(ntaps)
    vs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    taps = tuple(np.hanning(ntaps + 2)[1:-1] / np.hanning(ntaps + 2).sum())
    tv = tuple(torch.view_as_complex(T(v)) if v.ndim == 4 else T(v)
               for v in vs)
    got = kernels.fir_frames(tv, taps)
    assert isinstance(got, tuple) and len(got) == 2
    for v, g in zip(vs, got):
        g = torch.view_as_real(g) if g.is_complex() else g
        assert g.shape == v.shape
        for b in range(v.shape[0]):
            ref = pallas_osc.fir_frames_pallas(
                jnp.asarray(v[b].reshape(v.shape[1], -1)), taps)
            np.testing.assert_allclose(g[b].numpy().reshape(v.shape[1], -1),
                                       np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("nfrm,cut", [(37, 0), (160, 0), (37, 45)])
def test_env_render_plain_matches_pallas(nfrm, cut):
    """_render_envelopes(use_pallas=True) on the CPU (the kernel's twin)
    against the JAX Pallas render, on a batch of two chunks with an
    unvoiced run, as test_pallas.py:231: env 2e-5, base 2e-6 absolute.
    With a render `cut` samples short of N*nhop the JAX package takes its
    plain render and the port the same wrapper.  Then the jnp branch
    (use_pallas=False) of both packages, alike."""
    from libllsm2_tpu import ChunkConf, create_chunk
    from libllsm2_tpu.models import layer0 as jl0
    from libllsm2_tpu_torch.container import chunk_from_numpy
    from libllsm2_tpu_torch.models import layer0 as tl0
    conf = ChunkConf()
    nhop, C, Ke = conf.nhop, conf.nchannel, conf.maxnhar_e
    rows = []
    for seed in (11, 12):
        rng = np.random.default_rng(seed)
        f0 = rng.uniform(100, 300, nfrm).astype(np.float32)
        f0[5:8] = 0.0
        rows.append(dict(
            f0=f0, edc=rng.uniform(0, 1, (nfrm, C)).astype(np.float32),
            eenv_a=rng.uniform(0, 0.5, (nfrm, C, Ke)).astype(np.float32),
            eenv_p=rng.uniform(-3, 3, (nfrm, C, Ke)).astype(np.float32)))
    nx = nfrm * nhop - cut
    d = {f: np.stack([np.asarray(getattr(create_chunk(conf, nfrm), f))] * 2)
         for f in ("ampl", "phse", "hm_mask", "psd")}
    d.update({f: np.stack([r[f] for r in rows]) for f in rows[0]})
    tch = chunk_from_numpy(d, tpkg.ChunkConf(), device="cpu")
    cyc = thm.sample_cycles(tch.f0, nhop, conf.fs, nfrm * nhop)[:, :nx]
    env, base = tl0._render_envelopes(tch, cyc, nhop, use_pallas=True)
    assert env.shape == base.shape == (2, C, nx)
    centers = jnp.arange(nfrm, dtype=jnp.int32) * nhop
    for b in range(2):
        jch = dataclasses.replace(create_chunk(conf, nfrm), **{
            f: jnp.asarray(v) for f, v in rows[b].items()})
        env_j, base_j = jl0._render_envelopes(
            jch, jnp.asarray(cyc[b].numpy()), centers, nx, nhop,
            use_pallas=True)
        np.testing.assert_allclose(env[b].numpy(), np.asarray(env_j),
                                   atol=2e-5)
        np.testing.assert_allclose(base[b].numpy(), np.asarray(base_j),
                                   atol=2e-6)
    # the jnp branch (use_pallas=False) against the JAX package's, alike
    env, base = tl0._render_envelopes(tch, cyc, nhop)
    for b in range(2):
        jch = dataclasses.replace(create_chunk(conf, nfrm), **{
            f: jnp.asarray(v) for f, v in rows[b].items()})
        env_j, base_j = jl0._render_envelopes(
            jch, jnp.asarray(cyc[b].numpy()), centers, nx, nhop)
        np.testing.assert_allclose(env[b].numpy(), np.asarray(env_j),
                                   atol=2e-5)
        np.testing.assert_allclose(base[b].numpy(), np.asarray(base_j),
                                   atol=2e-6)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def no_build():
        raise AssertionError("CPU call reached the CUDA build")
    monkeypatch.setattr(_build, "library", no_build)
    kernels.reset_launches()
    cyc, ampl, phse, mask, x = _render_inputs(24, False, Nf=20)
    kernels.osc_bank(*map(T, (cyc, ampl, phse, mask)), 80, T(x))
    kernels.noise_bins(0, 5, 2, 20, 81, "cpu")
    x, cyc, hw, lo, hi, C = _win_inputs(20, 240, 1, Nf=20)
    kernels.harmonic_project_win(*map(T, (x, cyc, hw)), 4, T(lo), T(hi),
                                 nhop=20, center=C)
    a = torch.rand(1, 40, 8)
    kernels.deconv_full(a, a, torch.rand(1, 40 * 8), a[..., 0] + 30, a, 2, 8,
                        4)
    kernels.noise_mod_ola(torch.rand(1, 40 * 8), a[..., :2], a[..., :2, None],
                          a[..., :2, None], a[..., :2] + 1,
                          *torch.rand(3, 1, 40, 9), (0, 3, 3, 8))
    kernels.sample_cycles(a[..., 0] * 200, 8, 1600.0, 40 * 8)
    kernels.fir_frames(a, (0.25, 0.5, 0.25))
    kernels.fir_frames((a, torch.complex(a, a)), (0.25, 0.5, 0.25))
    with pytest.raises(ValueError, match="one or a pair"):
        kernels.fir_frames((a, a, a), (0.25, 0.5, 0.25))
    kernels.env_render(torch.rand(1, 40 * 8), a[..., :2], a[..., :2, None],
                       a[..., :2, None], a[..., :2] + 1)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
