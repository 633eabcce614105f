"""Layer-0 codec of the PyTorch port: harmonic + noise analysis and
synthesis (counterpart of libllsm2_tpu/models/layer0.py; reference:
layer0.c -> llsm_analyze / llsm_synthesize).

Analysis: F0 refine, one batched pitch-synchronous chirped projection
over all frames, the analytic amplitude-track deconvolution, the
harmonic-track denoiser (or the opt-in track lowpass), a residual
render, band envelopes by FFT with their envelope projection, and a
warped periodogram.  Synthesis: an oscillator bank with overlap-add for
the harmonic part, and a WOLA noise shaper for the noise part.  The
kernels of the path are in ops/kernels.py.

The private ``_analyze`` / ``_synthesize`` / ``_synth_noise`` take a
leading batch axis where the JAX package maps single utterances with
``jax.vmap``.  Options outside the ported configuration (see
config.AnalysisOptions) raise NotImplementedError naming the ROADMAP item
that brings them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import AnalysisOptions, ChunkConf, SynthesisOptions
from ..container import Chunk, index_batch
from ..fp import FP
from ..ops import harmonics, interp, kernels, resample, spectral, warp


class SynthResult(NamedTuple):
    """Reference: llsm_output (llsm.h) -- synthesized signal + components."""
    y: torch.Tensor
    y_sin: torch.Tensor
    y_nos: torch.Tensor
    fs: float


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to libllsm2_tpu_torch yet ({item} in "
        "ROADMAP.md)")


def _check_analysis(opt: AnalysisOptions) -> None:
    if not opt.use_pallas:
        raise _unported("use_pallas=False (the JAX package's jnp branches)",
                        "Queue 1 item 11")
    if opt.hm_method != "czt":
        raise _unported(f"hm_method={opt.hm_method!r}", "Queue 1 item 11")
    if opt.hm_passes != 1:
        raise _unported(f"hm_passes={opt.hm_passes}", "Queue 1 item 11")
    if opt.hm_correction != "deconv":
        raise _unported(f"hm_correction={opt.hm_correction!r}",
                        "Queue 1 item 11")
    if opt.frame_chunk:
        raise _unported("frame_chunk > 0", "Queue 1 item 11")
    if _resamples(opt):
        raise ValueError(
            f"_analyze takes x at conf.fs = {opt.conf.fs} Hz, not at "
            f"fs_input = {opt.fs_input} Hz: analyze() resamples first")


def _resamples(opt: AnalysisOptions) -> bool:
    return bool(opt.fs_input) and abs(opt.fs_input - opt.conf.fs) > 1e-9


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def _env_decimation(conf: ChunkConf, requested: int, nx: int) -> int:
    """Largest valid envelope decimation <= requested: a power of two that
    divides the hop and the FFT size, with every noise channel's band
    inside one alias window of the decimated grid (checked on the same
    ceil-rounded FFT-bin indices _band_envelopes folds)."""
    edges = conf.chan_edges
    nfft = spectral.next_pow2(nx)
    D = 1
    while 2 * D <= max(int(requested), 1):
        D *= 2
    while D > 1:
        nfft_d = nfft // D
        ok = conf.nhop % D == 0 and nfft % D == 0
        for c in range(conf.nchannel):
            lo, hi = edges[c], edges[c + 1]
            b_lo = int(-(-lo * nfft // conf.fs))
            b_hi = min(int(-(-hi * nfft // conf.fs)), nfft // 2 + 1)
            if b_hi <= b_lo or b_lo // nfft_d != (b_hi - 1) // nfft_d:
                ok = False
        if ok:
            return D
        D //= 2
    return 1


def _band_envelopes(residual: torch.Tensor, conf: ChunkConf,
                    decimate: int = 1) -> torch.Tensor:
    """Per-channel temporal amplitude envelopes of the residual [B, nx]
    from the FFT-domain analytic signal -> [B, C, nx // decimate].  With
    D > 1 each band's one-sided spectrum is folded into an nfft/D grid (a
    coherent frequency shift, since the band lies in one alias window), so
    |z| is exactly the full-rate envelope sampled every D samples."""
    B, nx = residual.shape
    dev = residual.device
    nfft = spectral.next_pow2(nx)
    X = torch.fft.fft(residual, n=nfft)
    edges = conf.chan_edges
    envs = []
    if decimate == 1:
        f = torch.fft.fftfreq(nfft, 1.0 / conf.fs, device=dev)
        for c in range(conf.nchannel):
            m = ((f >= edges[c]) & (f < edges[c + 1])).to(FP)
            envs.append(torch.abs(torch.fft.ifft(X * m * 2.0))[:, :nx])
        return torch.stack(envs, dim=1)
    D = decimate
    nfft_d = nfft // D
    for c in range(conf.nchannel):
        b_lo = int(-(-edges[c] * nfft // conf.fs))
        b_hi = min(int(-(-edges[c + 1] * nfft // conf.fs)), nfft // 2 + 1)
        shift = (b_lo // nfft_d) * nfft_d
        y = torch.zeros((B, nfft_d), dtype=X.dtype, device=dev)
        y[:, b_lo - shift:b_hi - shift] = X[:, b_lo:b_hi]
        z = torch.fft.ifft(2.0 * y) * (1.0 / D)
        envs.append(torch.abs(z)[:, :nx // D])
    return torch.stack(envs, dim=1)


def _warped_psd(residual: torch.Tensor, nfrm: int,
                conf: ChunkConf) -> torch.Tensor:
    """Per-frame PSD of the residual [B, nx] on the warped axis
    [B, N, npsd] (reference: dsputils.c warped PSD estimation)."""
    nhop = conf.nhop
    winlen = 4 * nhop
    nfft = spectral.next_pow2(winlen)
    frames = harmonics.frame_hops(residual, nfrm, nhop, 2)
    # np.hanning is the SYMMETRIC window, as jnp.hanning
    w = torch.as_tensor(np.hanning(winlen), dtype=FP, device=residual.device)
    pgram = spectral.periodogram(frames, w, nfft)          # [B, N, nbin]
    band_mat = warp.warped_band_matrix(conf.npsd, nfft // 2 + 1, conf.fs,
                                       conf.noswarp, device=residual.device)
    return pgram @ band_mat.T


def _complex_handoff(opt: AnalysisOptions) -> bool:
    """True where the deconvolution hands its raw complex track straight
    to the track denoiser (layer0.py:865-867 of the JAX package): the
    single-pass czt deconvolution followed by the denoiser, not the
    lowpass."""
    return (opt.hm_correction == "deconv" and opt.hm_passes <= 1
            and opt.hm_method == "czt" and opt.track_denoise
            and opt.track_lowpass_hz <= 0.0)


def _deconv_correction(opt: AnalysisOptions, f0, cyc, ampl, phse, mask,
                       return_complex: bool = False):
    """Analytic amplitude-track deconvolution (hm_correction="deconv"):
    one Neumann step c' <- 2c - S c on the phase-aligned complex tracks,
    S = the banded render+measure operator (temporal smoothing T and the
    k +- 1 AM-sideband coupling X).  f0 [B, N], cyc [B, nx], ampl/phse/mask
    [B, N, K] -> corrected (ampl, phse), or with return_complex the masked
    complex track (re, im): the banded step mixes neighbour frames, so
    dead slots are not exactly zero before the mask."""
    conf = opt.conf
    nhop = conf.nhop
    B, N, K = ampl.shape
    hh = -(-conf.halfwin_max // nhop)
    D = hh + 1                       # |d| band: window +- OLA half-width
    if D > 128:
        raise _unported("deconvolution bands wider than 128 frames",
                        "Queue 1 item 11")
    voiced = f0 > 0.0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    halfwidth = torch.clamp(conf.rel_winsize * conf.fs / (2.0 * f0s), 2.0,
                            float(conf.halfwin_max))
    # stride-8 midpoint quadrature of the window x crossfade products
    stride = max(min(8, nhop), 1)
    nq = (2 * nhop) // stride
    C2 = harmonics.frame_hops(cyc, N, nhop, 1, mode="edge")   # [B, N, 2nhop]
    ang = 2.0 * math.pi * C2[..., stride // 2::stride][..., :nq]
    c_re, c_im = kernels.deconv_full(ampl, phse, cyc[..., ::nhop][..., :N],
                                     halfwidth, torch.cos(ang),
                                     torch.sin(ang), D, nhop, stride)
    if return_complex:
        return c_re * mask, c_im * mask
    return (torch.sqrt(c_re ** 2 + c_im ** 2) * mask,
            torch.atan2(c_im, c_re) * mask)


# ---------------------------------------------------------------------------
# harmonic-track denoisers (JAX layer0.py:140-789, the Pallas branch)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _hann_taps(M: int) -> tuple:
    """Normalized symmetric Hann FIR of M taps (np.hanning(M + 2)[1:-1])."""
    w = np.hanning(M + 2)[1:-1]
    return tuple((w / w.sum()).tolist())


def _aligned_track(ampl, phse, cyc_c):
    """Phase-aligned complex tracks c'_k = a e^{j phi} e^{-2 pi j k cyc_c}
    [B, N, K] and the alignment field e^{-2 pi j k cyc_c} (mod-1
    phases)."""
    kh = torch.arange(1, ampl.shape[-1] + 1, dtype=FP, device=ampl.device)
    ph = kh * cyc_c[..., None]
    ph = ph - torch.round(ph)
    align = torch.polar(torch.ones_like(ph), -2.0 * math.pi * ph)
    return torch.polar(ampl, phse) * align, align


def _track_lowpass(conf: ChunkConf, f0, cyc_c, ampl, phse, mask,
                   cutoff_hz: float):
    """Opt-in track lowpass (AnalysisOptions.track_lowpass_hz): Hann FIR of
    each harmonic's aligned complex track along frames, applied only where
    the whole filter support is voiced.  f0, cyc_c [B, N]; ampl, phse,
    mask [B, N, K] -> (ampl, phse)."""
    frame_rate = 1.0 / conf.thop
    M = int(round(frame_rate / cutoff_hz)) | 1          # odd tap count
    w = _hann_taps(M)
    c, align = _aligned_track(ampl, phse, cyc_c)
    voiced = (f0 > 0).to(FP)[..., None]
    guard, c_f = kernels.fir_frames((voiced, c), w)
    cs = torch.where(guard > 0.999, c_f, c) * align.conj()  # guard [B, N, 1]
    return torch.abs(cs) * mask, torch.angle(cs) * mask


def _denoise_floor_stats(pp, cs2_m, r2, amp2_m, ok):
    """Per-utterance floor statistics of the track denoiser: [B, N, K]
    powers and the usable-slot mask ok -> (v [B, K] gate floor, wmul
    [B, K] coherent-fit weights), every sum over one utterance's frames.
    v is the Winsorized mean of pp over usable frames, zeroed with fewer
    than 16 of them, below -35 dB of the slow power, or where the slow
    track keeps under 10% of the raw energy; wmul drops noise-dominated
    tracks from the fit (JAX layer0.py:329-365 says why)."""
    zero = torch.zeros((), dtype=FP, device=pp.device)
    osum = lambda t: torch.sum(torch.where(ok, t, zero), dim=1)
    cnt = torch.sum(ok, dim=1).to(FP)
    n_ok = torch.clamp(cnt, min=1.0)
    v = osum(pp) / n_ok
    for _ in range(3):
        v = osum(torch.minimum(pp, 3.0 * v[:, None, :])) / n_ok
    v = torch.where(cnt >= 16.0, v, zero)
    p_bar = osum(cs2_m) / n_ok
    v = torch.where(v > 10.0 ** -3.5 * p_bar, v, zero)
    p_raw = osum(amp2_m) / n_ok
    q = p_bar / torch.clamp(p_raw, min=1e-20)
    v = torch.where(q > 0.1, v, zero)
    f_k = osum(r2) / n_ok
    wmul = torch.clamp(1.0 - 2.0 * f_k / torch.clamp(p_bar, min=1e-20),
                       0.0, 1.0)
    return v, wmul


class _GateDFT(NamedTuple):
    """Constant transforms of the decimated spectral gate."""
    Wf: torch.Tensor       # [NPd, Nd] forward DFT
    Whigh: torch.Tensor    # [H/2, N] every second probe-band bin, full rate
    Wi: torch.Tensor       # [Nd, NPd] inverse DFT (1/NPd folded in)
    n_high: int


def _gate_sizes(N: int, D: int):
    NP = 1 << max(int(N - 1).bit_length(), 4)
    Nd = (N + D - 1) // D
    NPd = 1 << max(int(Nd - 1).bit_length(), 4)
    return NP, Nd, NPd


@functools.lru_cache(maxsize=8)
def _gate_dft(N: int, D: int, thop: float, cutoff_hz: float,
              device: torch.device) -> _GateDFT:
    """The decimated gate's DFT matrices, built once per shape and device
    (Whigh alone is ~9 MB at N = 1600)."""
    NP, Nd, NPd = _gate_sizes(N, D)
    f_np = np.fft.fftfreq(NP, thop)
    high_n = np.where(np.abs(f_np) > 2.0 * cutoff_hz)[0][::2]
    mat = lambda a: torch.as_tensor(a.astype(np.complex64), device=device)
    return _GateDFT(
        Wf=mat(np.exp((-2j * np.pi / NPd)
                      * np.outer(np.arange(NPd), np.arange(Nd)))),
        Whigh=mat(np.exp((-2j * np.pi / NP)
                         * np.outer(high_n, np.arange(N)))),
        Wi=mat(np.exp((2j * np.pi / NPd)
                      * np.outer(np.arange(Nd), np.arange(NPd))) / NPd),
        n_high=len(high_n))


def _spectral_gate(c_s, full, pp, guard, v, mask, thop: float,
                   cutoff_hz: float, a_spec: float, decimate: int = 1):
    """Per-frame-frequency-bin noise gate on the slow track (JAX
    layer0.py:368-599, whose docstring gives the reasons): c_s, full
    [B, N, K] complex (slow part; guarded c_s + r_inc), pp [B, N, K], guard
    [B, N, 1] bool, v [B, K], mask [B, N, K] -> the aligned-domain
    subtraction delta [B, N, K], zero on unguarded rows.  Every statistic
    (probe level, engagement, noise profile, local blend) is taken within
    one utterance.  decimate D > 1 gates at the frame rate / D by DFT
    matmuls and block-lerps the delta back; D = 1 uses FFTs.  The products
    run in complex64 (fp32, no TF32)."""
    B, N, K = c_s.shape
    D = max(int(decimate), 1)
    zero = torch.zeros((), dtype=FP, device=c_s.device)
    czero = torch.zeros((), dtype=c_s.dtype, device=c_s.device)
    if D > 1:
        mats = _gate_dft(N, D, float(thop), float(cutoff_hz), c_s.device)
        sg_d = torch.where(guard[:, ::D], c_s[:, ::D], czero)   # [B, Nd, K]
        Xs = torch.matmul(mats.Wf, sg_d)                         # [B, NPd, K]
        X_high = torch.matmul(mats.Whigh, full)
        lev_k = torch.sum(X_high.real ** 2 + X_high.imag ** 2, dim=1) \
            / (float(max(mats.n_high, 1)) * D)
    else:
        NP = _gate_sizes(N, 1)[0]
        hb = np.abs(np.fft.fftfreq(NP, thop)) > 2.0 * cutoff_hz
        Xs = torch.fft.fft(torch.where(guard, c_s, czero), n=NP, dim=1)
        Xfull = torch.fft.fft(full, n=NP, dim=1)
        Pfull = Xfull.real ** 2 + Xfull.imag ** 2
        hbt = torch.as_tensor(hb, device=c_s.device)[None, :, None]
        lev_k = torch.sum(torch.where(hbt, Pfull, zero), dim=1) \
            / float(max(hb.sum(), 1))
    Ps = Xs.real ** 2 + Xs.imag ** 2
    # engagement stricter than the time gate's: -15 dB of the slow power
    gd = guard & (mask > 0)
    n_gd = torch.clamp(torch.sum(gd, dim=1).to(FP), min=1.0)
    p_bar = torch.sum(torch.where(gd, c_s.real ** 2 + c_s.imag ** 2, zero),
                      dim=1) / n_gd
    engaged = (v > 10.0 ** -1.5 * p_bar) & (mask != 0).any(dim=1)   # [B, K]
    wk = engaged.to(FP)[:, None, :]
    nwk = torch.sum(engaged.to(FP), dim=-1)                        # [B]
    wsum = torch.clamp(nwk, min=1e-9)[:, None]
    lev_safe = torch.where(engaged, torch.clamp(lev_k, min=1e-30),
                           torch.ones_like(lev_k))
    pn = Ps / lev_safe[:, None, :]
    prof = torch.sum(pn * wk, dim=-1) / wsum                       # [B, NP]
    for _ in range(3):                                             # Winsorize
        cl = torch.minimum(pn, 3.0 * prof[..., None])
        prof = torch.sum(cl * wk, dim=-1) / wsum
    sm = 15                                                        # circular MA
    prof = sum(torch.roll(prof, j - sm // 2, dims=1) for j in range(sm)) / sm
    nf = lev_k[:, None, :] * prof[..., None]
    g = torch.clamp(1.0 - a_spec * nf / (Ps + 1e-30), 0.0, 1.0)
    # >= 3 noisy tracks for a usable profile; clean tracks untouched
    use = (nwk >= 3.0)[:, None, None] & engaged[:, None, :]
    g = torch.where(use, g, torch.ones_like(g))
    if D > 1:
        # inverse of the gated DIFFERENCE (g - 1) Xs, so transform rounding
        # stays relative to the delta; block-lerp back to the frame rate
        delta_d = torch.matmul(mats.Wi, (g - 1.0) * Xs)           # [B, Nd, K]
        nxt = torch.cat([delta_d[:, 1:], delta_d[:, -1:]], dim=1)
        wts = (torch.arange(D, dtype=FP, device=c_s.device) / D)[:, None]
        up = delta_d[:, :, None] * (1.0 - wts) + nxt[:, :, None] * wts
        s_dn = c_s + up.reshape(B, -1, K)[:, :N]
    else:
        s_dn = torch.fft.ifft(g * Xs, dim=1)[:, :N]

    # local-noisiness blend: frame-smoothed probe power against the floor
    M = int(round(1.0 / (thop * cutoff_hz))) | 1
    okf = gd.to(FP)
    if D > 1:
        BB = 2 * D
        Nb = -(-N // BB)
        bmean = lambda a: torch.nn.functional.pad(
            a, (0, 0, 0, Nb * BB - N)).reshape(B, Nb, BB, K).mean(dim=2)
        MB = max(int(round(M / BB)), 1) | 1
        wb = _hann_taps(MB)
        num, den = kernels.fir_frames((bmean(pp * okf), bmean(okf)), wb)
        lp = torch.repeat_interleave(num / torch.clamp(den, min=1e-9), BB,
                                     dim=1)[:, :N]
    else:
        num, den = kernels.fir_frames((pp * okf, okf), _hann_taps(M))
        lp = num / torch.clamp(den, min=1e-9)
    w_loc = torch.clamp(3.0 * lp / torch.clamp(v[:, None, :], min=1e-30)
                        - 0.5, 0.0, 1.0)
    return torch.where(guard, w_loc * (s_dn - c_s), czero)


def _track_denoise(conf: ChunkConf, f0, cyc_c, ampl, phse, mask,
                   cutoff_hz: float, strength: float, *,
                   spectral: bool = False, a_spec: float = 3.0,
                   spec_decimate: int = 1, c_complex=None):
    """The dynamics-adaptive harmonic-track denoiser (AnalysisOptions.
    track_denoise; the JAX Pallas branch, layer0.py:648-702): pass A
    (kernels.denoise_stats), the per-utterance floor statistics, pass B
    (kernels.denoise_apply) and, with `spectral`, the per-bin gate on the
    slow track.  f0, cyc_c [B, N]; ampl, phse, mask [B, N, K] ->
    (ampl, phse).  c_complex: the raw complex track (re, im) from
    _deconv_correction(return_complex=True); ampl and phse are then
    ignored."""
    frame_rate = 1.0 / conf.thop
    M = int(round(frame_rate / cutoff_hz)) | 1          # odd tap count
    Mp = int(round(frame_rate / (2.0 * cutoff_hz))) | 1
    taps1, taps2 = _hann_taps(M), _hann_taps(Mp)
    voiced = (f0 > 0).to(FP)
    if c_complex is not None:
        (pp, cs2, r2, guard, cre, cim, csr, csi) = kernels.denoise_stats(
            c_complex[0], c_complex[1], cyc_c, mask, voiced, taps1, taps2,
            complex_input=True)
        amp2_m = (cre * cre + cim * cim) * mask
    else:
        (pp, cs2, r2, guard, cre, cim, csr, csi) = kernels.denoise_stats(
            ampl, phse, cyc_c, mask, voiced, taps1, taps2)
        amp2_m = ampl * ampl * mask
    ok = guard[..., None] & (mask > 0)
    v, wmul = _denoise_floor_stats(pp, cs2 * mask, r2, amp2_m, ok)
    if not spectral:
        re, im = kernels.denoise_apply(cre, cim, csr, csi, cyc_c, mask, guard,
                                       v, wmul, float(strength))
        return torch.sqrt(re * re + im * im) * mask, torch.atan2(im, re) * mask
    re, im, fullr, fulli, ur, ui = kernels.denoise_apply(
        cre, cim, csr, csi, cyc_c, mask, guard, v, wmul, float(strength),
        emit_resid=True)
    delta = _spectral_gate(torch.complex(csr, csi), torch.complex(fullr, fulli),
                           pp, guard[..., None], v, mask, conf.thop,
                           cutoff_hz, a_spec, decimate=spec_decimate)
    outr = re + delta.real * ur - delta.imag * ui
    outi = im + delta.real * ui + delta.imag * ur
    return (torch.sqrt(outr * outr + outi * outi) * mask,
            torch.atan2(outi, outr) * mask)


def _moving_sum(v: torch.Tensor, S: int) -> torch.Tensor:
    """jnp.convolve(v, ones(S), mode="same") along the last axis, as a
    zero-padded windowed sum (no cuDNN, so no TF32 on the card)."""
    vp = torch.nn.functional.pad(v, (S // 2, (S - 1) // 2))
    return vp.unfold(-1, S, 1).sum(dim=-1)


def analyze(opt: AnalysisOptions, x, f0, device=None) -> Chunk:
    """Analyze one signal x [nx] with its F0 track f0 [nfrm] (0 =
    unvoiced, frame rate 1/conf.thop) into a chunk (reference: layer0.c
    -> llsm_analyze).  x is at conf.fs, or at opt.fs_input, from which it
    is resampled to conf.fs first (create_aoptions sets fs_input for rates
    with a non-integral hop, e.g. 11025 Hz).  The analysis runs on
    `device`; by default a tensor x stays on its device and numpy input
    goes to the card ("cuda"; pass device="cpu" for the CPU -- without a
    card the default raises, there is no fallback)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    x = torch.as_tensor(x, device=device).to(FP)
    f0 = torch.as_tensor(f0, device=x.device).to(FP)
    if _resamples(opt):
        x = resample.resample_to(x, opt.fs_input, opt.conf.fs)
        opt = dataclasses.replace(opt, fs_input=0.0)
    return index_batch(_analyze(opt, x[None], f0[None]), 0)


def _analyze(opt: AnalysisOptions, x: torch.Tensor,
             f0: torch.Tensor) -> Chunk:
    """Batched analysis: x [B, nx'], f0 [B, N] -> chunk with a leading
    batch axis.  x is cut or zero-padded to N*nhop samples.  x must be at
    conf.fs: like the JAX package's _analyze_jit (and batched_pipeline),
    this never resamples, so an opt whose fs_input differs from conf.fs
    raises here instead of analyzing x at the wrong rate."""
    _check_analysis(opt)
    conf = opt.conf
    nhop = conf.nhop
    B, nfrm = f0.shape
    nx = nfrm * nhop
    x = x.to(FP)[:, :nx]
    x = torch.nn.functional.pad(x, (0, nx - x.shape[1]))
    f0 = f0.to(FP)

    if opt.f0_refine:
        f0_ref = harmonics.refine_f0(
            x, f0, nhop=nhop, fs=conf.fs, halfwin_max=conf.halfwin_max,
            rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
        S = opt.f0_refine_smooth
        if S > 1:
            # voicing-masked moving average of the refine CORRECTION
            voiced_m = (f0 > 0).to(FP)
            num = _moving_sum((f0_ref - f0) * voiced_m, S)
            den = torch.clamp(_moving_sum(voiced_m, S), min=1.0)
            f0 = torch.where(voiced_m > 0, f0 + num / den,
                             torch.zeros_like(f0))
        else:
            f0 = f0_ref

    cyc = harmonics.sample_cycles(f0, nhop, conf.fs, nx)

    # harmonic pass: zoomed chirped projection
    ampl, phse, mask = harmonics.harmonic_analysis(
        x, f0, cyc, nhop=nhop, fs=conf.fs, max_k=conf.maxnhar,
        halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
        fnyq=conf.fnyq, mxu=opt.hm_kernel == "matmul")

    # residual: deconvolve the track smoothing (handing the complex track
    # to the denoiser), denoise, subtract the harmonic part
    cplx = None
    if _complex_handoff(opt):
        cplx = _deconv_correction(opt, f0, cyc, ampl, phse, mask,
                                  return_complex=True)
    else:
        ampl, phse = _deconv_correction(opt, f0, cyc, ampl, phse, mask)
    cyc_c = cyc[..., ::nhop][..., :nfrm].contiguous()   # read by 2 kernels
    if opt.track_denoise and opt.track_lowpass_hz <= 0.0:
        ampl, phse = _track_denoise(
            conf, f0, cyc_c, ampl, phse, mask, opt.track_denoise_hz,
            opt.track_denoise_strength, spectral=opt.track_denoise_spectral,
            a_spec=opt.track_spectral_strength,
            spec_decimate=opt.track_spectral_decimate, c_complex=cplx)
    if opt.track_lowpass_hz > 0.0:
        ampl, phse = _track_lowpass(conf, f0, cyc_c, ampl, phse, mask,
                                    opt.track_lowpass_hz)
    residual = kernels.osc_bank(cyc, ampl, phse, mask, nhop, x)

    # noise pass: band envelopes (at the decimated rate fs/D) + warped PSD
    D = _env_decimation(conf, opt.env_decimate, nx)
    envs = _band_envelopes(residual, conf, D)              # [B, C, nx/D]
    Cn, Ke = conf.nchannel, conf.maxnhar_e
    # each channel's row of envs reads its utterance's cycle track
    ea, ep, _, edc = harmonics.harmonic_analysis(
        envs.reshape(B * Cn, -1), torch.repeat_interleave(f0, Cn, dim=0),
        cyc[:, ::D],
        nhop=nhop // D, fs=conf.fs / D, max_k=Ke,
        halfwin_max=-(-conf.halfwin_max // D), rel_winsize=conf.rel_winsize,
        fnyq=min(conf.fnyq, 0.4 * conf.fs / D), with_dc=True)
    edc = torch.clamp(edc, min=0.0).reshape(B, Cn, nfrm).transpose(1, 2)
    eenv_a = ea.reshape(B, Cn, nfrm, Ke).transpose(1, 2)   # [B, N, C, Ke]
    eenv_p = ep.reshape(B, Cn, nfrm, Ke).transpose(1, 2)
    psd = _warped_psd(residual, nfrm, conf)
    return Chunk(f0=f0, ampl=ampl, phse=phse, hm_mask=mask, psd=psd,
                 edc=edc.contiguous(), eenv_a=eenv_a.contiguous(),
                 eenv_p=eenv_p.contiguous(), conf=conf)


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------

def _env_coefs(chunk: Chunk, cyc_c: torch.Tensor):
    """Rotated, voicing-masked envelope-harmonic coefficients of a batched
    chunk: (edc [B, N, C], ar, ai [B, N, C, Ke], base [B, N, C]).  eenv_p
    is measured at the frame center, the renderers use the absolute cycle
    track, so the phases are re-referenced by -2 pi k cyc_c; base is the
    unit-RMS modulator normalizer sqrt(edc^2 + sum a^2/2)."""
    voiced = (chunk.f0 > 0).to(FP)[..., None, None]
    Ke = chunk.eenv_a.shape[-1]
    kh = torch.arange(1, Ke + 1, dtype=FP, device=cyc_c.device)
    ph = chunk.eenv_p / (2.0 * math.pi) - kh * cyc_c[..., None, None]
    ph = (ph - torch.round(ph)) * (2.0 * math.pi)
    ar = chunk.eenv_a * torch.cos(ph) * voiced
    ai = chunk.eenv_a * torch.sin(ph) * voiced
    base = torch.sqrt(chunk.edc ** 2
                      + 0.5 * torch.sum((chunk.eenv_a * voiced) ** 2, dim=-1))
    return chunk.edc, ar, ai, base


def _render_envelopes(chunk: Chunk, cyc: torch.Tensor, nhop: int,
                      use_pallas: bool = False):
    """Per-channel temporal envelopes and their baselines (env, base
    [B, C, nx], nx = cyc.shape[-1]) of a batched chunk, rendered per
    sample from the frames' envelope coefficients (reference: layer0.c
    noise synthesis -- envelope reconstruction).  Renders through
    kernels.env_render, a cut render (nx < N * nhop) included; the JAX
    package's use_pallas=False branch is not ported."""
    if not use_pallas:
        raise _unported("use_pallas=False (the JAX package's jnp branches)",
                        "Queue 1 item 11")
    N = chunk.f0.shape[-1]
    nx = cyc.shape[-1]
    centers = torch.clamp(torch.arange(N, device=cyc.device) * nhop,
                          max=nx - 1)
    coefs = _env_coefs(chunk, cyc[..., centers])
    return kernels.env_render(cyc, *coefs, nhop=nhop)


def _band_segments(shaped_spec: torch.Tensor, masks: torch.Tensor,
                   w: torch.Tensor, T: int) -> torch.Tensor:
    """Windowed per-band time segments [B, C, N, T] from the shaped noise
    spectra [B, N, nbin]: the inverse real DFT as one contraction with the
    synthesis window and band masks folded into the matrix."""
    nbin = shaped_spec.shape[-1]
    dev = shaped_spec.device
    b = torch.arange(nbin, dtype=torch.int64, device=dev)
    t = torch.arange(T, dtype=torch.int64, device=dev)
    # exact cycles mod 1 via integer arithmetic before trig
    ang = 2.0 * math.pi * (torch.remainder(b[:, None] * t[None, :], T)
                           .to(FP) / T)
    wb = torch.full((nbin,), 2.0 / T, dtype=FP, device=dev)
    wb[0] = wb[-1] = 1.0 / T
    scale = wb[:, None] * w[None, :]                         # [nbin, T]
    cos_c = masks[:, :, None] * (torch.cos(ang) * scale)     # [C, nbin, T]
    sin_c = masks[:, :, None] * (torch.sin(ang) * scale)
    return (torch.einsum("znb,cbt->zcnt", shaped_spec.real, cos_c)
            - torch.einsum("znb,cbt->zcnt", shaped_spec.imag, sin_c))


def _synth_noise(chunk: Chunk, cyc: torch.Tensor, nhop: int, fs: float,
                 noise_seed: int, bins=None,
                 frame_base: int = 0) -> torch.Tensor:
    """Noise component of a batched chunk [B, N, ...] -> [B, N*nhop]: each
    frame's white-noise spectrum is shaped by sqrt(PSD), band-split,
    windowed back to time, overlap-added and modulated by the temporal
    envelopes (reference: layer0.c noise synthesis).

    Frame i's standard-normal spectrum is keyed by (noise_seed,
    frame_base + i) and drawn as the JAX package draws it
    (kernels.noise_bins), the same in every batch row: a chunk renders the
    same noise alone and in a batch, and frames [i0, i0+n) rendered with
    frame_base=i0 draw the spectra the whole render draws for them.
    bins: optional (re, im) [B, N, nbin] spectra to use instead."""
    conf = chunk.conf
    B, N = chunk.f0.shape
    T = 2 * nhop
    nbin = T // 2 + 1
    dev = cyc.device
    # sqrt-Hann WOLA pair: perfect reconstruction at 50% overlap
    w = torch.sqrt(0.5 - 0.5 * torch.cos(
        2.0 * math.pi * (torch.arange(T, dtype=FP, device=dev) + 0.5) / T))
    # the PSD axis is warped over the analysis band [0, conf.fs/2]
    f = torch.arange(nbin, dtype=FP, device=dev) * fs / T
    nyq_a = conf.fs / 2.0
    wmax = warp.warp_frequency(nyq_a, conf.noswarp).to(dev)
    pos = torch.clamp(warp.warp_frequency(f, conf.noswarp) / wmax * conf.npsd
                      - 0.5, 0.0, conf.npsd - 1.0)
    gain = torch.sqrt(torch.clamp(interp.interp1_uniform(chunk.psd, pos),
                                  min=0.0))                  # [B, N, nbin]
    if fs > conf.fs:
        # no information above the analysis Nyquist: raised-cosine taper
        # over its top 5%, zero beyond
        edge0 = 0.95 * nyq_a
        taper = torch.where(
            f <= edge0, torch.ones_like(f),
            torch.where(f >= nyq_a, torch.zeros_like(f),
                        0.5 + 0.5 * torch.cos(math.pi * (f - edge0)
                                              / (nyq_a - edge0))))
        gain = gain * taper

    if bins is None:
        re, im = kernels.noise_bins(noise_seed, frame_base, B, N, nbin, dev)
    else:
        re, im = (v.to(dev, FP) if torch.is_tensor(v) else
                  torch.tensor(np.asarray(v), dtype=FP, device=dev)
                  for v in bins)
        if re.shape != (B, N, nbin) or im.shape != (B, N, nbin):
            raise ValueError(f"bins must be [{B}, {N}, {nbin}] each")
    scale = torch.full((nbin,), math.sqrt(T / 2.0), dtype=FP, device=dev)
    scale[0] = scale[-1] = math.sqrt(float(T))
    # the DC and Nyquist bins are real: their imaginary draws are dropped
    im_scale = scale.clone()
    im_scale[0] = im_scale[-1] = 0.0
    shaped = torch.complex(re * scale, im * im_scale) * gain   # [B, N, nbin]
    edges = conf.chan_edges
    masks = torch.stack([((f >= edges[c]) & (f < edges[c + 1])).to(FP)
                         for c in range(conf.nchannel)])       # [C, nbin]
    band_segs = _band_segments(shaped, masks, w, T)            # [B, C, N, T]
    edc, ar, ai, base = _env_coefs(chunk, cyc[..., ::nhop][..., :N])
    return kernels.noise_mod_ola(cyc, edc, ar, ai, base, band_segs)


def synthesize(opt: SynthesisOptions, chunk: Chunk) -> SynthResult:
    """Synthesize one chunk (no batch axis) back to a waveform (reference:
    layer0.c -> llsm_synthesize)."""
    res = _synthesize(opt, index_batch(chunk, None))
    return SynthResult(y=res.y[0], y_sin=res.y_sin[0], y_nos=res.y_nos[0],
                       fs=res.fs)


def _synthesize(opt: SynthesisOptions, chunk: Chunk, bins=None) -> SynthResult:
    """Batched synthesis of a chunk with a leading batch axis -> [B, nx]
    signals, rendered directly at opt.fs (harmonics above its Nyquist are
    masked); a rate with a non-integral hop renders at the nearest rate
    with an integral hop and resamples to opt.fs.  bins: see _synth_noise
    (at the rendering rate)."""
    if not opt.use_pallas:
        raise _unported("use_pallas=False (the JAX package's jnp branches)",
                        "Queue 1 item 11")
    if opt.noise_idft != "matmul":
        raise _unported(f"noise_idft={opt.noise_idft!r}", "Queue 1 item 5")
    conf = chunk.conf
    fs = opt.fs
    if abs(conf.thop * fs - round(conf.thop * fs)) > 1e-6:
        # render at the nearest rate with an integral hop, then resample
        # every output to fs (e.g. 11025 Hz renders at 11000)
        fs_render = max(round(conf.thop * fs), 1) / conf.thop
        res = _synthesize(dataclasses.replace(opt, fs=fs_render), chunk,
                          bins=bins)
        ny = int(round(chunk.nfrm * conf.thop * fs))
        return SynthResult(*(resample.resample_to(v, fs_render, fs, ny=ny)
                             for v in res[:3]), fs=fs)
    nhop = int(round(conf.thop * fs))
    nx = chunk.nfrm * nhop
    cyc = harmonics.sample_cycles(chunk.f0, nhop, fs, nx)
    K = chunk.ampl.shape[-1]
    kharm = torch.arange(1, K + 1, dtype=FP, device=cyc.device)
    f0s = torch.where(chunk.f0 > 0, chunk.f0, torch.full_like(chunk.f0, 100.0))
    hm_mask = chunk.hm_mask * (kharm * f0s[..., None] < 0.5 * fs)
    y_sin = kernels.osc_bank(cyc, chunk.ampl, chunk.phse, hm_mask, nhop)
    y_nos = _synth_noise(chunk, cyc, nhop, fs, opt.noise_seed, bins=bins)
    return SynthResult(y=y_sin + y_nos, y_sin=y_sin, y_nos=y_nos, fs=fs)
