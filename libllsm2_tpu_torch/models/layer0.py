"""Layer-0 codec of the PyTorch port: harmonic + noise analysis and
synthesis (counterpart of libllsm2_tpu/models/layer0.py; reference:
layer0.c -> llsm_analyze / llsm_synthesize).

Analysis: F0 refine, the harmonic pass (the chirped pitch-synchronous
projection, or FFT peak-picking with hm_method="pp"), the analytic
amplitude-track deconvolution and/or Gauss-Seidel re-analysis passes, the
harmonic-track denoiser (or the opt-in track lowpass), a residual render,
band envelopes by FFT with their envelope projection, and a warped
periodogram.  Synthesis: an oscillator bank with overlap-add for the
harmonic part, and a WOLA noise shaper for the noise part.

Every option of the JAX package runs.  use_pallas=True runs the
hand-written kernels of ops/kernels.py where the JAX package runs its
Pallas kernels; use_pallas=False runs the JAX package's jnp branches in
plain PyTorch, on the tensors' device, and launches none of them but the
noise draw (kernels.noise_bins) and the cycle track
(kernels.sample_cycles), which the JAX package computes in jnp under
both settings.

The private ``_analyze`` / ``_synthesize`` / ``_synth_noise`` take a
leading batch axis where the JAX package maps single utterances with
``jax.vmap``.
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
from ..fp import CP, FP, FP64
from ..ops import harmonics, interp, kernels, resample, spectral, warp
from ..ops.windows import window_centered
from ..utils.profiling import named_scope


class SynthResult(NamedTuple):
    """Reference: llsm_output (llsm.h) -- synthesized signal + components."""
    y: torch.Tensor
    y_sin: torch.Tensor
    y_nos: torch.Tensor
    fs: float


def _check_analysis(opt: AnalysisOptions) -> None:
    """_analyze takes x at conf.fs: refuse an opt that would resample."""
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


# rows a call of the operations whose libraries (cuFFT plans, cuBLAS and
# PyTorch's reduction configurations) choose their order of sums by the
# row count: the envelope FFTs, the denoiser's frame sums and the
# spectral gate's transforms and products run in groups of a fixed row
# count, the last zero-padded, so every row meets the same order whatever
# the batch.  A group costs a few launches and a padded row its work in
# those operations, which grows as the frame count squared (the gate's DFT
# products), so the count falls with the utterance's length: ROW_GROUP
# rows up to ROW_GROUP_FRAMES frames (8 s at the 5 ms hop), a quarter as
# many each time the frames double.  At 8 s on an H100
# (scripts/port_row_groups.py; PERF.md) groups of 64 rows cost a 128-row
# batch 0.4 ms over one call and a batch of one no measurable time; groups
# of 16 cost the 128-row batch 2.8 ms.
ROW_GROUP = 64
ROW_GROUP_FRAMES = 1600


def _group_rows(nfrm: int) -> int:
    """Rows a call of the grouped stages for utterances of nfrm frames:
    ROW_GROUP halved until G nfrm^2 <= ROW_GROUP ROW_GROUP_FRAMES^2, so a
    batch of one pads at most about the work of ROW_GROUP 8 s rows."""
    G = ROW_GROUP
    while G > 1 and G * nfrm * nfrm > ROW_GROUP * ROW_GROUP_FRAMES ** 2:
        G //= 2
    return G


def _row_groups(fn, t: torch.Tensor, rows: int) -> torch.Tensor:
    """fn(t) over groups of exactly `rows` rows of t (its leading axis),
    the last group zero-padded -> fn's output over t's rows, each row the
    same whatever the batch and its place in it."""
    outs = []
    for r0 in range(0, t.shape[0], rows):
        part = t[r0:r0 + rows]
        n = part.shape[0]
        if n < rows:
            part = torch.cat([part, part.new_zeros((rows - n,)
                                                   + part.shape[1:])])
        outs.append(fn(part)[:n])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _frame_sums(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Sums over the frame axis (1) of t [B, N, ...] in groups of `rows`
    rows."""
    return _row_groups(lambda a: torch.sum(a, dim=1), t, rows)


def _band_envelopes(residual: torch.Tensor, conf: ChunkConf,
                    decimate: int = 1, *,
                    rows: int | None = None) -> torch.Tensor:
    """Per-channel temporal amplitude envelopes of the residual [B, nx]
    from the FFT-domain analytic signal -> [B, C, nx // decimate].  With
    D > 1 each band's one-sided spectrum is folded into an nfft/D grid (a
    coherent frequency shift, since the band lies in one alias window), so
    |z| is exactly the full-rate envelope sampled every D samples.  The
    transforms run in groups of `rows` rows (default _group_rows of the
    utterance's frames), so a row's envelopes do not depend on its
    batch."""
    B, nx = residual.shape
    dev = residual.device
    C = conf.nchannel
    nfft = spectral.next_pow2(nx)
    rows = rows or _group_rows(nx // conf.nhop)
    # the bands lie in [0, fs/2): the one-sided spectrum is all they read
    X = _row_groups(lambda r: torch.fft.rfft(r, n=nfft), residual, rows)
    edges = conf.chan_edges
    D = decimate
    nfft_d = nfft // D
    # every band's spectrum [B, C, nfft_d], one inverse transform for all
    y = torch.zeros((B, C, nfft_d), dtype=X.dtype, device=dev)
    if D == 1:
        f = torch.fft.fftfreq(nfft, 1.0 / conf.fs, device=dev)[:X.shape[1]]
        for c in range(C):
            m = ((f >= edges[c]) & (f < edges[c + 1])).to(FP)
            y[:, c, :X.shape[1]] = X * m * 2.0
    else:
        for c in range(C):
            b_lo = int(-(-edges[c] * nfft // conf.fs))
            b_hi = min(int(-(-edges[c + 1] * nfft // conf.fs)),
                       nfft // 2 + 1)
            shift = (b_lo // nfft_d) * nfft_d
            y[:, c, b_lo - shift:b_hi - shift] = 2.0 * X[:, b_lo:b_hi]
    del X
    z = _row_groups(torch.fft.ifft, y.reshape(B * C, nfft_d), rows)
    if D > 1:
        z = z * (1.0 / D)
    return torch.abs(z).reshape(B, C, nfft_d)[..., :nx // D]


# the longest periodogram whose FFT and band product gave each row the
# same bits alone and in a batch on the H100 (512 points: 16 kHz at a 5 ms
# hop, chip_smoke.py phase 5); at 48 kHz (2048 points, a 1025-bin product)
# they did not (phase 20b), nor at 16 kHz with a 2 ms hop (128 points but
# 4000 frames, phase 20e), so longer ones, and tracks past ROW_GROUP_FRAMES
# (the 1600 frames phase 5 holds), run in row groups
PSD_UNGROUPED_NFFT = 512


def _warped_psd(residual: torch.Tensor, nfrm: int, conf: ChunkConf,
                rows: int | None = None) -> torch.Tensor:
    """Per-frame PSD of the residual [B, nx] on the warped axis
    [B, N, npsd] (reference: dsputils.c warped PSD estimation); with
    `rows`, periodograms longer than PSD_UNGROUPED_NFFT or tracks longer
    than ROW_GROUP_FRAMES take their FFTs and band product in groups of
    that many rows (_row_groups), so a row's PSD does not depend on its
    batch."""
    nhop = conf.nhop
    winlen = 4 * nhop
    nfft = spectral.next_pow2(winlen)
    # np.hanning is the SYMMETRIC window, as jnp.hanning
    w = torch.as_tensor(np.hanning(winlen), dtype=FP, device=residual.device)
    band_mat = warp.warped_band_matrix(conf.npsd, nfft // 2 + 1, conf.fs,
                                       conf.noswarp, device=residual.device)

    def psd(r):
        frames = harmonics.frame_hops(r, nfrm, nhop, 2)
        return spectral.periodogram(frames, w, nfft) @ band_mat.T
    if rows is None or (nfft <= PSD_UNGROUPED_NFFT
                        and nfrm <= ROW_GROUP_FRAMES):
        return psd(residual)
    return _row_groups(psd, residual, rows)


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
    dead slots are not exactly zero before the mask.  With the kernels on
    and a band of at most 128 frames, kernels.deconv_full; otherwise the
    JAX package's jnp branch (layer0.py:248-299)."""
    conf = opt.conf
    nhop = conf.nhop
    hh = -(-conf.halfwin_max // nhop)
    D = hh + 1                       # |d| band: window +- OLA half-width
    voiced = f0 > 0.0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    halfwidth = torch.clamp(conf.rel_winsize * conf.fs / (2.0 * f0s), 2.0,
                            float(conf.halfwin_max))
    # stride-8 midpoint quadrature of the window x crossfade products
    stride = max(min(8, nhop), 1)
    if opt.use_pallas and D <= 128:
        # the kernel reads the cycle track at the points and masks
        return kernels.deconv_full(ampl, phse, cyc, halfwidth, mask, D, nhop,
                                   stride, return_complex=return_complex)
    N = ampl.shape[1]
    K = ampl.shape[-1]
    dev = ampl.device
    nq = (2 * nhop) // stride
    r = -nhop + (torch.arange(nq, dtype=FP, device=dev) + 0.5) * stride
    w_ola = 0.5 + 0.5 * torch.cos(math.pi * r / nhop)
    d_off = torch.arange(-D, D + 1, dtype=FP, device=dev)
    n_abs = d_off[:, None] * nhop + r                       # [2D+1, nq]
    P = window_centered("hanning", n_abs, halfwidth[..., None, None]) * w_ola
    # rows sum to wsum_i / stride: the row normalization is the 1/wsum
    tot = torch.clamp(torch.sum(P, dim=(-2, -1), keepdim=True), min=1e-9)
    Pn = P / tot                                            # [B, N, 2D+1, nq]
    T_band = torch.sum(Pn, dim=-1)                          # [B, N, 2D+1]
    # k-independent AM-sideband coupling from the absolute cycle values at
    # the quadrature points
    C2 = harmonics.frame_hops(cyc, N, nhop, 1, mode="edge")
    ang = 2.0 * math.pi * C2[..., stride // 2::stride][..., :nq]
    eq = torch.polar(torch.ones_like(ang), ang)             # [B, N, nq]
    X_band = torch.stack([
        torch.sum(Pn[:, :, j] * kernels._shift_frames(eq, d), dim=-1)
        for j, d in enumerate(range(-D, D + 1))], dim=-1)   # [B, N, 2D+1]
    c, align = _aligned_track(ampl, phse, cyc[..., ::nhop][..., :N])
    # one row shift a band of c, c'_{k+1} and c'_{k-1} together
    zero = torch.zeros_like(c[..., :1])
    cat = torch.cat([c, torch.cat([c[..., 1:], zero], dim=-1),
                     torch.cat([zero, c[..., :-1]], dim=-1)], dim=-1)
    Sm = torch.zeros_like(c)
    Xc_band = X_band.conj()
    for j, d in enumerate(range(-D, D + 1)):
        sh = kernels._shift_frames(cat, d)
        Sm = Sm + T_band[..., j:j + 1] * sh[..., :K] \
            + X_band[..., j:j + 1] * sh[..., K:2 * K] \
            + Xc_band[..., j:j + 1] * sh[..., 2 * K:]
    c2 = (2.0 * c - Sm) * align.conj()
    if return_complex:
        return c2.real * mask, c2.imag * mask
    return torch.abs(c2) * mask, torch.angle(c2) * mask


# ---------------------------------------------------------------------------
# harmonic-track denoisers (JAX layer0.py:140-789, the Pallas branch)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def _hann_taps(M: int) -> tuple:
    """Normalized symmetric Hann FIR of M taps (np.hanning(M + 2)[1:-1])."""
    w = np.hanning(M + 2)[1:-1]
    return tuple((w / w.sum()).tolist())


def _align_field(cyc_c, K: int):
    """e^{-2 pi j k cyc_c} [B, N, K] for k = 1..K (mod-1 phases)."""
    kh = torch.arange(1, K + 1, dtype=FP, device=cyc_c.device)
    ph = kh * cyc_c[..., None]
    ph = ph - torch.round(ph)
    return torch.polar(torch.ones_like(ph), -2.0 * math.pi * ph)


def _aligned_track(ampl, phse, cyc_c):
    """Phase-aligned complex tracks c'_k = a e^{j phi} e^{-2 pi j k cyc_c}
    [B, N, K] and the alignment field e^{-2 pi j k cyc_c}."""
    align = _align_field(cyc_c, ampl.shape[-1])
    return torch.polar(ampl, phse) * align, align


def _aligned_track_c(cr, ci, cyc_c):
    """_aligned_track from the raw complex track (re, im): the complex
    handoff's variant (JAX layer0.py:160-168)."""
    align = _align_field(cyc_c, cr.shape[-1])
    return torch.complex(cr, ci) * align, align


def _fir(use_pallas: bool, v, taps):
    """Zero-edged FIR along the frame axis of v or of each tensor of the
    pair v: kernels.fir_frames, or with the kernels off the JAX package's
    shift-and-add chain in tap order (its jnp `fir`)."""
    if use_pallas:
        return kernels.fir_frames(v, taps)
    if not torch.is_tensor(v):
        return tuple(_fir(False, u, taps) for u in v)
    h = len(taps) // 2
    out = torch.zeros_like(v)
    for j, t in enumerate(kernels._taps32(taps)):
        out = out + t * kernels._shift_frames(v, j - h)
    return out


def _track_lowpass(conf: ChunkConf, f0, cyc_c, ampl, phse, mask,
                   cutoff_hz: float, use_pallas: bool = True):
    """Opt-in track lowpass (AnalysisOptions.track_lowpass_hz): Hann FIR of
    each harmonic's aligned complex track along frames, applied only where
    the whole filter support is voiced.  f0, cyc_c [B, N]; ampl, phse,
    mask [B, N, K] -> (ampl, phse)."""
    frame_rate = 1.0 / conf.thop
    M = int(round(frame_rate / cutoff_hz)) | 1          # odd tap count
    w = _hann_taps(M)
    c, align = _aligned_track(ampl, phse, cyc_c)
    voiced = (f0 > 0).to(FP)[..., None]
    guard, c_f = _fir(use_pallas, (voiced, c), w)
    cs = torch.where(guard > 0.999, c_f, c) * align.conj()  # guard [B, N, 1]
    return torch.abs(cs) * mask, torch.angle(cs) * mask


def _denoise_floor_stats(pp, cs2_m, r2, amp2_m, ok, *,
                         rows: int | None = None):
    """Per-utterance floor statistics of the track denoiser: [B, N, K]
    powers and the usable-slot mask ok -> (v [B, K] gate floor, wmul
    [B, K] coherent-fit weights), every sum over one utterance's frames.
    v is the Winsorized mean of pp over usable frames, zeroed with fewer
    than 16 of them, below -35 dB of the slow power, or where the slow
    track keeps under 10% of the raw energy; wmul drops noise-dominated
    tracks from the fit (JAX layer0.py:329-365 says why).  The frame sums
    run in groups of `rows` rows (default _group_rows(N)): PyTorch splits
    them by the row count."""
    rows = rows or _group_rows(pp.shape[1])
    zero = torch.zeros((), dtype=FP, device=pp.device)
    osum = lambda t: _frame_sums(torch.where(ok, t, zero), rows)
    cnt = torch.sum(ok, dim=1).to(FP)              # a count: exact
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
    # complex64 entries (the JAX package's), in CP arithmetic
    mat = lambda a: torch.as_tensor(a.astype(np.complex64),
                                    device=device).to(CP)
    return _GateDFT(
        Wf=mat(np.exp((-2j * np.pi / NPd)
                      * np.outer(np.arange(NPd), np.arange(Nd)))),
        Whigh=mat(np.exp((-2j * np.pi / NP)
                         * np.outer(high_n, np.arange(N)))),
        Wi=mat(np.exp((2j * np.pi / NPd)
                      * np.outer(np.arange(Nd), np.arange(NPd))) / NPd),
        n_high=len(high_n))


def _spectral_gate(c_s, full, pp, guard, v, mask, thop: float,
                   cutoff_hz: float, a_spec: float, decimate: int = 1, *,
                   rows: int | None = None, use_pallas: bool = True):
    """Per-frame-frequency-bin noise gate on the slow track (JAX
    layer0.py:368-599, whose docstring gives the reasons): c_s, full
    [B, N, K] complex (slow part; guarded c_s + r_inc), pp [B, N, K], guard
    [B, N, 1] bool, v [B, K], mask [B, N, K] -> the aligned-domain
    subtraction delta [B, N, K], zero on unguarded rows.  Every statistic
    (probe level, engagement, noise profile, local blend) is taken within
    one utterance.  decimate D > 1 gates at the frame rate / D by DFT
    matmuls and block-lerps the delta back; D = 1 uses FFTs.  The products
    run in complex64 (fp32, no TF32).  The transforms, products and frame
    sums, whose order the libraries choose by the row count, run in groups
    of `rows` rows (default _group_rows(N)).  The local-noisiness blend's
    frame FIRs run through _fir(use_pallas)."""
    B, N, K = c_s.shape
    D = max(int(decimate), 1)
    G = rows or _group_rows(N)
    grouped = lambda fn, t: _row_groups(fn, t, G)
    power = lambda z: z.real ** 2 + z.imag ** 2
    zero = torch.zeros((), dtype=FP, device=c_s.device)
    czero = torch.zeros((), dtype=c_s.dtype, device=c_s.device)
    if D > 1:
        mats = _gate_dft(N, D, float(thop), float(cutoff_hz), c_s.device)
        sg_d = torch.where(guard[:, ::D], c_s[:, ::D], czero)   # [B, Nd, K]
        with named_scope("llsm.analyze.residual.gate.dft"):
            # [B, NPd, K]
            Xs = grouped(lambda t: torch.matmul(mats.Wf, t), sg_d)
            lev_k = grouped(lambda t: torch.sum(power(
                torch.matmul(mats.Whigh, t)), dim=1), full) \
                / (float(max(mats.n_high, 1)) * D)
    else:
        NP = _gate_sizes(N, 1)[0]
        hb = np.abs(np.fft.fftfreq(NP, thop)) > 2.0 * cutoff_hz
        hbt = torch.as_tensor(hb, device=c_s.device)[None, :, None]
        fft = lambda t: torch.fft.fft(t, n=NP, dim=1)
        with named_scope("llsm.analyze.residual.gate.dft"):
            Xs = grouped(fft, torch.where(guard, c_s, czero))
            lev_k = grouped(lambda t: torch.sum(torch.where(
                hbt, power(fft(t)), zero), dim=1), full) \
                / float(max(hb.sum(), 1))
    Ps = power(Xs)
    # engagement stricter than the time gate's: -15 dB of the slow power
    gd = guard & (mask > 0)
    n_gd = torch.clamp(torch.sum(gd, dim=1).to(FP), min=1.0)   # exact
    p_bar = _frame_sums(torch.where(gd, power(c_s), zero), G) / n_gd
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
        with named_scope("llsm.analyze.residual.gate.dft"):
            delta_d = grouped(lambda t: torch.matmul(mats.Wi, t),
                              (g - 1.0) * Xs)                    # [B, Nd, K]
        nxt = torch.cat([delta_d[:, 1:], delta_d[:, -1:]], dim=1)
        wts = (torch.arange(D, dtype=FP, device=c_s.device) / D)[:, None]
        up = delta_d[:, :, None] * (1.0 - wts) + nxt[:, :, None] * wts
        s_dn = c_s + up.reshape(B, -1, K)[:, :N]
    else:
        with named_scope("llsm.analyze.residual.gate.dft"):
            s_dn = grouped(lambda t: torch.fft.ifft(t, dim=1),
                           g * Xs)[:, :N]

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
        num, den = _fir(use_pallas, (bmean(pp * okf), bmean(okf)), wb)
        lp = torch.repeat_interleave(num / torch.clamp(den, min=1e-9), BB,
                                     dim=1)[:, :N]
    else:
        num, den = _fir(use_pallas, (pp * okf, okf), _hann_taps(M))
        lp = num / torch.clamp(den, min=1e-9)
    w_loc = torch.clamp(3.0 * lp / torch.clamp(v[:, None, :], min=1e-30)
                        - 0.5, 0.0, 1.0)
    return torch.where(guard, w_loc * (s_dn - c_s), czero)


def _track_denoise(conf: ChunkConf, f0, cyc_c, ampl, phse, mask,
                   cutoff_hz: float, strength: float, *,
                   spectral: bool = False, a_spec: float = 3.0,
                   spec_decimate: int = 1, c_complex=None,
                   use_pallas: bool = True):
    """The dynamics-adaptive harmonic-track denoiser (AnalysisOptions.
    track_denoise).  use_pallas (the JAX Pallas branch, layer0.py:648-702):
    pass A (kernels.denoise_stats), the per-utterance floor statistics,
    pass B (kernels.denoise_apply) and, with `spectral`, the per-bin gate
    on the slow track, whose delta kernels.denoise_finish adds;
    use_pallas=False: the jnp branch (_track_denoise_plain).  f0, cyc_c
    [B, N]; ampl, phse, mask [B, N, K] -> (ampl, phse).  c_complex: the
    raw complex track (re, im) from _deconv_correction(return_complex=
    True); ampl and phse are then ignored."""
    frame_rate = 1.0 / conf.thop
    M = int(round(frame_rate / cutoff_hz)) | 1          # odd tap count
    Mp = int(round(frame_rate / (2.0 * cutoff_hz))) | 1
    taps1, taps2 = _hann_taps(M), _hann_taps(Mp)
    if not use_pallas:
        return _track_denoise_plain(conf, f0, cyc_c, ampl, phse, mask,
                                    cutoff_hz, strength, taps1, taps2,
                                    spectral=spectral, a_spec=a_spec,
                                    spec_decimate=spec_decimate,
                                    c_complex=c_complex)
    with named_scope("llsm.analyze.residual.stats"):
        voiced = (f0 > 0).to(FP)
        if c_complex is not None:
            (pp, cs2, r2, guard, cre, cim, csr, csi) = kernels.denoise_stats(
                c_complex[0], c_complex[1], cyc_c, mask, voiced, taps1,
                taps2, complex_input=True)
            amp2_m = (cre * cre + cim * cim) * mask
        else:
            (pp, cs2, r2, guard, cre, cim, csr, csi) = kernels.denoise_stats(
                ampl, phse, cyc_c, mask, voiced, taps1, taps2)
            amp2_m = ampl * ampl * mask
    with named_scope("llsm.analyze.residual.floor"):
        ok = guard[..., None] & (mask > 0)
        v, wmul = _denoise_floor_stats(pp, cs2 * mask, r2, amp2_m, ok)
    with named_scope("llsm.analyze.residual.apply"):
        if not spectral:
            return kernels.denoise_apply(cre, cim, csr, csi, cyc_c, mask,
                                         guard, v, wmul, float(strength))
        # the gated track stays aligned until the finish adds the gate's
        # delta
        a, full = kernels.denoise_apply(cre, cim, csr, csi, cyc_c, mask,
                                        guard, v, wmul, float(strength),
                                        spectral=True)
    with named_scope("llsm.analyze.residual.gate"):
        delta = _spectral_gate(torch.complex(csr, csi), full, pp,
                               guard[..., None], v, mask, conf.thop,
                               cutoff_hz, a_spec, decimate=spec_decimate)
    with named_scope("llsm.analyze.residual.apply"):
        return kernels.denoise_finish(a, delta, cyc_c, mask)


def _coherent_fit(c_s, r, wgt):
    """Per-frame weighted least-squares fit across k of the fast residual
    r ~ (m0 + m1 k) c_s, weights wgt [B, N, K] (layer0.py:722-735 and
    :763-775) -> the coherent part [B, N, K]."""
    kh = torch.arange(1, c_s.shape[-1] + 1, dtype=FP, device=c_s.device)
    p = (c_s.real ** 2 + c_s.imag ** 2) * wgt
    cr = c_s.conj() * r * wgt
    a00 = torch.sum(p, dim=-1)
    a01 = torch.sum(kh * p, dim=-1)
    a11 = torch.sum(kh * kh * p, dim=-1)
    b0 = torch.sum(cr, dim=-1)
    b1 = torch.sum(kh * cr, dim=-1)
    det = a00 * a11 - a01 * a01
    den = det + (1e-5 * a00 * a11 + 1e-12)
    m0 = (a11 * b0 - a01 * b1) / den
    m1 = (a00 * b1 - a01 * b0) / den
    return (m0[..., None] + m1[..., None] * kh) * c_s


def _track_denoise_plain(conf: ChunkConf, f0, cyc_c, ampl, phse, mask,
                         cutoff_hz: float, strength: float, taps1, taps2, *,
                         spectral: bool, a_spec: float, spec_decimate: int,
                         c_complex):
    """The track denoiser's jnp branch (JAX layer0.py:703-789): slow track
    by the Hann FIR along frames, the voicing guard, the coherent fit, the
    probe-band power, the floor statistics, the weighted fit and the
    Wiener gate, then with `spectral` the per-bin gate's delta, in the
    JAX package's order; the FIRs are shift-and-add chains (_fir(False))."""
    if c_complex is not None:
        c, align = _aligned_track_c(c_complex[0], c_complex[1], cyc_c)
    else:
        c, align = _aligned_track(ampl, phse, cyc_c)
    m = mask.to(FP)
    c_s = _fir(False, c, taps1)
    guard = _fir(False, (f0 > 0).to(FP)[..., None], taps1) > 0.999  # [B, N, 1]
    r = c - c_s
    power = lambda z: z.real ** 2 + z.imag ** 2
    r_inc = r - _coherent_fit(c_s, r, m)
    r_probe = r_inc - _fir(False, r_inc, taps2)
    pp = power(r_probe)
    with named_scope("llsm.analyze.residual.floor"):
        ok = guard & (m > 0)
        v, wmul = _denoise_floor_stats(pp, power(c_s) * m, power(r),
                                       power(c) * m, ok)
    # second, weighted fit (wmul drops noise-dominated tracks)
    r_coh = _coherent_fit(c_s, r, m * wmul[:, None, :])
    r_inc = r - r_coh
    g = torch.clamp(1.0 - strength * v[:, None, :] / (power(r_inc) + 1e-20),
                    0.0, 1.0)
    out = c_s + r_coh + g * r_inc
    if spectral:
        czero = torch.zeros((), dtype=c.dtype, device=c.device)
        with named_scope("llsm.analyze.residual.gate"):
            out = out + _spectral_gate(
                c_s, torch.where(guard, c_s + r_inc, czero), pp, guard, v,
                mask, conf.thop, cutoff_hz, a_spec, decimate=spec_decimate,
                use_pallas=False)
    out = torch.where(guard, out, c) * align.conj()
    return torch.abs(out) * mask, torch.angle(out) * mask


def _moving_sum(v: torch.Tensor, S: int) -> torch.Tensor:
    """jnp.convolve(v, ones(S), mode="same") along the last axis, as a
    zero-padded windowed sum (no cuDNN, so no TF32 on the card)."""
    vp = torch.nn.functional.pad(v, (S // 2, (S - 1) // 2))
    return vp.unfold(-1, S, 1).sum(dim=-1)


def _residual(use_pallas: bool, cyc, ampl, phse, mask, nhop: int, x):
    """x minus the harmonic render of (ampl, phse, mask): one
    kernels.osc_bank launch, or the plain oscillator bank and its OLA."""
    if use_pallas:
        return kernels.osc_bank(cyc, ampl, phse, mask, nhop, x)
    segs = harmonics.oscillator_bank(cyc, ampl, phse, mask, nhop=nhop)
    return x - harmonics.overlap_add_half(segs, nhop, x.shape[-1])


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
        with named_scope("llsm.analyze.refine"):
            f0_ref = harmonics.refine_f0(
                x, f0, nhop=nhop, fs=conf.fs, halfwin_max=conf.halfwin_max,
                rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil,
                use_pallas=opt.use_pallas)
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

    with named_scope("llsm.cycles"):
        cyc = harmonics.sample_cycles(f0, nhop, conf.fs, nx)

    # harmonic pass: zoomed chirped projection, or FFT peak-picking
    hkw = dict(nhop=nhop, fs=conf.fs, max_k=conf.maxnhar,
               halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
               fnyq=conf.fnyq)
    project = functools.partial(
        harmonics.harmonic_analysis, **hkw, mxu=opt.hm_kernel == "matmul",
        use_pallas=opt.use_pallas, frame_chunk=opt.frame_chunk)
    with named_scope("llsm.analyze.harmonic"):
        if opt.hm_method == "pp":
            ampl, phse, mask = harmonics.harmonic_peak_pick(x, f0, **hkw)
        else:
            ampl, phse, mask = project(x, f0, cyc)

    # residual: deconvolve the track smoothing (handing the complex track
    # to the denoiser) or re-analyze the residual (Gauss-Seidel passes),
    # denoise, subtract the harmonic part
    with named_scope("llsm.analyze.residual"):
        cplx = None
        with named_scope("llsm.analyze.residual.deconv"):
            if _complex_handoff(opt):
                cplx = _deconv_correction(opt, f0, cyc, ampl, phse, mask,
                                          return_complex=True)
            elif (opt.hm_correction == "deconv" and opt.hm_passes <= 1
                  and opt.hm_method == "czt"):
                ampl, phse = _deconv_correction(opt, f0, cyc, ampl, phse,
                                                mask)
        for _ in range(max(opt.hm_passes - 1, 0)):
            da, dp, _ = project(_residual(opt.use_pallas, cyc, ampl, phse,
                                          mask, nhop, x), f0, cyc)
            z = torch.polar(ampl, phse) + torch.polar(da, dp)
            ampl, phse = torch.abs(z) * mask, torch.angle(z) * mask
        # read by 2 kernels
        cyc_c = cyc[..., ::nhop][..., :nfrm].contiguous()
        # the denoisers run after the passes, which would re-project the
        # noise
        if opt.track_denoise and opt.track_lowpass_hz <= 0.0:
            ampl, phse = _track_denoise(
                conf, f0, cyc_c, ampl, phse, mask, opt.track_denoise_hz,
                opt.track_denoise_strength,
                spectral=opt.track_denoise_spectral,
                a_spec=opt.track_spectral_strength,
                spec_decimate=opt.track_spectral_decimate, c_complex=cplx,
                use_pallas=opt.use_pallas)
        if opt.track_lowpass_hz > 0.0:
            ampl, phse = _track_lowpass(conf, f0, cyc_c, ampl, phse, mask,
                                        opt.track_lowpass_hz,
                                        use_pallas=opt.use_pallas)
        with named_scope("llsm.analyze.residual.render"):
            residual = _residual(opt.use_pallas, cyc, ampl, phse, mask,
                                 nhop, x)

    # noise pass: band envelopes (at the decimated rate fs/D) + warped PSD
    with named_scope("llsm.analyze.noise"):
        D = _env_decimation(conf, opt.env_decimate, nx)
        with named_scope("llsm.analyze.noise.envelopes"):
            envs = _band_envelopes(residual, conf, D)      # [B, C, nx/D]
        Cn, Ke = conf.nchannel, conf.maxnhar_e
        # each channel's row of envs reads its utterance's cycle track
        with named_scope("llsm.analyze.noise.project"):
            ea, ep, _, edc = harmonics.harmonic_analysis(
                envs.reshape(B * Cn, -1),
                torch.repeat_interleave(f0, Cn, dim=0), cyc[:, ::D],
                nhop=nhop // D, fs=conf.fs / D, max_k=Ke,
                halfwin_max=-(-conf.halfwin_max // D),
                rel_winsize=conf.rel_winsize,
                fnyq=min(conf.fnyq, 0.4 * conf.fs / D), with_dc=True,
                use_pallas=opt.use_pallas, frame_chunk=opt.frame_chunk)
        edc = torch.clamp(edc, min=0.0).reshape(B, Cn, nfrm)
        edc = edc.transpose(1, 2)
        eenv_a = ea.reshape(B, Cn, nfrm, Ke).transpose(1, 2)  # [B, N, C, Ke]
        eenv_p = ep.reshape(B, Cn, nfrm, Ke).transpose(1, 2)
        with named_scope("llsm.analyze.noise.psd"):
            psd = _warped_psd(residual, nfrm, conf, rows=_group_rows(nfrm))
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
    noise synthesis -- envelope reconstruction).  use_pallas renders
    through kernels.env_render (a cut render, nx < N * nhop, included);
    otherwise the JAX package's jnp lerp (layer0.py:1008-1041), a row at a
    time."""
    N = chunk.f0.shape[-1]
    nx = cyc.shape[-1]
    centers = torch.clamp(torch.arange(N, device=cyc.device) * nhop,
                          max=nx - 1)
    coefs = _env_coefs(chunk, cyc[..., centers])
    if use_pallas:
        return kernels.env_render(cyc, *coefs, nhop=nhop)
    return harmonics.each_row(
        lambda c, e, ar, ai, b: _lerp_envelopes(c[0], e[0], ar[0], ai[0],
                                                b[0], nhop), cyc, *coefs)


def _lerp_envelopes(cyc, edc, ar, ai, base, nhop: int):
    """One row of the jnp envelope render: the coefficients lerped between
    frames i and i + 1 over frame i's samples (the last frame constant),
    the envelope harmonics by a rotation ladder from e^{2 pi j cyc} ->
    (env, base) [1, C, nx]."""
    N = edc.shape[0]
    nx = cyc.shape[-1]
    t = torch.arange(nhop, dtype=FP, device=cyc.device) / nhop

    def lerp(a):  # [N, ...] -> [nx, ...]
        tt = t.reshape((1, nhop) + (1,) * (a.dim() - 1))
        out = a[:-1, None] + tt * (a[1:] - a[:-1])[:, None]
        out = out.reshape(((N - 1) * nhop,) + a.shape[1:])
        tail = a[-1:].expand((nhop,) + a.shape[1:])
        return torch.cat([out, tail])[:nx]

    ph1 = 2.0 * math.pi * (cyc - torch.round(cyc))
    c1, s1 = torch.cos(ph1), torch.sin(ph1)
    osc_c, osc_s = [c1], [s1]
    for _ in range(ar.shape[-1] - 1):
        osc_c.append(osc_c[-1] * c1 - osc_s[-1] * s1)
        osc_s.append(osc_c[-2] * s1 + osc_s[-1] * c1)
    osc_c = torch.stack(osc_c, dim=-1)[:, None, :]          # [nx, 1, Ke]
    osc_s = torch.stack(osc_s, dim=-1)[:, None, :]
    env = lerp(edc) + torch.sum(lerp(ar) * osc_c - lerp(ai) * osc_s, dim=-1)
    return (torch.clamp(env, min=0.0).T[None],
            torch.clamp(lerp(base), min=1e-8).T[None])


def _band_segments(shaped: torch.Tensor, masks: torch.Tensor,
                   w: torch.Tensor, T: int, idft: str) -> torch.Tensor:
    """Windowed per-band time segments [B, C, N, T] from the shaped noise
    spectra [B, N, nbin] (JAX layer0.py:1044-1100), a row at a time:
    idft="matmul" the inverse DFT as a contraction with the window and
    band masks folded in (kernels._band_segments); "fft" the reference
    path, two bands' real inverse transforms in one complex inverse FFT
    (the bands are disjoint: band c0 in the real part, c1 in the
    imaginary part), a last odd band by an irfft."""
    if idft == "matmul":
        return harmonics.each_row(
            lambda z: kernels._band_segments(z, masks, w, T), shaped)
    if idft != "fft":
        raise ValueError(f"noise_idft must be 'matmul' or 'fft', not {idft!r}")
    # the Hermitian spectrum of T bins from its nbin = T/2 + 1 one-sided
    full = lambda z: torch.cat([z, z[..., 1:-1].flip(-1).conj()], dim=-1)

    def row(z):
        z = z[0]                                           # [N, nbin]
        segs = []
        for c in range(0, masks.shape[0] - 1, 2):
            pair = torch.fft.ifft(full(z * masks[c]) + 1j * full(z * masks[c + 1]),
                                  n=T)
            segs += [pair.real * w, pair.imag * w]
        if masks.shape[0] % 2:
            segs.append(torch.fft.irfft(z * masks[-1], n=T) * w)
        return torch.stack(segs)[None]

    return harmonics.each_row(row, shaped)


def _synth_noise(chunk: Chunk, cyc: torch.Tensor, nhop: int, fs: float,
                 noise_seed: int, bins=None, frame_base: int = 0, *,
                 use_pallas: bool = True,
                 idft: str = "matmul") -> torch.Tensor:
    """Noise component of a batched chunk [B, N, ...] -> [B, N*nhop]: each
    frame's white-noise spectrum is shaped by sqrt(PSD), band-split,
    windowed back to time, overlap-added and modulated by the temporal
    envelopes (reference: layer0.c noise synthesis).  With use_pallas and
    idft="matmul" one kernels.noise_mod_ola launch does all past the
    shaping gain; with idft="fft" the FFT branch's segments go to
    kernels.noise_mod_ola_seg; with the kernels off, the JAX package's
    jnp tail (layer0.py:1190-1195).

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

    if bins is None and FP64:
        # JAX's x64 draw (the plain version, chosen by the knob)
        re, im = kernels.noise_bins_ref(noise_seed, frame_base, B, N, nbin,
                                        dev, dtype=torch.float64)
    elif bins is None:
        re, im = kernels.noise_bins(noise_seed, frame_base, B, N, nbin, dev)
    else:
        re, im = (v.to(dev, FP) if torch.is_tensor(v) else
                  torch.tensor(np.asarray(v), dtype=FP, device=dev)
                  for v in bins)
        if re.shape != (B, N, nbin) or im.shape != (B, N, nbin):
            raise ValueError(f"bins must be [{B}, {N}, {nbin}] each")
    edc, ar, ai, base = _env_coefs(chunk, cyc[..., ::nhop][..., :N])
    bands = kernels.band_ranges(nbin, float(fs), tuple(conf.chan_edges))
    if use_pallas and idft == "matmul":
        # the kernel shapes the spectra (scale, DC and Nyquist real), takes
        # each band's windowed inverse DFT and overlap-adds, modulates and
        # sums the bands
        return kernels.noise_mod_ola(cyc, edc, ar, ai, base, re, im, gain,
                                     bands)
    # the shaped spectra: variance-T bins, DC and Nyquist real
    scale = torch.full((nbin,), math.sqrt(T / 2.0), dtype=FP, device=dev)
    scale[0] = scale[-1] = math.sqrt(float(T))
    im_scale = scale.clone()
    im_scale[0] = im_scale[-1] = 0.0
    shaped = torch.complex(re * scale, im * im_scale) * gain
    k = torch.arange(nbin, device=dev)
    masks = torch.stack([((k >= lo) & (k < hi)).to(FP)
                         for lo, hi in zip(bands[::2], bands[1::2])])
    # sqrt-Hann WOLA pair: perfect reconstruction at 50% overlap
    w = torch.sqrt(0.5 - 0.5 * torch.cos(
        2.0 * math.pi * (torch.arange(T, dtype=FP, device=dev) + 0.5) / T))
    segs = _band_segments(shaped, masks, w, T, idft)         # [B, C, N, T]
    if use_pallas:
        return kernels.noise_mod_ola_seg(cyc, edc, ar, ai, base, segs)
    env, base_s = _render_envelopes(chunk, cyc, nhop)
    y = torch.zeros_like(cyc)
    for c in range(segs.shape[1]):
        band = harmonics.overlap_add_half(segs[:, c], nhop, cyc.shape[-1])
        y = y + band * (env[:, c] / base_s[:, c])
    return y


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
    with named_scope("llsm.cycles"):
        cyc = harmonics.sample_cycles(chunk.f0, nhop, fs, nx)
    K = chunk.ampl.shape[-1]
    kharm = torch.arange(1, K + 1, dtype=FP, device=cyc.device)
    f0s = torch.where(chunk.f0 > 0, chunk.f0, torch.full_like(chunk.f0, 100.0))
    hm_mask = chunk.hm_mask * (kharm * f0s[..., None] < 0.5 * fs)
    with named_scope("llsm.synth.harmonic"):
        if opt.use_pallas:
            y_sin = kernels.osc_bank(cyc, chunk.ampl, chunk.phse, hm_mask,
                                     nhop)
        else:
            y_sin = harmonics.overlap_add_half(harmonics.oscillator_bank(
                cyc, chunk.ampl, chunk.phse, hm_mask, nhop=nhop), nhop, nx)
    with named_scope("llsm.synth.noise"):
        y_nos = _synth_noise(chunk, cyc, nhop, fs, opt.noise_seed,
                             bins=bins, use_pallas=opt.use_pallas,
                             idft=opt.noise_idft)
    return SynthResult(y=y_sin + y_nos, y_sin=y_sin, y_nos=y_nos, fs=fs)


# ---------------------------------------------------------------------------
# batched entry points (public API over the batched pipeline)
# ---------------------------------------------------------------------------

def analyze_batch(opt: AnalysisOptions, x, f0, device=None) -> Chunk:
    """Batched analysis: x [B, nx], f0 [B, nfrm] -> chunk with a leading
    batch axis; x at conf.fs (no resampling, as the JAX package's
    analyze_batch).  A tensor x stays on its device; numpy input goes to
    the card ("cuda"; pass device="cpu" for the CPU -- without a card the
    default raises)."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    x = torch.as_tensor(x, device=device).to(FP)
    return _analyze(opt, x, torch.as_tensor(f0, device=x.device).to(FP))


def synthesize_batch(opt: SynthesisOptions, chunk: Chunk) -> SynthResult:
    """Batched synthesis of a chunk with a leading batch axis, on the
    chunk's device."""
    return _synthesize(opt, chunk)
