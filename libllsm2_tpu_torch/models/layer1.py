"""Layer-1 codec of the PyTorch port: source-filter re-parameterization of
layer-0 frames (counterpart of libllsm2_tpu/models/layer1.py; reference:
layer1.c -> llsm_chunk_tolayer1 / llsm_chunk_tolayer0).

Per voiced frame: fit the LF glottal model's Rd from the harmonic phases'
deviation from minimum phase (a grid search over a precomputed Rd table,
a continuity-regularized Viterbi path over frames, one IRLS pass and a
parabolic refinement); divide source and lip radiation out of the
harmonic amplitudes to get the vocal-tract log-magnitude envelope on
nspec bins (with a fixed-point correction that makes linear interpolation
reproduce the measured values); keep the measured phase's residual
against the tract's minimum phase + LF phase as the voice-source phase.
The JAX package's docstrings give the measurements behind each choice.

Functions take a leading batch axis [B] where the JAX package takes one
utterance; the public chunk_to_layer1 / chunk_to_layer0 take either a
single chunk or a batched one.  vtmagn is the LOG magnitude on the rfft
grid of nfft = 2 (nspec - 1), as in the JAX package.  No kernel runs
here: the fit is float32 tensor code (TF32 must stay off on the card).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..container import Chunk, index_batch
from ..fp import CP, FP, FP64
from ..ops import interp, kernels, lf, spectral
from . import layer0

SPEED_OF_SOUND = 343.0
RD_GRID_SIZE = 64
RD_SRC_ROWS = 513   # Rd rows of _source_at_harmonics' tables
RD_MIN, RD_MAX = 0.1, 3.0
RD_FIT_HARMONICS = 10
LOG_FLOOR = -23.0  # ~ -200 dB
RD_PHASE_HARMONICS = 12
RD_PHASE_TGRID = 64
# elements of fit_rd_phase's [rows, N, G, T] complex score per row group
_SCORE_ELEMS = 1 << 27


def _rd_grid(device=None) -> torch.Tensor:
    return torch.exp(torch.linspace(math.log(RD_MIN), math.log(RD_MAX),
                                    RD_GRID_SIZE, dtype=FP, device=device))


@functools.lru_cache(maxsize=8)
def _source_tables_np(max_k: int, rows: int):
    """For a log-spaced Rd grid of `rows` points: (grid [rows], LF source
    log magnitude [rows, K], phase [rows, K]) at harmonics 1..max_k,
    normalized to a unit fundamental, computed once in float32 on the CPU.
    The phase is unwrapped along Rd on a >= 1024-interval grid, then
    sampled every FINE-th row (consumers interpolate between rows)."""
    fine = max(1, 1024 // (rows - 1))
    gf = torch.exp(torch.linspace(math.log(RD_MIN), math.log(RD_MAX),
                                  fine * (rows - 1) + 1, dtype=FP))
    params = lf.lf_from_rd(gf).map(lambda a: a[:, None])
    spec = lf.lf_spectrum(torch.arange(1, max_k + 1, dtype=FP)[None, :],
                          params)                              # [Gf, K]
    spec = spec / torch.clamp(torch.abs(spec[:, :1]), min=1e-12)
    logmag = torch.log(torch.clamp(torch.abs(spec), min=1e-12))
    phase = np.unwrap(torch.angle(spec).numpy(), axis=0)[::fine]
    grid = np.exp(np.linspace(np.log(RD_MIN), np.log(RD_MAX),
                              rows)).astype(np.float32)
    return grid, logmag.numpy()[::fine], phase.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _source_tables(max_k: int, rows: int = RD_GRID_SIZE, device=None):
    """_source_tables_np as tensors on `device` (cached per device)."""
    return tuple(torch.as_tensor(a, device=device)
                 for a in _source_tables_np(max_k, rows))


def lip_radiation_logmag(f, lip_radius: float) -> torch.Tensor:
    """Log magnitude of the lip radiation load |L| ~ omega r / c (phase
    +pi/2, a differentiator)."""
    return torch.log(torch.clamp(2.0 * math.pi * f * lip_radius
                                 / SPEED_OF_SOUND, min=1e-12))


def minphase_rows(logmag: torch.Tensor) -> torch.Tensor:
    """spectral.minphase_phase of log magnitudes [B, N, nspec] in calls of
    layer0._group_rows(N) rows, the last zero-padded: cuFFT plans follow
    the transform count, so a row's phase does not depend on its batch."""
    return layer0._row_groups(spectral.minphase_phase, logmag,
                              layer0._group_rows(logmag.shape[-2]))


def _pseudo_mp(logmag: torch.Tensor) -> torch.Tensor:
    """Minimum phase on the harmonic-index pseudo-grid: logmag [B, N, K] at
    harmonics 1..K as a uniform spectrum (bin 0 repeats k = 1) -> phase at
    1..K."""
    M = torch.cat([logmag[..., :1], logmag], dim=-1)
    return minphase_rows(M)[..., 1:]


@functools.lru_cache(maxsize=8)
def _phase_dev_tables_np(max_k: int) -> np.ndarray:
    _, src_logmag, src_phase = (torch.as_tensor(a) for a in
                                _source_tables_np(max_k, RD_GRID_SIZE))
    kh = torch.arange(1, max_k + 1, dtype=FP)
    model_logmag = src_logmag + torch.log(kh)[None, :]       # + lip tilt
    return (src_phase + 0.5 * math.pi - _pseudo_mp(model_logmag)).numpy()


@functools.lru_cache(maxsize=16)
def _phase_dev_tables(max_k: int, device=None) -> torch.Tensor:
    """Model phase-deviation table [G, K]: each grid Rd's LF source (plus
    lip radiation) minus the minimum phase of its own magnitude, on the
    pseudo-grid of the measurement."""
    return torch.as_tensor(_phase_dev_tables_np(max_k), device=device)


def _rd_viterbi(score: torch.Tensor, voiced: torch.Tensor,
                lam: float) -> torch.Tensor:
    """Continuity-regularized Rd grid path per utterance: maximize
    sum_n score[n, g_n] - lam sum_n (log rd[g_n] - log rd[g_{n-1}])^2 by
    Viterbi.  score [B, N, G], voiced [B, N] -> grid indices [B, N]
    (int64).  Unvoiced frames observe nothing.  Ties go to the first
    maximum, as jnp.argmax's.  On the card the forward scan and the
    backtrace are one launch of kernels.viterbi_scan with lt = -pen
    (c + (-pen) has the bits of c - pen); under LLSM_FP64=1 its plain twin
    runs."""
    G = score.shape[-1]
    dev = score.device
    dstep = (torch.log(torch.tensor(RD_MAX, dtype=FP))
             - torch.log(torch.tensor(RD_MIN, dtype=FP))) / (G - 1)
    ar = torch.arange(G, device=dev)
    di = (ar[:, None] - ar[None, :]).to(FP)
    pen = lam * (di * dstep.to(dev)) ** 2                   # [G(prev), G]
    obs = torch.where(voiced[..., None], score, torch.zeros_like(score))
    if FP64:
        return kernels.viterbi_scan_ref(obs, -pen, False)
    return kernels.viterbi_scan(obs, -pen, False)


def _wrap(ph: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(ph), torch.cos(ph))


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[..., i] along the last axis with i of a's leading shape."""
    return torch.gather(a, -1, i[..., None])[..., 0]


def _resonance_dev(f0: torch.Tensor, K: int, fc: float, bw: float,
                   fs: float, sign: float) -> torch.Tensor:
    """Phase-deviation contribution, at the harmonics of f0 [B, N], of an
    under-resolved second-order section: the section's true phase minus
    the minimum phase of its harmonic-sampled log magnitude (what
    _pseudo_mp recovers on its own) -> [B, N, K].  sign -1: a resonance
    (pole pair, e.g. a sharp F1 between harmonics); +1: an antiformant
    (zero pair, the nasal side-branch null).  It tends to zero where the
    sampling resolves the section (JAX layer1._resonance_dev)."""
    kh = torch.arange(1, K + 1, dtype=FP, device=f0.device)
    fk = kh * torch.clamp(f0, min=1.0)[..., None]
    r = torch.exp(torch.tensor(-math.pi * bw / fs, dtype=FP))
    c1 = 2.0 * r * torch.cos(torch.tensor(2.0 * math.pi * fc / fs, dtype=FP))
    z1 = torch.polar(torch.ones_like(fk), (-2.0 * math.pi) * fk / fs)
    H = 1.0 - c1.to(f0.device) * z1 + (r * r).to(f0.device) * z1 * z1
    zlm = torch.log(torch.clamp(torch.abs(H), min=1e-9))
    return sign * (torch.angle(H) - _pseudo_mp(zlm))


def _fit_weights(log_ampl, mask, f0, fcap: float):
    """The phase fit's amplitude weights [B, N, KF] with the low-frequency
    cap (at least 3 harmonics kept)."""
    K = log_ampl.shape[-1]
    KF = min(RD_PHASE_HARMONICS, K)
    w0 = (mask * torch.exp(log_ampl))[..., :KF]
    if f0 is not None and fcap > 0.0:
        khf = torch.arange(1, KF + 1, dtype=FP, device=log_ampl.device)
        keep = (khf * torch.clamp(f0, min=1.0)[..., None] < fcap) \
            | (khf <= 3.0)
        w0 = w0 * keep
    return w0


def fit_rd_phase(log_ampl: torch.Tensor, phse: torch.Tensor,
                 mask: torch.Tensor, f0: torch.Tensor | None = None,
                 fcap: float = 1000.0, smooth: float = 10.0,
                 dev_corr: torch.Tensor | None = None) -> torch.Tensor:
    """Rd per frame from the harmonic PHASE deviation from minimum phase
    (JAX layer1.fit_rd_phase; its docstring gives the identification
    principle and the measured choices).  log_ampl, phse, mask [B, N, K]
    (raw log amplitudes, lip radiation included); f0 [B, N]; smooth: the
    Viterbi continuity weight (0: per-frame argmax) -> rd [B, N].  The
    [B, N, G, T] phase-ramp score is formed for groups of rows so its
    temporaries stay near 1 GB."""
    dev = log_ampl.device
    B, N, K = log_ampl.shape
    G, T = RD_GRID_SIZE, RD_PHASE_TGRID
    KF = min(RD_PHASE_HARMONICS, K)
    dmodel = _phase_dev_tables(K, dev)                        # [G, K]
    dmeas = phse - _pseudo_mp(log_ampl)                       # [B, N, K]
    if dev_corr is not None:
        dmeas = dmeas - dev_corr
    w0 = _fit_weights(log_ampl, mask, f0, fcap)
    diff = dmeas[..., None, :KF] - dmodel[:, :KF]             # [B, N, G, KF]
    theta = torch.arange(T, dtype=FP, device=dev) * (2.0 * math.pi / T)
    kf = torch.arange(1, KF + 1, dtype=FP, device=dev)
    ang = -kf[None, :] * theta[:, None]                       # [T, KF]
    basis_t = torch.complex(torch.cos(ang), torch.sin(ang)).T.contiguous()
    ediff = torch.polar(torch.ones_like(diff), diff)
    rows = max(1, _SCORE_ELEMS // max(N * G * T, 1))

    def solve(w):
        wn = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
        score = torch.empty((B, N, G), dtype=FP, device=dev)
        t_arg = torch.empty((B, N, G), dtype=torch.int64, device=dev)
        p = torch.empty((B, N, G), dtype=FP, device=dev)
        for s in range(0, B, rows):
            c = wn[s:s + rows, :, None, :].to(CP) * ediff[s:s + rows]
            sc_t = torch.abs(torch.matmul(c, basis_t))        # [b, N, G, T]
            # circular parabolic refinement of the phase-ramp score
            ta = torch.argmax(sc_t, dim=-1)
            sm = _take(sc_t, (ta - 1) % T)
            s0 = _take(sc_t, ta)
            sp = _take(sc_t, (ta + 1) % T)
            del sc_t
            den = sm - 2.0 * s0 + sp
            den = torch.where(torch.abs(den) < 1e-12,
                              torch.full_like(den, -1e-12), den)
            pp = torch.clamp(0.5 * (sm - sp) / den, -0.5, 0.5)
            score[s:s + rows] = s0 - 0.25 * (sm - sp) * pp
            t_arg[s:s + rows] = ta
            p[s:s + rows] = pp
        return score, t_arg, p

    voiced = (f0 > 0) if f0 is not None \
        else torch.ones((B, N), dtype=torch.bool, device=dev)

    def choose(score, t_arg, p):
        g = _rd_viterbi(score, voiced, smooth) if smooth > 0.0 \
            else torch.argmax(score, dim=-1)
        theta_best = (_take(t_arg, g).to(FP) + _take(p, g)) \
            * (2.0 * math.pi / T)
        return g, theta_best

    g, theta_best = choose(*solve(w0))
    # one IRLS pass: Cauchy-downweight phase-residual outliers (sigma 0.5
    # rad) at the first fit's optimum, after removing the free common phase
    idx = g[..., None, None].expand(B, N, 1, KF)
    res = torch.gather(diff, 2, idx)[:, :, 0] - kf * theta_best[..., None]
    wn0 = w0 / torch.clamp(torch.sum(w0, dim=-1, keepdim=True), min=1e-9)
    phi = torch.angle(torch.sum(wn0 * torch.polar(torch.ones_like(res), res),
                                dim=-1, keepdim=True))
    res = _wrap(res - phi)
    w1 = w0 / (1.0 + (res / 0.5) ** 2)
    score, t_arg, p = solve(w1)
    g, _ = choose(score, t_arg, p)
    gf, _ = spectral.qifft(score, g)
    log_grid = torch.log(_rd_grid(dev))
    knots = torch.arange(G, dtype=FP, device=dev)
    return torch.exp(interp.interp(gf.reshape(1, -1), knots[None],
                                   log_grid[None]).reshape(B, N))


def _source_at_harmonics(rd: torch.Tensor, max_k: int):
    """The 513-row Rd tables interpolated at per-frame rd (clamped into the
    grid) -> (logmag [..., K], phase [..., K])."""
    grid, src_logmag, src_phase = _source_tables(max_k, RD_SRC_ROWS,
                                                 rd.device)
    rd = torch.clamp(rd, RD_MIN, RD_MAX)
    lg0, lg1 = torch.log(grid[0]), torch.log(grid[-1])
    pos = (torch.log(rd) - lg0) / (lg1 - lg0) * (RD_SRC_ROWS - 1)
    pos = torch.clamp(pos, 0.0, RD_SRC_ROWS - 1.0)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, RD_SRC_ROWS - 2)
    frac = (pos - i0)[..., None]
    lerp = lambda t: t[i0] + (t[i0 + 1] - t[i0]) * frac
    return lerp(src_logmag), lerp(src_phase)


def _harmonic_freqs(chunk: Chunk):
    """(voiced [B, N], fk [B, N, K]) with unvoiced frames at 100 Hz."""
    voiced = chunk.f0 > 0
    f0s = torch.where(voiced, chunk.f0, torch.full_like(chunk.f0, 100.0))
    K = chunk.ampl.shape[-1]
    kh = torch.arange(1, K + 1, dtype=FP, device=chunk.f0.device)
    return voiced, kh * f0s[..., None]


def _hold_last(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked slots take the value of slot sum(mask) - 1 (at least 0)."""
    last = torch.clamp(torch.sum(mask, dim=-1).to(torch.int64) - 1, min=0)
    return torch.where(mask > 0, v, torch.gather(v, -1, last[..., None]))


def _batched(fn):
    """Let fn (on a batched chunk) take a single-utterance chunk too."""
    @functools.wraps(fn)
    def wrapper(chunk: Chunk, *args, **kw):
        if chunk.f0.dim() > 1:
            return fn(chunk, *args, **kw)
        return index_batch(fn(index_batch(chunk, None), *args, **kw), 0)
    return wrapper


@_batched
def chunk_to_layer1(chunk: Chunk, nfft: int | None = None,
                    sections: tuple | None = None) -> Chunk:
    """Attach layer-1 parameters (rd [B, N], vtmagn [B, N, nspec], vsphse
    [B, N, K]) to a layer-0 chunk (reference: layer1.c ->
    llsm_chunk_tolayer1(chunk, nfft)).  nfft sets the envelope resolution
    (nfft // 2 + 1 bins; default conf.nspec); chunk_to_layer0 reads it back
    from vtmagn's shape.  sections: ((fc_hz, bw_hz, sign), ...) known sharp
    tract sections for the Rd fit (sign -1 a pole, +1 a zero;
    fit_rd_sections), which recover Rd where a sharp F1 or antiformant
    falls between harmonics (sustained nasals at f0 above ~180 Hz)."""
    conf = chunk.conf
    nspec = (int(nfft) // 2 + 1) if nfft else conf.nspec
    mask = chunk.hm_mask
    voiced, fk = _harmonic_freqs(chunk)
    zero = torch.zeros((), dtype=FP, device=fk.device)
    log_ampl = torch.where(mask > 0,
                           torch.log(torch.clamp(chunk.ampl, min=1e-10)),
                           torch.full_like(chunk.ampl, LOG_FLOOR))
    lip_logmag = lip_radiation_logmag(fk, conf.lip_radius)
    # masked slots hold the last valid value, so the pseudo-grid minimum
    # phase does not see the LOG_FLOOR cliff
    held = _hold_last(log_ampl, mask)
    if sections:
        rd = fit_rd_sections(held, chunk.phse, mask, chunk.f0, conf.fs,
                             sections)
    else:
        rd = fit_rd_phase(held, chunk.phse, mask, chunk.f0)
    rd = torch.where(voiced, rd, torch.ones_like(rd))
    src_logmag, src_phase = _source_at_harmonics(rd, fk.shape[-1])

    # vocal-tract log magnitude at the harmonics, held past the last valid
    # one, resampled onto the uniform nspec grid
    vt_k = _hold_last(log_ampl - src_logmag - lip_logmag, mask)
    fbins = torch.linspace(0.0, conf.fs / 2.0, nspec, dtype=FP,
                           device=fk.device)
    pos_k = fk / (conf.fs / 2.0) * (nspec - 1)
    vtmagn = interp.interp(fbins, fk, vt_k)
    # fixed-point correction: the grid evaluated back at the harmonics (as
    # chunk_to_layer0 does) reproduces the measured values
    for _ in range(3):
        err_k = torch.where(mask > 0, vt_k - interp.interp1_uniform(
            vtmagn, pos_k), zero)
        vtmagn = vtmagn + interp.interp(fbins, fk, err_k)
    vtmagn = torch.where(voiced[..., None], vtmagn,
                         torch.full_like(vtmagn, LOG_FLOOR))

    # voice-source phase: measured - VT minimum phase - LF phase - radiation
    vt_phase_k = interp.interp1_uniform(minphase_rows(vtmagn), pos_k)
    vsphse = _wrap(chunk.phse - vt_phase_k - src_phase - 0.5 * math.pi) * mask
    return chunk.replace(rd=rd, vtmagn=vtmagn, vsphse=vsphse)


@_batched
def chunk_to_layer0(chunk: Chunk) -> Chunk:
    """Regenerate the layer-0 harmonics from the layer-1 parameters,
    honoring edits to f0 / rd / vtmagn (reference: layer1.c ->
    llsm_chunk_tolayer0)."""
    if not chunk.has_layer1:
        raise ValueError("chunk has no layer-1 parameters")
    conf = chunk.conf
    voiced, fk = _harmonic_freqs(chunk)
    mask = (voiced[..., None] & (fk < conf.fnyq)).to(FP)
    src_logmag, src_phase = _source_at_harmonics(chunk.rd, fk.shape[-1])
    lip_logmag = lip_radiation_logmag(fk, conf.lip_radius)
    nspec = chunk.vtmagn.shape[-1]
    pos = fk / (conf.fs / 2.0) * (nspec - 1)
    vt_k = interp.interp1_uniform(chunk.vtmagn, pos)
    vt_phase_k = interp.interp1_uniform(minphase_rows(chunk.vtmagn), pos)
    ampl = torch.exp(vt_k + src_logmag + lip_logmag) * mask
    phse = _wrap(vt_phase_k + src_phase + 0.5 * math.pi + chunk.vsphse) * mask
    return chunk.replace(ampl=ampl, phse=phse, hm_mask=mask)


def fit_rd_sections(log_ampl: torch.Tensor, phse: torch.Tensor,
                    mask: torch.Tensor, f0: torch.Tensor, fs: float,
                    sections, smooth: float = 10.0) -> torch.Tensor:
    """Rd fit under known parametric tract sections (JAX
    layer1.fit_rd_sections, whose docstring gives the measurements): the
    under-resolution contamination of each section (_resonance_dev) is
    subtracted from the measured phase deviation before fit_rd_phase.
    log_ampl, phse, mask [B, N, K], f0 [B, N]; sections: iterable of
    (fc_hz, bw_hz, sign), sign -1 a pole (resonance), +1 a zero
    (antiformant) -> rd [B, N].  Blind selection of sections was measured
    unreliable in the JAX package and is not offered."""
    K = log_ampl.shape[-1]
    corr = torch.zeros_like(log_ampl)
    for fc, bw, sign in sections:
        corr = corr + _resonance_dev(f0, K, float(fc), float(bw), fs,
                                     float(sign))
    return fit_rd_phase(log_ampl, phse, mask, f0, smooth=smooth,
                        dev_corr=corr)


def fit_rd(log_ampl: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The legacy amplitude-tilt Rd fit (JAX layer1.fit_rd): log_ampl,
    mask [B, N, K], the lip radiation's tilt already divided out -> rd
    [B, N], by a grid search of the first RD_FIT_HARMONICS harmonics' tilt
    over the Rd tables and a parabolic refinement.  Formant structure
    biases it low on resonant material, which is why chunk_to_layer1 uses
    fit_rd_phase."""
    grid, src_logmag, _ = _source_tables(log_ampl.shape[-1],
                                         device=log_ampl.device)
    KR = RD_FIT_HARMONICS
    d = (log_ampl - log_ampl[..., :1])[..., :KR]              # [B, N, KR]
    s = (src_logmag - src_logmag[:, :1])[:, :KR]              # [G, KR]
    kr = torch.arange(1, KR + 1, dtype=FP, device=log_ampl.device)
    wgt = mask[..., :KR] / kr
    err = torch.sum(wgt[..., None, :] * (d[..., None, :] - s) ** 2, dim=-1)
    kf, _ = spectral.qifft(-err, torch.argmin(err, dim=-1))
    knots = torch.arange(RD_GRID_SIZE, dtype=FP, device=log_ampl.device)
    B, N = kf.shape
    return torch.exp(interp.interp(kf.reshape(1, -1), knots[None],
                                   torch.log(grid)[None]).reshape(B, N))
