"""F0 estimation: the pYIN-style tracker of the JAX package in PyTorch
(counterpart of libllsm2_tpu/ops/f0.py; reference analog: libpyin +
libgvps, which the reference's tests use to feed llsm_analyze).

  - YIN difference function for all frames at once (energy terms + one
    batched rfft cross-correlation),
  - cumulative-mean-normalized difference (CMNDF),
  - observation scores over log-spaced pitch bins + an unvoiced state,
    with a harmonic-comb spectral term against octave errors,
  - a Viterbi path over frames (the libgvps analog),
  - parabolic lag refinement.

The JAX package maps one utterance under jax.vmap; here every step takes
a leading batch axis [B, ...].  The tracker has no Pallas kernel, so it
is plain PyTorch: the per-frame front end is batched tensor code, run in
calls of exactly ``layer0._group_rows(N)`` utterances (the FFTs, the comb
product and the frame reductions order their sums by the rows of a
call), so an utterance's track does not depend on its batch.  The
Viterbi, forward scan and backtrace, runs on the card in one launch of
kernels.viterbi_scan (a block a row).
"""
from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..fp import FP, FP64
from . import kernels
from .harmonics import frame_hops


class F0Config(NamedTuple):
    fs: float = 16000.0
    nhop: int = 80
    winlen: int = 1024          # analysis window (64 ms @ 16 kHz)
    f0_floor: float = 60.0
    f0_ceil: float = 500.0
    nbins: int = 96             # log-spaced pitch grid for Viterbi
    voicing_threshold: float = 0.45
    transition_semitones: float = 1.2   # stddev of the pitch-jump prior
    switch_penalty: float = 6.0         # -log prob of voicing flips
    hs_weight: float = 5.0      # weight of the harmonic-comb spectral
                                # term in the Viterbi observations
                                # (octave disambiguation; 0 disables)
    hs_harmonics: int = 12      # comb length
    hs_decay: float = 0.9       # per-harmonic comb weight decay
    integration_periods: float = 2.0    # YIN difference-integration span
                                # in periods of f0_floor (0 = legacy
                                # full-window integration)


BETA = 0.1      # CMNDF -> log-likelihood scale


def _lags(cfg: F0Config):
    """(tau_min, tau_max, span) of the difference function."""
    tau_min = int(cfg.fs / cfg.f0_ceil)
    tau_max = min(int(cfg.fs / cfg.f0_floor) + 2, cfg.winlen - 1)
    span = None
    if cfg.integration_periods > 0.0:
        span = max(int(cfg.integration_periods * cfg.fs / cfg.f0_floor),
                   2 * tau_min)
    return tau_min, tau_max, span


@functools.lru_cache(maxsize=16)
def _tables_np(cfg: F0Config) -> dict:
    """The tracker's constant tables for a config, built once with numpy:
    the bins' lags and their interpolation taps on the CMNDF, the comb
    matrix [nfft_hs // 2 + 1, nbins] that samples the magnitude spectrum
    at each bin's harmonics (the JAX package's, entry for entry), the
    analysis window and the log transition matrix [nbins + 1, nbins + 1]
    (float64, cast to float32)."""
    _, tau_max, _ = _lags(cfg)
    fg = np.exp(np.linspace(np.log(cfg.f0_floor + 1.0),
                            np.log(cfg.f0_ceil - 1.0), cfg.nbins))
    lag = np.float32(cfg.fs) / fg.astype(np.float32)          # [nb] float32
    i0 = np.clip(np.floor(lag).astype(np.int64), 1, tau_max - 2)
    out = dict(lag=lag, i0=i0, tfrac=(lag - i0).astype(np.float32))
    if cfg.hs_weight > 0.0:
        nfft_hs = 2 * cfg.winlen
        nbin = nfft_hs // 2 + 1
        df = cfg.fs / nfft_hs
        ks = np.arange(1, cfg.hs_harmonics + 1)
        pos = fg[:, None] * ks[None, :] / df                  # [nb, Kc]
        wk = cfg.hs_decay ** (ks - 1)
        valid = (fg[:, None] * ks[None, :]) < 0.5 * cfg.fs
        i0h = np.clip(np.floor(pos).astype(np.int64), 0, nbin - 2)
        frac = pos - i0h
        comb = np.zeros((nbin, cfg.nbins), np.float32)
        for j in range(cfg.hs_harmonics):
            wv = wk[j] * valid[:, j]
            np.add.at(comb, (i0h[:, j], np.arange(cfg.nbins)),
                      (1.0 - frac[:, j]) * wv)
            np.add.at(comb, (i0h[:, j] + 1, np.arange(cfg.nbins)),
                      frac[:, j] * wv)
        norm = np.maximum((wk[None, :] * valid).sum(axis=1), 1e-6)
        out["comb"] = (comb / norm[None, :]).astype(np.float32)
        out["win"] = np.hanning(cfg.winlen).astype(np.float32)
    # transition: gaussian prior on semitone jumps + voicing switch penalty
    semi = 12.0 * np.log2(fg[None, :] / fg[:, None])
    nb = cfg.nbins
    lt = np.full((nb + 1, nb + 1), -cfg.switch_penalty)
    lt[:nb, :nb] = -(semi ** 2) / (2.0 * cfg.transition_semitones ** 2)
    lt[nb, nb] = 0.0
    m = lt.max(axis=1, keepdims=True)
    lt = lt - (m + np.log(np.sum(np.exp(lt - m), axis=1, keepdims=True)))
    out["lt"] = lt.astype(np.float32)
    return out


def _tables(cfg: F0Config, device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            for k, v in _tables_np(cfg).items()}


@contextlib.contextmanager
def _fp32_matmul():
    """float32 products and convolutions without TF32 on the card,
    whatever the caller set (the JAX package asks for Precision.HIGHEST, or
    rounds operands to bfloat16 and accumulates in float32)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _difference_function(frames: torch.Tensor, tau_max: int,
                         span: int | None = None) -> torch.Tensor:
    """YIN d(tau) for tau in [0, tau_max) for every frame [..., W] at once.

    d(tau) = sum_{j in [s, s+span)} (x_j - x_{j+tau})^2
           = e(s, s+span) + e(s+tau, s+span+tau) - 2*r(tau)
    with running energies e and a cross-correlation r (batched rfft).
    `span` is the fixed integration length (YIN's W'), centred in the
    frame: s = (W - span - tau_max) // 2 (the JAX package's docstring
    gives the glide measurements behind it); span=None keeps the legacy
    full-window form."""
    W = frames.shape[-1]
    nfft = 1
    while nfft < 2 * W:
        nfft *= 2
    sq = frames ** 2
    csum = torch.nn.functional.pad(torch.cumsum(sq, dim=-1), (1, 0))
    tau = torch.arange(tau_max, device=frames.device)
    if span is None:
        spec = torch.fft.rfft(frames, n=nfft)
        r = torch.fft.irfft(spec * torch.conj(spec), n=nfft)[..., :tau_max]
        e0 = csum[..., W - tau]
        et = csum[..., W:W + 1] - csum[..., tau]
        return torch.clamp(e0 + et - 2.0 * r, min=0.0)
    span = int(min(span, W - tau_max))
    s = (W - span - tau_max) // 2
    seg = frames[..., s:s + span]
    # r(tau) = sum_j seg_j * frame_{s + j + tau}: the fixed span against
    # the whole frame in the frequency domain
    spec_f = torch.fft.rfft(frames, n=nfft)
    spec_s = torch.fft.rfft(seg, n=nfft)
    xc = torch.fft.irfft(torch.conj(spec_s) * spec_f, n=nfft)
    r = xc[..., s:s + tau_max]
    e0 = torch.sum(seg ** 2, dim=-1, keepdim=True)
    et = csum[..., s + span + tau] - csum[..., s + tau]
    return torch.clamp(e0 + et - 2.0 * r, min=0.0)


def _cmndf(d: torch.Tensor) -> torch.Tensor:
    """Cumulative-mean-normalized difference: d'(0)=1,
    d'(tau) = d(tau) * tau / sum_{1..tau} d."""
    tau = torch.arange(d.shape[-1], dtype=FP, device=d.device)
    csum = torch.cumsum(d, dim=-1)
    out = d * tau / torch.clamp(csum, min=1e-9)
    out[..., 0] = 1.0
    return out


def _frames(cfg: F0Config, x: torch.Tensor) -> torch.Tensor:
    """Mean-removed analysis frames [B, N, winlen] centred at i*nhop of x
    [B, nx], zero-padded outside it: the JAX package's
    fetch_frames(x, i*nhop, winlen // 2)[:, :winlen], cut here from
    harmonics.frame_hops' hop-aligned view (no gather)."""
    nhop, half = cfg.nhop, cfg.winlen // 2
    hh = -(-half // nhop)
    off = hh * nhop - half
    frames = frame_hops(x, x.shape[-1] // nhop, nhop, hh)
    frames = frames[..., off:off + cfg.winlen]
    return frames - torch.mean(frames, dim=-1, keepdim=True)


def _observations(cfg: F0Config, x: torch.Tensor):
    """The front end of a group of rows x [G, nx] -> (logobs [G, N,
    nbins + 1], the CMNDF dp [G, N, tau_max])."""
    tab = _tables(cfg, x.device)
    _, tau_max, span = _lags(cfg)
    frames = _frames(cfg, x)
    dp = _cmndf(_difference_function(frames, tau_max, span))
    # observation cost on the log-pitch grid: the CMNDF at each bin's
    # (fractional) lag, linearly interpolated
    i0, tfrac = tab["i0"], tab["tfrac"]
    obs = dp[..., i0] * (1.0 - tfrac) + dp[..., i0 + 1] * tfrac  # [G, N, nb]
    logp_v = -obs / BETA
    if cfg.hs_weight > 0.0:
        # harmonic-comb spectral score: |X| sampled at k f_b by the comb
        # matrix, one product (octave disambiguation; JAX f0.py explains)
        mag = torch.abs(torch.fft.rfft(frames * tab["win"],
                                       n=2 * cfg.winlen))
        with _fp32_matmul():
            hs = torch.matmul(mag, tab["comb"])               # [G, N, nb]
        hs_rel = torch.log(hs + 1e-9) \
            - torch.log(torch.amax(hs, dim=-1, keepdim=True) + 1e-9)
        logp_v = logp_v + cfg.hs_weight * hs_rel
    logp_u = torch.full(obs.shape[:-1] + (1,),
                        -cfg.voicing_threshold / BETA, dtype=FP,
                        device=x.device)
    return torch.cat([logp_v, logp_u], dim=-1), dp


def viterbi(logobs: torch.Tensor, lt: torch.Tensor) -> torch.Tensor:
    """The most likely state path [B, N] (int64) of per-frame log scores
    logobs [B, N, S] under log transitions lt [S, S] (from row, to
    column), each step's scores renormalized to a maximum of 0 (the JAX
    package's lax.scan, op for op), ties to the first maximum.  On the card
    the forward scan and the backtrace are one launch of
    kernels.viterbi_scan; under LLSM_FP64=1 its plain twin runs."""
    if FP64:
        return kernels.viterbi_scan_ref(logobs, lt, True)
    return kernels.viterbi_scan(logobs, lt, True)


def _track(cfg: F0Config, x: torch.Tensor) -> torch.Tensor:
    """Batched tracker: x [B, nx] (float32, on its device) -> [B, nx //
    nhop] F0 (0 = unvoiced)."""
    from ..models.layer0 import _group_rows, _row_groups
    x = x.to(FP)
    B, nx = x.shape
    N = nx // cfg.nhop
    _, tau_max, _ = _lags(cfg)
    nb = cfg.nbins
    # one tensor out of each group: logobs and dp side by side
    both = _row_groups(lambda g: torch.cat(_observations(cfg, g), dim=-1),
                       x, _group_rows(N))
    logobs, dp = both[..., :nb + 1], both[..., nb + 1:]
    tab = _tables(cfg, x.device)
    path = viterbi(logobs, tab["lt"])
    voiced = path < nb
    bin_idx = torch.clamp(path, 0, nb - 1)
    # refine: parabolic interpolation of the CMNDF around the decoded lag
    lag_sel = tab["lag"][bin_idx]
    i0 = torch.clamp(torch.round(lag_sel).to(torch.int64), 1, tau_max - 2)
    take = lambda idx: torch.gather(dp, -1, idx[..., None])[..., 0]
    a, b, c = take(i0 - 1), take(i0), take(i0 + 1)
    denom = a - 2.0 * b + c
    delta = torch.where(torch.abs(denom) > 1e-12,
                        torch.clamp(0.5 * (a - c) / denom, -1.0, 1.0),
                        torch.zeros_like(denom))
    lag_ref = i0.to(FP) + delta
    f0 = cfg.fs / torch.clamp(lag_ref, min=1.0)
    f0 = torch.clamp(f0, cfg.f0_floor, cfg.f0_ceil)
    return torch.where(voiced, f0, torch.zeros_like(f0))


def _as_signal(x, device) -> torch.Tensor:
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    return torch.as_tensor(x, device=device).to(FP)


def track(cfg: F0Config, x, device=None) -> torch.Tensor:
    """Estimate an F0 track [nfrm] from a signal [nx] (0 = unvoiced); nfrm
    = nx // nhop, frame centres at i*nhop (matching layer-0 analysis).  A
    tensor x stays on its device; numpy input goes to the card ("cuda";
    pass device="cpu" for the CPU -- without a card the default raises)."""
    return _track(cfg, _as_signal(x, device)[None])[0]


def track_batch(cfg: F0Config, xs, device=None) -> torch.Tensor:
    """The tracker on a padded batch [B, nx] -> [B, nfrm], each row as
    track() gives it alone (device as in track)."""
    return _track(cfg, _as_signal(xs, device))
