"""Spectral primitives: chirp-Z transform, periodogram, quadratic peak
interpolation, real cepstrum, minimum-phase reconstruction and the
instantaneous-frequency detector (counterpart of
libllsm2_tpu/ops/spectral.py; reference: ciglet.h).  Phase terms are
reduced to cycles mod 1 before trig, so float32 stays accurate."""
from __future__ import annotations

import math

import torch

from ..fp import CP, FP


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _chirp(idx: torch.Tensor, f_step) -> torch.Tensor:
    """exp(-j pi f_step idx^2) with the phase 0.5 f_step idx^2 reduced mod
    1 in cycles; idx integer-valued with idx^2 < 2^24 (exact in float32),
    f_step a float or a tensor of leading axes (-> [..., len(idx)])."""
    if torch.is_tensor(f_step):
        f_step = f_step.to(FP)[..., None]
    ph = 0.5 * f_step * idx.to(FP) ** 2
    ph = ph - torch.round(ph)
    return torch.polar(torch.ones_like(ph), -2.0 * math.pi * ph)


def czt(x: torch.Tensor, m: int, f_step) -> torch.Tensor:
    """Chirp-Z transform along the last axis (Bluestein): S_k = sum_n x_n
    exp(-2j pi f_step k n) for k = 0..m-1, the DTFT at k f_step cycles a
    sample.  f_step is a float or a tensor of x's leading axes (a zoom a
    row, where the JAX package maps rows with vmap).  Three FFTs of size
    next_pow2(n + m - 1) (reference: ciglet.h -> czt)."""
    n = x.shape[-1]
    L = next_pow2(n + m - 1)
    dev = x.device
    kk = torch.arange(L, device=dev)
    u = x.to(CP) * _chirp(torch.arange(n, device=dev), f_step)
    # v_j = w^{-j^2/2} arranged circularly so that (u * v)[k] is the sum
    j_idx = torch.where(kk < m, kk, torch.where(kk >= L - n + 1, kk - L,
                                                torch.zeros_like(kk)))
    v = _chirp(j_idx, f_step).conj()
    conv = torch.fft.ifft(torch.fft.fft(u, n=L) * torch.fft.fft(v, n=L))
    return conv[..., :m] * _chirp(torch.arange(m, device=dev), f_step)


def iczt(X: torch.Tensor, f_step) -> torch.Tensor:
    """Inverse chirp-Z transform for the full circle (reference: ciglet.h
    -> iczt): x_n = (1/M) sum_k X_k exp(+2j pi f_step k n), which inverts
    czt exactly when M f_step == 1."""
    m = X.shape[-1]
    return czt(X.conj(), m, f_step).conj() / m


def periodogram(frames: torch.Tensor, window: torch.Tensor,
                nfft: int) -> torch.Tensor:
    """Windowed periodogram, power-per-bin convention normalized by
    sum(w^2) so that unit-variance white noise gives a flat PSD of 1."""
    wsumsq = torch.sum(window ** 2)
    spec = torch.fft.rfft(frames * window, n=nfft)
    return (spec.real ** 2 + spec.imag ** 2) / torch.clamp(wsumsq, min=1e-12)


def qifft(logmag: torch.Tensor, k: torch.Tensor):
    """Quadratic interpolation of a spectral peak at integer bin k along
    the last axis (reference: ciglet.h -> qifft), k clamped to the
    interior -> (refined bin, refined logmag)."""
    n = logmag.shape[-1]
    k = torch.clamp(k, 1, n - 2)
    take = lambda i: torch.gather(logmag, -1, i[..., None])[..., 0]
    a, b, c = take(k - 1), take(k), take(k + 1)
    denom = a - 2.0 * b + c
    p = torch.where(torch.abs(denom) > 1e-12, 0.5 * (a - c) / denom,
                    torch.zeros_like(denom))
    p = torch.clamp(p, -0.5, 0.5)
    return k + p, b - 0.25 * (a - c) * p


def spec_to_cepstrum(logmag: torch.Tensor) -> torch.Tensor:
    """Real cepstrum from a log-magnitude half-spectrum (nfft//2+1 bins)
    (reference: ciglet.h -> spec2cepstrum)."""
    return torch.fft.irfft(logmag, n=2 * (logmag.shape[-1] - 1))


def cepstrum_to_spec(ceps: torch.Tensor) -> torch.Tensor:
    """Log-magnitude half-spectrum from a real cepstrum (reference:
    ciglet.h -> cepstrum2spec)."""
    return torch.fft.rfft(ceps).real


def minphase_phase(logmag: torch.Tensor) -> torch.Tensor:
    """Phase (radians) of the minimum-phase system whose log magnitude is
    the half-spectrum logmag (nspec = nfft//2+1 bins), by the folded real
    cepstrum (reference: ciglet.h -> minphase)."""
    nfft = 2 * (logmag.shape[-1] - 1)
    ceps = torch.fft.irfft(logmag, n=nfft)
    h = nfft // 2
    fold = torch.cat([ceps[..., :1], 2.0 * ceps[..., 1:h], ceps[..., h:h + 1],
                      torch.zeros_like(ceps[..., h + 1:])], dim=-1)
    return torch.fft.rfft(fold).imag


def minphase_spectrum(logmag: torch.Tensor) -> torch.Tensor:
    """Complex minimum-phase half-spectrum exp(logmag + j minphase)."""
    return torch.polar(torch.exp(logmag), minphase_phase(logmag))


def upsample_linear(v: torch.Tensor, os: int) -> torch.Tensor:
    """Linear upsampling of the last axis by an integer factor: n points ->
    os (n - 1) + 1 points over the same span, exact at the originals."""
    if os == 1:
        return v
    a = torch.arange(os, dtype=v.dtype, device=v.device) / os
    seg = v[..., :-1, None] + (v[..., 1:] - v[..., :-1])[..., None] * a
    return torch.cat([seg.reshape(v.shape[:-1] + (-1,)), v[..., -1:]], dim=-1)


def instantaneous_frequency(x: torch.Tensor, centers: torch.Tensor,
                            freqs: torch.Tensor, *, fs: float,
                            halfwidth: torch.Tensor,
                            halfwin_max: int) -> torch.Tensor:
    """Instantaneous frequency of the component nearest freqs[..., i] at
    centers[i] (reference: ciglet.h -> ifdetector), by Flanagan's
    derivative-window estimator with a Hann window h of per-frame
    halfwidth and its derivative h':
        f_inst = f - fs / (2 pi) Im{X_h' conj(X_h)} / |X_h|^2.
    x [..., nx]; centers [N] integer sample positions; freqs, halfwidth
    [..., N] (Hz, samples); halfwin_max the bound on halfwidth -> [..., N]
    Hz."""
    H = int(halfwin_max)
    W = 2 * H + 1
    dev = x.device
    n_off = torch.arange(W, dtype=FP, device=dev) - H
    xp = torch.nn.functional.pad(x.to(FP), (H, H + 1))
    idx = torch.as_tensor(centers, device=dev)[:, None] \
        + torch.arange(W, device=dev)
    frames = xp[..., idx]                                   # [..., N, W]
    hw = torch.clamp(torch.as_tensor(halfwidth, dtype=FP, device=dev), 2.0,
                     float(H))[..., None]
    r = n_off / hw
    inside = (torch.abs(r) <= 1.0).to(FP)
    h = (0.5 + 0.5 * torch.cos(math.pi * r)) * inside
    hd = (-0.5 * math.pi / hw) * torch.sin(math.pi * r) * inside
    freqs = torch.as_tensor(freqs, dtype=FP, device=dev)
    ph = (freqs / fs)[..., None] * n_off
    ph = 2.0 * math.pi * (ph - torch.round(ph))
    xr = frames * torch.cos(ph)
    xi = -frames * torch.sin(ph)
    re_h = torch.sum(xr * h, dim=-1)
    im_h = torch.sum(xi * h, dim=-1)
    re_d = torch.sum(xr * hd, dim=-1)
    im_d = torch.sum(xi * hd, dim=-1)
    num = im_d * re_h - re_d * im_h                 # Im{X_h' conj(X_h)}
    den = torch.clamp(re_h ** 2 + im_h ** 2, min=1e-20)
    return freqs - fs / (2.0 * math.pi) * num / den
