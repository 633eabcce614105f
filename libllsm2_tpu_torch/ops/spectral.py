"""Spectral primitives: periodogram, quadratic peak interpolation, real
cepstrum and minimum-phase reconstruction (counterpart of
libllsm2_tpu/ops/spectral.py; reference: ciglet.h)."""
from __future__ import annotations

import torch


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


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
