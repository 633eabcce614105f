"""Spectral primitives of the main path (counterpart of
libllsm2_tpu/ops/spectral.py)."""
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
