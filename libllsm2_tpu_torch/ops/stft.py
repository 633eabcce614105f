"""STFT / iSTFT, DCT and Hilbert envelope (counterpart of
libllsm2_tpu/ops/stft.py; reference: ciglet.h -> stft/istft, dct,
hilbert), over leading batch axes."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..fp import FP
from .spectral import next_pow2


def _hann(nwin: int, device) -> torch.Tensor:
    # np.hanning is the SYMMETRIC window, as jnp.hanning
    return torch.as_tensor(np.hanning(nwin), dtype=FP, device=device)


def stft(x: torch.Tensor, nwin: int, nhop: int,
         nfft: int | None = None) -> torch.Tensor:
    """[..., nx] -> complex [..., nx // nhop, nfft // 2 + 1]: Hann-windowed
    frames starting at i*nhop of x zero-padded by nwin // 2 before and nwin
    after (the analysis frame grid)."""
    nfft = nfft or next_pow2(nwin)
    nfrm = x.shape[-1] // nhop
    half = nwin // 2
    xp = torch.nn.functional.pad(x.to(FP), (half, half + nwin))
    frames = xp.unfold(-1, nwin, nhop)[..., :nfrm, :]
    return torch.fft.rfft(frames * _hann(nwin, x.device), n=nfft)


def istft(spec: torch.Tensor, nwin: int, nhop: int, nx: int) -> torch.Tensor:
    """Inverse of stft: Hann synthesis window, overlap-add and the
    window-power (COLA) normalization -> [..., nx].  The frames add in a
    fixed order, hop block by hop block (no scatter, no atomics)."""
    frames = torch.fft.irfft(spec)[..., :nwin]
    w = _hann(nwin, spec.device)
    frames = frames * w
    nfrm = spec.shape[-2]
    total = nfrm * nhop + nwin
    lead = frames.shape[:-2]
    y = torch.zeros(lead + (total,), dtype=FP, device=spec.device)
    wsum = torch.zeros(total, dtype=FP, device=spec.device)
    w2 = (w * w).expand(nfrm, nwin)
    # columns [j nhop, (j + 1) nhop) of every frame land in hop block i + j
    for j in range(-(-nwin // nhop)):
        c0, c1 = j * nhop, min((j + 1) * nhop, nwin)
        pad = (0, nhop - (c1 - c0))
        y[..., c0:c0 + nfrm * nhop] += torch.nn.functional.pad(
            frames[..., c0:c1], pad).reshape(lead + (nfrm * nhop,))
        wsum[c0:c0 + nfrm * nhop] += torch.nn.functional.pad(
            w2[:, c0:c1], pad).reshape(-1)
    y = y / torch.clamp(wsum, min=1e-8)
    half = nwin // 2
    return y[..., half:half + nx]


def dct(x: torch.Tensor, norm: str = "ortho") -> torch.Tensor:
    """DCT-II along the last axis by an FFT of the even-odd reordering
    (reference: ciglet dct)."""
    n = x.shape[-1]
    x = x.to(FP)
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(n, dtype=FP, device=x.device)
    factor = 2.0 * torch.polar(torch.ones_like(k), -math.pi * k / (2.0 * n))
    out = (torch.fft.fft(v) * factor).real
    if norm == "ortho":
        scale = torch.full((n,), math.sqrt(0.5 / n), dtype=FP, device=x.device)
        scale[0] = math.sqrt(0.25 / n)
        out = out * scale
    return out


def hilbert_envelope(x: torch.Tensor) -> torch.Tensor:
    """|analytic signal| along the last axis (reference: ciglet hilbert)."""
    n = x.shape[-1]
    nfft = next_pow2(n)
    X = torch.fft.fft(x.to(FP), n=nfft)
    f = torch.fft.fftfreq(nfft, device=x.device)
    m = torch.where(f > 0, 2.0, torch.where(f == 0, 1.0, 0.0))
    return torch.abs(torch.fft.ifft(X * m))[..., :n]
