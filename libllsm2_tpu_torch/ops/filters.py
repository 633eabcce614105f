"""Filtering primitives (counterpart of libllsm2_tpu/ops/filters.py;
reference: ciglet.h -> winfir/fir1, conv, biquads, filtfilt,
levinson/LPC): FIR filtering by FFT, biquads and the Levinson-Durbin
recursion.  Each works over leading batch axes.

The biquad and the Levinson recursion are sequential (the JAX package's
lax.scan): here Python loops over the samples or the order, a few
elementwise launches a step on the card, vectorized over the rows.  They
are off the analysis and synthesis paths."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..fp import FP
from .spectral import next_pow2
from .windows import window_eval


def fir1_bandpass(numtaps: int, lo: float, hi: float, fs: float,
                  window: str = "hamming", device=None) -> torch.Tensor:
    """Window-method linear-phase bandpass FIR (reference: ciglet fir1),
    normalized to unit gain at the passband centre; lo=0 gives a lowpass,
    hi=fs/2 a highpass -> [numtaps] on `device` (the CPU by default)."""
    n = torch.arange(numtaps, dtype=FP, device=device) - (numtaps - 1) / 2.0
    f1, f2 = lo / fs * 2.0, hi / fs * 2.0        # normalized to Nyquist = 1

    def sinc_lp(fc):
        return torch.where(torch.abs(n) < 1e-9, torch.full_like(n, fc),
                           torch.sin(math.pi * fc * n) / (math.pi * n))

    h = sinc_lp(f2) - sinc_lp(f1)
    h = h * window_eval(window, torch.arange(numtaps, dtype=FP, device=device)
                        / (numtaps - 1.0))
    fc = 0.5 * (f1 + f2)
    ref = torch.sum(h * torch.cos(math.pi * fc * n))
    return h / torch.clamp(torch.abs(ref), min=1e-9)


def fftfilt(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Causal linear convolution of x [..., n] with h [..., m] by FFT,
    truncated to n samples (the reference's conv + truncation)."""
    n = x.shape[-1]
    nfft = next_pow2(n + h.shape[-1] - 1)
    X = torch.fft.rfft(x.to(FP), n=nfft)
    H = torch.fft.rfft(h.to(FP), n=nfft)
    return torch.fft.irfft(X * H, n=nfft)[..., :n]


def _f32(v) -> float:
    return float(np.float32(v))


def biquad(x: torch.Tensor, b, a) -> torch.Tensor:
    """Direct-form-II-transposed second-order section along the last axis
    of x (reference: ciglet biquad filters): b = (b0, b1, b2), a = (1, a1,
    a2), coefficients in float32.  One step a sample, every row at once."""
    b0, b1, b2 = (_f32(v) for v in b)
    a1, a2 = _f32(a[1]), _f32(a[2])
    xt = x.to(FP).movedim(-1, 0).contiguous()      # [n, ...]: steps contiguous
    bx0, bx1, bx2 = b0 * xt, b1 * xt, b2 * xt
    y = torch.empty_like(xt)
    z1 = torch.zeros_like(xt[0])
    z2 = torch.zeros_like(xt[0])
    for i in range(xt.shape[0]):
        yn = torch.add(bx0[i], z1, out=y[i])
        z1 = bx1[i] - a1 * yn + z2
        z2 = bx2[i] - a2 * yn
    return y.movedim(0, -1)


def filtfilt_biquad(x: torch.Tensor, b, a) -> torch.Tensor:
    """Zero-phase forward-backward biquad (reference: ciglet filtfilt)."""
    y = biquad(x, b, a)
    return biquad(y.flip(-1), b, a).flip(-1)


def levinson(r: torch.Tensor, order: int):
    """Levinson-Durbin recursion (reference: ciglet levinson): the
    Toeplitz solve of the normal equations from the autocorrelation r
    [..., order + 1] -> (LPC coefficients a [..., order + 1] with a[0] =
    1, prediction error [...])."""
    r = r.to(FP)
    lead = r.shape[:-1]
    idx = torch.arange(order + 1, device=r.device)
    a = torch.zeros(lead + (order + 1,), dtype=FP, device=r.device)
    a[..., 0] = 1.0
    err = r[..., 0]
    for i in range(1, order + 1):
        inner = (idx >= 1) & (idx <= i - 1)
        rev = torch.clamp(i - idx, 0, order)
        acc = torch.sum(a * torch.where(inner, r[..., rev], 0.0), dim=-1)
        k = -(r[..., i] + acc) / torch.clamp(err, min=1e-12)
        a_new = a + k[..., None] * torch.where(inner, a[..., rev], 0.0)
        a_new[..., i] = k
        a = torch.where(idx <= i, a_new, 0.0)
        a[..., 0] = 1.0
        err = err * (1.0 - k * k)
    return a, err


def lpc_from_signal(x: torch.Tensor, order: int):
    """LPC coefficients of (windowed) frames x [..., n] from their FFT
    autocorrelation and the Levinson recursion (reference: ciglet lpc) ->
    (a [..., order + 1], error [...])."""
    nfft = next_pow2(2 * x.shape[-1])
    spec = torch.fft.rfft(x.to(FP), n=nfft)
    r = torch.fft.irfft(spec * spec.conj(), n=nfft)[..., :order + 1]
    return levinson(r, order)


def lpc_spectrum(a: torch.Tensor, gain, nbins: int) -> torch.Tensor:
    """Magnitude spectrum of the all-pole model a [..., order + 1] with
    prediction error `gain` [...] on nbins rfft bins -> [..., nbins]."""
    A = torch.fft.rfft(a.to(FP), n=2 * (nbins - 1))
    g = torch.as_tensor(gain, dtype=FP, device=a.device)[..., None]
    return torch.sqrt(torch.clamp(g, min=1e-12)) / torch.clamp(torch.abs(A),
                                                               min=1e-9)
