"""Sample-rate conversion (counterpart of libllsm2_tpu/ops/resample.py;
reference: ciglet.h -> sincresample / rresample).

One windowed-sinc interpolation evaluated as a dense [ny, taps] gather
and weighted sum, batched over the leading axes of x.  Rational ratios
(rresample) place every output sample by exact integer arithmetic, so
long signals accumulate no phase drift; arbitrary real ratios
(sincresample) go through the best rational approximation of the ratio.
The integer branches are the JAX package's, run in int64 under the same
conditions, so both packages pick the same (p, q) and the same fractional
positions.  Plain PyTorch: the JAX module has no kernel.
"""
from __future__ import annotations

import math

import torch

from ..fp import FP


def _kaiser_sinc_weights(frac: torch.Tensor, taps: int, cutoff: float,
                         beta: float) -> torch.Tensor:
    """Windowed-sinc weights [M, taps] over input samples n0 .. n0+taps-1
    (n0 = floor(pos) - taps//2 + 1) for fractional positions frac [M]."""
    j = torch.arange(taps, dtype=FP, device=frac.device)
    t = j[None, :] - (taps // 2 - 1) - frac[:, None]          # [M, taps]
    h = cutoff * torch.sinc(cutoff * t)
    halfspan = taps / 2.0
    r2 = torch.clamp(1.0 - (t / halfspan) ** 2, 0.0, 1.0)
    win = torch.special.i0(beta * torch.sqrt(r2)) \
        / torch.special.i0(torch.tensor(beta, dtype=FP, device=frac.device))
    h = h * win
    # per-output normalization: exact DC preservation
    return h / torch.clamp(torch.sum(h, dim=-1, keepdim=True), min=1e-9)


def _apply_kernel(x: torch.Tensor, n0: torch.Tensor, w: torch.Tensor,
                  taps: int) -> torch.Tensor:
    """y[..., m] = sum_j x[..., n0[m]+j] w[m, j] with zero extension."""
    xp = torch.nn.functional.pad(x.to(FP), (taps, taps))
    idx = n0[:, None] + taps + torch.arange(taps, device=x.device)[None, :]
    idx = torch.clamp(idx, 0, xp.shape[-1] - 1)
    return torch.sum(xp[..., idx] * w, dim=-1)


def _best_rational(ratio: float, qmax: int) -> tuple:
    """Best rational approximation p/q of ratio with p, q <= qmax
    (continued-fraction convergents)."""
    from fractions import Fraction
    fr = Fraction(ratio).limit_denominator(qmax)
    p, q = fr.numerator, fr.denominator
    if p > qmax:  # ratio > 1: bound the numerator instead
        fr = Fraction(1.0 / ratio).limit_denominator(qmax)
        p, q = fr.denominator, fr.numerator
        if p > qmax:
            p, q = qmax, max(1, int(round(qmax / ratio)))
    return max(p, 1), max(q, 1)


def sincresample(x: torch.Tensor, ratio: float, taps: int = 32,
                 beta: float = 8.0, ny: int | None = None) -> torch.Tensor:
    """Resample x [..., nx] by an arbitrary real ratio = fs_out / fs_in to
    round(nx * ratio) samples (or ny), through the best rational
    approximation of the ratio with denominators up to 46000."""
    nx = x.shape[-1]
    if ny is None:
        ny = int(round(nx * ratio))
    p, q = _best_rational(float(ratio), 46000)
    return rresample(x, p, q, taps=taps, beta=beta, ny=ny)


def rresample(x: torch.Tensor, p: int, q: int, taps: int = 32,
              beta: float = 8.0, ny: int | None = None) -> torch.Tensor:
    """Resample x [..., nx] by the exact rational ratio p/q (fs_out = fs_in
    * p / q): output m sits at input sample m q / p."""
    g = math.gcd(p, q)
    p, q = p // g, q // g
    nx = x.shape[-1]
    if ny is None:
        ny = (nx * p) // q
    d = q - p
    m = torch.arange(ny, dtype=torch.int64, device=x.device)
    if p * q < 2 ** 31:
        # m = a p + r -> pos = a q + (r q) / p
        a, r = m // p, m % p
        num = r * q
        n_int = a * q + num // p
        frac = (num % p).to(FP) / p
    elif abs(d) * max(ny, 1) < 2 ** 31:
        # large coprime near-unity pair (e.g. 48000/48001):
        # pos = m + m (q - p) / p
        md = m * d
        n_int = m + md // p
        frac = (md - (md // p) * p).to(FP) / p
    else:
        # the JAX package's int32 positions cannot be exact here: it
        # re-approximates with bounded denominators, and so does the port
        p, q = _best_rational(p / q, 46000)
        return rresample(x, p, q, taps=taps, beta=beta, ny=ny)
    cutoff = min(1.0, p / q) * 0.945
    w = _kaiser_sinc_weights(frac, taps, cutoff, beta)
    n0 = n_int - taps // 2 + 1
    return _apply_kernel(x, n0, w, taps)


def resample_to(x: torch.Tensor, fs_in: float, fs_out: float, taps: int = 32,
                ny: int | None = None) -> torch.Tensor:
    """Resample x [..., nx] between two sample rates, with exact rational
    positions when both rates are integral."""
    if abs(fs_in - fs_out) < 1e-9:
        return x.to(FP)
    if float(fs_in).is_integer() and float(fs_out).is_integer():
        return rresample(x.to(FP), int(fs_out), int(fs_in), taps=taps, ny=ny)
    return sincresample(x.to(FP), fs_out / fs_in, taps=taps, ny=ny)
