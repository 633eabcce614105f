"""Liljencrants-Fant (LF) glottal flow model, Rd-parameterized (counterpart
of libllsm2_tpu/ops/lf.py; reference: ciglet.h -> lfmodel_from_rd /
lfmodel_spectrum / lfmodel_flow).

The solvers run fixed iteration counts (Newton for eps, bisection for
alpha), the JAX package's fori_loops written as plain loops, in float32.
Time is normalized to the period T0 = 1; the model describes the glottal
flow derivative U'(t) with U'(te) = -Ee (Ee > 0).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..fp import FP


class LFParams(NamedTuple):
    tp: torch.Tensor     # instant of max flow (normalized to T0 = 1)
    te: torch.Tensor     # instant of max excitation (U' = -Ee)
    ta: torch.Tensor     # return-phase time constant
    alpha: torch.Tensor  # growth rate of the open-phase sinusoid
    eps: torch.Tensor    # return-phase decay rate
    e0: torch.Tensor     # open-phase amplitude scale (for Ee = 1)

    def map(self, fn) -> "LFParams":
        return LFParams(*(fn(a) for a in self))


def _solve_eps(ta, te, iters: int = 12):
    """Solve eps * ta = 1 - exp(-eps * (1 - te)) by Newton iteration."""
    t2 = 1.0 - te
    e = 1.0 / ta
    for _ in range(iters):
        f = e * ta - 1.0 + torch.exp(-e * t2)
        df = ta - t2 * torch.exp(-e * t2)
        e = torch.clamp(e - f / df, 1e-3, 1e7)
    return e


def _flow_balance(alpha, tp, te, ta, eps):
    """Net flow integral of U' over one period with Ee = 1 and E0 tied to
    alpha by the continuity condition U'(te) = -1, written with
    exp(alpha te) divided out so large |alpha| cannot overflow float32."""
    wg = math.pi / tp
    s = torch.sin(wg * te)
    c = torch.cos(wg * te)
    a1 = -(alpha * s - wg * c + wg * torch.exp(-alpha * te)) / (
        s * (alpha * alpha + wg * wg))
    t2 = 1.0 - te
    expet = torch.exp(-eps * t2)
    a2 = -(1.0 / (eps * ta)) * ((1.0 - expet) / eps - t2 * expet)
    return a1 + a2


def lf_from_rd(rd, iters: int = 60) -> LFParams:
    """Rd -> LF shape parameters via Fant's 1994 regression, then implicit
    solves for eps and alpha.  rd may be any shape; every output has it."""
    rd = torch.clamp(torch.as_tensor(rd, dtype=FP), 0.05, 6.0)
    rap = (-1.0 + 4.8 * rd) / 100.0
    rkp = (22.4 + 11.8 * rd) / 100.0
    rgp = 0.25 * rkp / ((0.11 * rd / (0.5 + 1.2 * rkp)) - rap)
    tp = 0.5 / rgp
    te = tp * (1.0 + rkp)
    ta = torch.minimum(torch.clamp(rap, min=1e-4), 1.0 - te - 1e-4)
    te = torch.clamp(te, 1e-3, 0.995)
    tp = torch.minimum(torch.clamp(tp, min=1e-3), te - 1e-4)
    eps = _solve_eps(ta, te)
    # bisection for alpha: the net-flow balance decreases in alpha
    lo = torch.full_like(rd, -50.0)
    hi = torch.full_like(rd, 300.0)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        gt = _flow_balance(mid, tp, te, ta, eps) > 0.0
        lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
    alpha = 0.5 * (lo + hi)
    e0 = -1.0 / torch.sin(math.pi / tp * te)
    return LFParams(tp=tp, te=te, ta=ta, alpha=alpha, eps=eps, e0=e0)


def lf_spectrum(f_norm, p: LFParams, ee=1.0) -> torch.Tensor:
    """Analytic Fourier transform of the LF flow derivative at normalized
    frequencies f_norm (cycles per period; harmonic k at f_norm = k),
    broadcast against the (broadcast-compatible) parameters -> complex64."""
    w = 2.0 * math.pi * torch.as_tensor(f_norm, dtype=FP)
    w = torch.where(torch.abs(w) < 1e-6, torch.full_like(w, 1e-6), w)
    wg = math.pi / p.tp
    jw = torch.complex(torch.zeros_like(w), w)
    s = p.alpha - jw
    ejwte = torch.exp(-jw * p.te)
    # E0 = e0 exp(-alpha te) folded in: exp(s te) becomes exp(-j w te)
    i1 = (p.e0 * ee) * (
        ejwte * (s * torch.sin(wg * p.te) - wg * torch.cos(wg * p.te))
        + wg * torch.exp(-p.alpha * p.te)) / (s * s + wg * wg)
    t2 = 1.0 - p.te
    term1 = (1.0 - torch.exp(-(p.eps + jw) * t2)) / (p.eps + jw)
    term2 = torch.exp(-p.eps * t2) * (1.0 - torch.exp(-jw * t2)) / jw
    i2 = -(ee / (p.eps * p.ta)) * ejwte * (term1 - term2)
    return i1 + i2


def lf_flow_deriv(t_norm, p: LFParams, ee=1.0) -> torch.Tensor:
    """LF glottal flow derivative at normalized times t_norm in [0, 1)
    (zero outside)."""
    t = torch.as_tensor(t_norm, dtype=FP)
    wg = math.pi / p.tp
    # E0 exp(alpha t) = e0 exp(alpha (t - te)): bounded for t <= te
    open_phase = p.e0 * ee * torch.exp(p.alpha * (t - p.te)) * torch.sin(wg * t)
    t2 = 1.0 - p.te
    ret = -(ee / (p.eps * p.ta)) * (torch.exp(-p.eps * (t - p.te))
                                    - torch.exp(-p.eps * t2))
    inside = (t >= 0.0) & (t < 1.0)
    return torch.where(inside, torch.where(t <= p.te, open_phase, ret),
                       torch.zeros_like(open_phase))
