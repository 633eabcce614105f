"""Interpolation primitives (counterpart of libllsm2_tpu/ops/interp.py;
reference: ciglet.h -> interp1): linear on a uniform grid or at knots,
Catmull-Rom on a uniform grid, frame fetching."""
from __future__ import annotations

import numpy as np
import torch


def interp1_uniform(fp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of fp (last axis sampled on the uniform grid
    0..len-1) at fractional positions pos, clamped at the edges.  The
    leading axes of fp and pos broadcast: pos [P] serves every row, pos
    [..., P] one row each (the JAX package's vmap(interp1_uniform)) ->
    [..., P]."""
    n = fp.shape[-1]
    lead = torch.broadcast_shapes(fp.shape[:-1], pos.shape[:-1])
    pos = torch.clamp(pos, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    frac = pos - i0
    fp = fp.expand(lead + (n,))
    i0 = i0.expand(lead + i0.shape[-1:])
    f0 = torch.gather(fp, -1, i0)
    f1 = torch.gather(fp, -1, i0 + 1)
    return f0 + (f1 - f0) * frac


def catmull_rom_uniform(fp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Cubic Catmull-Rom interpolation of fp (last axis on the uniform grid
    0..len-1) at fractional positions pos, clamped at the edges; leading
    axes broadcast as in interp1_uniform."""
    n = fp.shape[-1]
    lead = torch.broadcast_shapes(fp.shape[:-1], pos.shape[:-1])
    pos = torch.clamp(pos, 0.0, n - 1.0)
    i1 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    t = pos - i1
    fp = fp.expand(lead + (n,))
    take = lambda i: torch.gather(fp, -1, torch.clamp(i, 0, n - 1)
                                  .expand(lead + i.shape[-1:]))
    p0, p1, p2, p3 = take(i1 - 1), take(i1), take(i1 + 1), take(i1 + 2)
    a = 2.0 * p1
    b = p2 - p0
    c = 2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3
    d = -p0 + 3.0 * p1 - 3.0 * p2 + p3
    return 0.5 * (a + b * t + c * t * t + d * t * t * t)


def interp1(xp: torch.Tensor, fp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation with edge clamping at knots xp
    (increasing) with values fp (reference: ciglet.h -> interp1; the JAX
    package's jnp.interp), over the last axis with leading axes broadcast
    (interp)."""
    return interp(x, xp, fp)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """Batched counterpart of jnp.interp for non-decreasing knots: x [..., M]
    at knots xp [..., P] with values fp [..., P] -> [..., M], leading axes
    broadcast.  As jnp.interp: x below xp[0] gives fp[0], above xp[-1]
    fp[-1]; among equal knots x falls in the interval to the right of the
    last of them (searchsorted side="right")."""
    P = xp.shape[-1]
    shape = torch.broadcast_shapes(x.shape[:-1], xp.shape[:-1], fp.shape[:-1])
    x = x.expand(shape + x.shape[-1:]).contiguous()
    xp = xp.expand(shape + (P,)).contiguous()
    fp = fp.expand(shape + (P,))
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, P - 1)
    take = lambda a, j: torch.gather(a, -1, j)
    x0, x1 = take(xp, i - 1), take(xp, i)
    f0, f1 = take(fp, i - 1), take(fp, i)
    dx = x1 - x0
    delta = x - x0
    # jnp.interp's equal-knot test: |dx| at most the spacing of eps
    safe = torch.abs(dx) > float(np.spacing(np.finfo(np.float32).eps))
    step = delta / torch.where(safe, dx, torch.ones_like(dx))
    y = torch.where(safe, f0 + step * (f1 - f0), f0)
    y = torch.where(x < xp[..., :1], fp[..., :1], y)
    return torch.where(x > xp[..., -1:], fp[..., -1:], y)


def fetch_frame(x: torch.Tensor, center: int, halfwidth: int) -> torch.Tensor:
    """x[..., center - halfwidth : center + halfwidth + 1] with zero padding
    outside the signal (reference: ciglet.h -> fetch_frame) -> [..., 2
    halfwidth + 1]."""
    xp = torch.nn.functional.pad(x, (halfwidth, halfwidth + 1))
    return xp[..., center:center + 2 * halfwidth + 1]


def fetch_frames(x: torch.Tensor, centers: torch.Tensor,
                 halfwidth: int) -> torch.Tensor:
    """Batched fetch_frame at integer centers [M] -> [..., M, 2 halfwidth +
    1] (a gather).  At uniform centers i*nhop, ops.harmonics.frame_hops
    gives the same frames as a strided view, without the gather: the F0
    tracker (ops/f0.py) cuts its frames from it."""
    xp = torch.nn.functional.pad(x, (halfwidth, halfwidth + 1))
    idx = (torch.as_tensor(centers, device=x.device)[:, None]
           + torch.arange(2 * halfwidth + 1, device=x.device))
    return xp[..., idx]
