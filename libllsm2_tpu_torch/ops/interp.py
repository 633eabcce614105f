"""Interpolation primitives (counterpart of libllsm2_tpu/ops/interp.py;
reference: ciglet.h -> interp1)."""
from __future__ import annotations

import torch


def interp1_uniform(fp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of fp (last axis sampled on the uniform grid
    0..len-1) at fractional positions `pos` [P], clamped at the edges.
    Leading axes of fp are batch axes: returns [..., P]."""
    n = fp.shape[-1]
    pos = torch.clamp(pos, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    frac = pos - i0
    f0 = fp[..., i0]
    f1 = fp[..., i0 + 1]
    return f0 + (f1 - f0) * frac
