"""Parametric window functions evaluated at continuous positions
(counterpart of libllsm2_tpu/ops/windows.py; reference: ciglet.h ->
hanning/hamming/blackman_harris/nuttall98/mltsine).  Pitch-synchronous
windows are generally non-integral in samples, so each window is a cosine
series w(u), u in [0, 1], evaluated at the exact normalized positions.
"""
from __future__ import annotations

import math

import torch

# Cosine-series coefficients: w(u) = sum_m a[m] * cos(2 pi m u).
COSINE_SERIES = {
    "hanning": (0.5, -0.5),
    "hamming": (0.54, -0.46),
    "blackman": (0.42, -0.5, 0.08),
    "blackman_harris": (0.35875, -0.48829, 0.14128, -0.01168),
    "nuttall98": (0.3635819, -0.4891775, 0.1365995, -0.0106411),
}


def window_eval(name: str, u: torch.Tensor) -> torch.Tensor:
    """Evaluate window `name` at normalized positions u in [0, 1]; positions
    outside [0, 1] evaluate to 0 (compact support)."""
    inside = (u >= 0.0) & (u <= 1.0)
    if name == "mltsine":
        w = torch.sin(math.pi * u)
    else:
        w = torch.zeros_like(u)
        for m, a in enumerate(COSINE_SERIES[name]):
            w = w + a * torch.cos(2.0 * math.pi * m * u)
    return torch.where(inside, w, torch.zeros_like(w))


def window_centered(name: str, n: torch.Tensor, halfwidth) -> torch.Tensor:
    """Window centered at 0 with support [-halfwidth, +halfwidth]; `n` are
    sample offsets from the center, `halfwidth` may be a tensor."""
    u = (n / halfwidth + 1.0) * 0.5
    return window_eval(name, u)
