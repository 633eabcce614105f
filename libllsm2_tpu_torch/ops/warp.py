"""Frequency-axis warping for the noise PSD (counterpart of
libllsm2_tpu/ops/warp.py; reference: dsputils.c -> llsm_warp_frequency
and its inverse).  The warped axis compresses high frequencies
logarithmically."""
from __future__ import annotations

import torch

from ..fp import FP


def warp_frequency(f, warp_const):
    """Linear frequency [Hz] -> warped coordinate (float32)."""
    return warp_const * torch.log1p(torch.as_tensor(f, dtype=FP) / warp_const)


def unwarp_frequency(fw, warp_const):
    """Warped coordinate -> linear frequency [Hz] (exact inverse, float32)."""
    return warp_const * torch.expm1(torch.as_tensor(fw, dtype=FP) / warp_const)


def warped_bin_centers(npsd: int, fnyq: float, warp_const: float,
                       device="cpu") -> torch.Tensor:
    """Linear-frequency centers [Hz] of npsd bins uniform on the warped axis
    spanning [0, fnyq], in float32."""
    wmax = warp_frequency(fnyq, warp_const)
    wc = (torch.arange(npsd, device=device) + 0.5) * (wmax.to(device) / npsd)
    return unwarp_frequency(wc, warp_const)


def warped_band_matrix(npsd: int, nbin: int, fs: float, warp_const: float,
                       device="cpu") -> torch.Tensor:
    """[npsd, nbin] row-normalized averaging matrix taking a linear-axis
    half-spectrum (nbin rfft bins, 0..fs/2) to npsd warped-axis band means.
    Built on the CPU in float32 (so the band edges do not depend on the
    device's transcendental rounding) and moved to `device`."""
    f = torch.arange(nbin, dtype=FP) * (fs / 2.0) / (nbin - 1)
    wmax = warp_frequency(fs / 2.0, warp_const)
    band = torch.floor(warp_frequency(f, warp_const) / wmax * npsd)
    band = torch.clamp(band, 0, npsd - 1).to(torch.int64)
    onehot = (band[None, :] == torch.arange(npsd)[:, None]).to(FP)
    counts = torch.clamp(onehot.sum(dim=1, keepdim=True), min=1.0)
    return (onehot / counts).to(device)


def unwarp_interp_positions(nbin: int, npsd: int, fs: float,
                            warp_const: float) -> torch.Tensor:
    """Fractional positions into the npsd warped-bin array for each of nbin
    linear rfft bins spanning [0, fs/2] (synthesis-side PSD unwarping by
    interpolation), in float32 on the CPU."""
    f = torch.arange(nbin, dtype=FP) * (fs / 2.0) / (nbin - 1)
    wmax = warp_frequency(fs / 2.0, warp_const)
    return torch.clamp(warp_frequency(f, warp_const) / wmax * npsd - 0.5,
                       0.0, npsd - 1.0)
