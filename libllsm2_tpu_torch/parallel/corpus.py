"""Batched analyze -> synthesize -> SNR pipeline (counterpart of
libllsm2_tpu/parallel/corpus.py: _pipeline and batched_pipeline).  The
whole batch runs as batched tensors on one device."""
from __future__ import annotations

import torch

from ..config import AnalysisOptions, SynthesisOptions
from ..fp import FP
from ..models import layer0


def _pipeline(opt: AnalysisOptions, sopt: SynthesisOptions, x, f0, nx_valid,
              x_ref=None):
    """analyze -> synthesize -> masked SNR of a batch: x [B, nx], f0
    [B, N], nx_valid [B] -> (y [B, nx], snr [B] in dB).

    x_ref (optional): clean harmonic reference for the SNR; on noisy
    inputs, comparing y_sin against the noisy x would confound the metric
    with the fixture's own noise floor."""
    chunk = layer0._analyze(opt, x, f0)
    out = layer0._synthesize(sopt, chunk)
    ref = (x if x_ref is None else x_ref).to(FP)
    n = x.shape[-1]
    # exclude the OLA onset/offset transient (~half the largest
    # pitch-synchronous window), shrinking on very short valid spans
    nx_valid = torch.as_tensor(nx_valid, device=x.device)
    margin = torch.clamp(nx_valid // 4,
                         max=int(2.0 * opt.conf.fs / opt.conf.f0_floor))
    ar = torch.arange(n, device=x.device)
    m = ((ar >= margin[:, None]) & (ar < (nx_valid - margin)[:, None])).to(FP)
    err = (ref - out.y_sin[:, :n]) * m
    sig = ref * m
    snr = 10.0 * torch.log10(torch.sum(sig ** 2, dim=-1)
                             / torch.clamp(torch.sum(err ** 2, dim=-1),
                                           min=1e-12))
    return out.y, snr


def batched_pipeline(opt: AnalysisOptions, sopt: SynthesisOptions,
                     x: torch.Tensor, f0: torch.Tensor, nx_valid: torch.Tensor,
                     x_ref: torch.Tensor | None = None):
    """Batched analyze+synthesize: x [B, nx], f0 [B, N], nx_valid [B];
    x_ref [B, nx] (optional) = clean harmonic reference for the SNR.
    Returns (y [B, nx], snr [B], mean_snr)."""
    y, snr = _pipeline(opt, sopt, x, f0, nx_valid, x_ref)
    return y, snr, torch.mean(snr)
