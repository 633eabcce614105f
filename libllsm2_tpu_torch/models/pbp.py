"""Pulse-by-pulse (PbP) synthesis of the PyTorch port: each glottal pulse
rendered from the LF model through the vocal-tract filter (counterpart of
libllsm2_tpu/models/pbp.py; reference: llsmrt.c PbP mode).

A static pulse budget (duration x conf.f0_ceil) per utterance; the onsets
invert the piecewise-linear cumulative cycle count; every pulse is one
row of a batched spectral synthesis (the frames' combined LF x minimum-
phase tract spectra, lerped to the onset, x lip radiation x a fractional
delay -> irfft), added into the output at its onset by index_add_.  The
noise part is layer-0's (layer0._synth_noise, so kernels.noise_mod_ola
runs).  The JAX package's comments give the measured reasons for the
lerp of combined spectra, the linear envelope upsampling and the guard.
"""
from __future__ import annotations

import math

import torch

from ..config import SynthesisOptions
from ..container import Chunk, index_batch
from ..fp import FP
from ..ops import harmonics, interp, lf, spectral
from . import layer0, layer1

# guard samples between the irfft window start and each pulse onset: room
# for the fractional-delay interpolation kernel's acausal tail
PULSE_GUARD = 64
# elements of the [rows, P, nfft] pulse buffer per row group
_PULSE_ELEMS = 1 << 27


def _pulse_onsets(f0: torch.Tensor, thop: float, p_max: int):
    """Onset times (seconds) of each glottal cycle of every utterance, the
    frame each falls in, and the validity mask, all [B, p_max]: F0 held
    per frame is integrated over frames (a float32 cumsum, as in the JAX
    package), and the monotone cycle count inverted at 0..p_max-1."""
    B, n = f0.shape
    dev = f0.device
    d = torch.where(f0 > 0, f0, torch.zeros_like(f0)) * thop
    cum = torch.cat([torch.zeros((B, 1), dtype=FP, device=dev),
                     torch.cumsum(d, dim=-1)], dim=-1)           # [B, n+1]
    ramp = torch.arange(n + 1, dtype=FP, device=dev)
    t_knots = ramp * thop
    # strictly increasing copy for the inversion (unvoiced: tiny slope)
    cum_inv = cum + ramp * 1e-6
    p_idx = torch.arange(p_max, dtype=FP, device=dev)
    t_on = interp.interp(p_idx[None], cum_inv, t_knots[None])    # [B, P]
    valid = p_idx < cum[:, -1:]
    frame_of = torch.clamp((t_on / thop).to(torch.int64), 0, n - 1)
    valid = valid & (torch.gather(f0, 1, frame_of) > 0)
    return t_on, frame_of, valid


def _pbp_sin(chunk: Chunk, os_: int) -> torch.Tensor:
    """The pulse train y_sin [B, N * nhop] of a batched layer-1 chunk."""
    conf = chunk.conf
    B, n = chunk.f0.shape
    dev = chunk.f0.device
    nhop = conf.nhop
    nx = n * nhop
    nfft = os_ * conf.nfft_spec
    nspec = os_ * (conf.nspec - 1) + 1
    fs = conf.fs
    p_max = int(n * conf.thop * conf.f0_ceil) + 2
    t_on, frame_of, valid = _pulse_onsets(chunk.f0, conf.thop, p_max)

    # per-pulse parameters: the lerp between the frames around the onset,
    # or the onset frame's value where either neighbour is unvoiced
    fr = t_on / conf.thop
    i0 = torch.clamp(torch.floor(fr).to(torch.int64), 0, n - 2)
    wln = torch.clamp(fr - i0, 0.0, 1.0)[..., None]              # [B, P, 1]
    voiced = chunk.f0 > 0
    both_v = (torch.gather(voiced, 1, i0)
              & torch.gather(voiced, 1, i0 + 1))[..., None]

    def lerp(v, rows):   # v [b, n, M] -> [b, P, M] for the row group
        take = lambda idx: torch.gather(
            v, 1, idx[rows][..., None].expand(-1, -1, v.shape[-1]))
        w = wln[rows]
        smooth = (1.0 - w) * take(i0) + w * take(i0 + 1)
        return torch.where(both_v[rows], smooth, take(frame_of))

    every = slice(None)
    f0_p = torch.clamp(lerp(chunk.f0[..., None], every)[..., 0], min=1e-2)
    period = 1.0 / f0_p                                           # [B, P]

    fbins = torch.linspace(0.0, fs / 2.0, nspec, dtype=FP, device=dev)
    lip = torch.polar(2.0 * math.pi * torch.clamp(fbins, min=1e-3)
                      * conf.lip_radius / layer1.SPEED_OF_SOUND,
                      torch.full_like(fbins, math.pi / 2.0))
    # the frames' combined source x tract spectra (source normalized to a
    # unit fundamental), lerped per pulse
    f0_fr = torch.clamp(chunk.f0, min=1e-2)                       # [B, N]
    params_f = lf.lf_from_rd(chunk.rd)
    src1_f = torch.abs(lf.lf_spectrum(torch.ones_like(f0_fr), params_f))
    vt_mag = spectral.upsample_linear(chunk.vtmagn, os_)
    vt_ph = spectral.upsample_linear(spectral.minphase_phase(chunk.vtmagn),
                                     os_)
    # sub-sample alignment: linear phase for the fractional onset delay
    # plus a GUARD shift, so the delay kernel's acausal tail stays inside
    # the irfft window
    onset = t_on * fs
    onset_int = torch.floor(onset).to(torch.int64)
    frac = (onset - onset_int)[..., None]
    L = nx + PULSE_GUARD + nfft
    y = torch.zeros(B * L, dtype=FP, device=dev)
    tap = torch.arange(nfft, device=dev)
    group = max(1, _PULSE_ELEMS // (p_max * nfft))
    for s in range(0, B, group):
        rows = slice(s, s + group)
        src_f = lf.lf_spectrum(fbins / f0_fr[rows, :, None],
                               params_f.map(lambda a: a[rows, :, None]))
        src_f = src_f / torch.clamp(src1_f[rows], min=1e-12)[..., None]
        spec_frames = torch.polar(torch.exp(vt_mag[rows]), vt_ph[rows]) * src_f
        spec_p = torch.view_as_complex(lerp(
            torch.view_as_real(spec_frames).flatten(-2), rows)
            .unflatten(-1, (nspec, 2)).contiguous())       # [b, P, nspec]
        delay = torch.polar(torch.ones_like(spec_p.real),
                            (-2.0 * math.pi) * fbins / fs
                            * (frac[rows] + PULSE_GUARD))
        # continuous-time pulse FT (T/2) A(f) e^{j phase}, sampled: x fs
        pulse_spec = (period[rows, :, None] / 2.0 * fs) * spec_p * lip * delay
        pulses = torch.fft.irfft(pulse_spec, n=nfft) * valid[rows, :, None]
        # pulse sample m sits at onset_int - GUARD + m: add into a
        # GUARD-shifted buffer, then slice the real range
        idx = torch.clamp(onset_int[rows, :, None] + tap, 0, L - 1)
        idx = idx + (torch.arange(s, min(s + group, B), device=dev)
                     * L)[:, None, None]
        y.index_add_(0, idx.reshape(-1), pulses.reshape(-1))
    return y.reshape(B, L)[:, PULSE_GUARD:PULSE_GUARD + nx]


def _pbp_synthesize(opt: SynthesisOptions, chunk: Chunk,
                    bins=None) -> layer0.SynthResult:
    """Batched PbP synthesis of a layer-1 chunk with a leading batch axis
    -> [B, N * nhop] signals at conf.fs.  bins: the noise part's injected
    spectra, as layer0._synth_noise takes them."""
    if not chunk.has_layer1:
        raise ValueError("PbP synthesis requires layer-1 parameters")
    if not opt.use_pallas:
        raise layer0._unported("use_pallas=False (the JAX package's jnp "
                               "branches)", layer0.DSP_KIT)
    if opt.noise_idft != "matmul":
        raise layer0._unported(f"noise_idft={opt.noise_idft!r}",
                               layer0.DSP_KIT)
    conf = chunk.conf
    nhop = conf.nhop
    nx = chunk.nfrm * nhop
    y_sin = _pbp_sin(chunk, max(int(opt.pbp_oversample), 1))
    cyc = harmonics.sample_cycles(chunk.f0, nhop, conf.fs, nx)
    y_nos = layer0._synth_noise(chunk, cyc, nhop, conf.fs, opt.noise_seed,
                                bins=bins)
    return layer0.SynthResult(y=y_sin + y_nos, y_sin=y_sin, y_nos=y_nos,
                              fs=conf.fs)


def pbp_synthesize(opt: SynthesisOptions, chunk: Chunk) -> layer0.SynthResult:
    """Pulse-by-pulse synthesis from a layer-1 chunk, single or batched
    (reference: llsmrt.c PbP mode)."""
    if chunk.f0.dim() > 1:
        return _pbp_synthesize(opt, chunk)
    res = _pbp_synthesize(opt, index_batch(chunk, None))
    return layer0.SynthResult(y=res.y[0], y_sin=res.y_sin[0],
                              y_nos=res.y_nos[0], fs=res.fs)
