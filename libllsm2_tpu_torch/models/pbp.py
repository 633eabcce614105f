"""Pulse-by-pulse (PbP) synthesis of the PyTorch port: each glottal pulse
rendered from the LF model through the vocal-tract filter (counterpart of
libllsm2_tpu/models/pbp.py; reference: llsmrt.c PbP mode).

A static pulse budget (duration x conf.f0_ceil) per utterance; the onsets
invert the piecewise-linear cumulative cycle count; every pulse is one
row of a batched spectral synthesis (the frames' combined LF x minimum-
phase tract spectra, lerped to the onset, x lip radiation x a fractional
delay -> irfft), added into the output at its onset in an order that
depends on the row alone (_overlap_add).  The noise part is layer-0's
(layer0._synth_noise: with the kernels on, kernels.noise_mod_ola runs, or
noise_mod_ola_seg with noise_idft="fft"; with use_pallas=False the JAX
package's jnp tail).  The JAX package's
comments give the measured reasons for the lerp of combined spectra, the
linear envelope upsampling and the guard.
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
# elements of the [rows, P, nfft] pulse buffer per row group, and at most
# PULSE_ROWS rows a group: every group's irfft is padded to the group's
# rows, so a batch of one pays that many rows of short utterances
_PULSE_ELEMS = 1 << 27
PULSE_ROWS = 16
# fixed point of the cycle count's sum: 2^-40 cycles, and 8 s at
# conf.f0_ceil stays far below 2^63
_CYCLE_ONE = 2.0 ** 40


def _pulse_onsets(f0: torch.Tensor, thop: float, p_max: int):
    """Onset times (seconds) of each glottal cycle of every utterance, the
    frame each falls in, and the validity mask, all [B, p_max]: F0 held
    per frame is integrated over frames, and the monotone cycle count
    inverted at 0..p_max-1.  The count is summed exactly, in int64 fixed
    point, and rounded once to float32 (the JAX package sums in float32):
    a float32 cumsum's value depends on its order, which on the card
    depends on the batch (a single row takes another scan), and moved a
    row's onsets by ~1e-4 cycles."""
    B, n = f0.shape
    dev = f0.device
    d = torch.where(f0 > 0, f0, torch.zeros_like(f0)) * thop
    fixed = torch.round(d.double() * _CYCLE_ONE).to(torch.int64)
    cum = (torch.nn.functional.pad(torch.cumsum(fixed, dim=-1), (1, 0))
           .double() / _CYCLE_ONE).to(FP)                        # [B, n+1]
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
    if B > 1 and dev.type == "cpu":
        # PyTorch's CPU loops compute a tensor's tail (and each thread's
        # share's) with scalar libm, the rest with SLEEF vectors, which
        # differ in the last bit: on the CPU each row is a call of its own
        return torch.cat([_pbp_sin(chunk.map(lambda a: a[b:b + 1]), os_)
                          for b in range(B)])
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
    vt_ph = spectral.upsample_linear(layer1.minphase_rows(chunk.vtmagn), os_)
    # sub-sample alignment: linear phase for the fractional onset delay
    # plus a GUARD shift, so the delay kernel's acausal tail stays inside
    # the irfft window
    onset = t_on * fs
    onset_int = torch.floor(onset).to(torch.int64)
    frac = (onset - onset_int)[..., None]
    L = nx + PULSE_GUARD + nfft
    # pulse sample m sits at onset_int - GUARD + m: a GUARD-shifted buffer
    # of L samples a row, then nfft more where the invalid pulses land
    start = torch.where(valid, onset_int, torch.full_like(onset_int, L))
    m, count = _overlap_classes(onset_int, valid, nfft)
    y = torch.zeros((B, L + nfft), dtype=FP, device=dev)
    group = max(1, min(PULSE_ROWS, _PULSE_ELEMS // (p_max * nfft)))
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
        # cuFFT plans follow the transform count: every call transforms
        # the pulses of `group` rows, the last group zero-padded
        pulses = layer0._row_groups(lambda a: torch.fft.irfft(a, n=nfft),
                                    pulse_spec, group)
        _overlap_add(y[rows], pulses, start[rows], m[rows], count[rows])
    return y[:, PULSE_GUARD:PULSE_GUARD + nx]


def _overlap_classes(onset_int: torch.Tensor, valid: torch.Tensor,
                     nfft: int) -> torch.Tensor:
    """Per row, an M such that pulses p and p + M, for every p below the
    row's last valid pulse, lie at least nfft samples apart (so their
    windows cannot overlap): ceil(nfft / the row's shortest onset
    spacing), which the row's own onsets set -> (M, the row's last valid
    pulse + 1), [B] int64 each."""
    P = onset_int.shape[-1]
    p = torch.arange(P, device=onset_int.device)
    count = torch.amax(torch.where(valid, p + 1, 0), dim=-1)     # [B]
    gap = onset_int[:, 1:] - onset_int[:, :-1]
    gap = torch.where(p[1:] < count[:, None], gap, torch.full_like(gap, nfft))
    dmin = torch.clamp(torch.amin(gap, dim=-1), min=1) if P > 1 \
        else torch.full_like(count, nfft)
    return torch.clamp(-(-nfft // dmin), 1, max(P, 1)), count


def _overlap_add(y: torch.Tensor, pulses: torch.Tensor, start: torch.Tensor,
                 m: torch.Tensor, count: torch.Tensor) -> None:
    """y[b, start[b, p] + t] += pulses[b, p, t] for rows y [b, W] in place,
    with no atomic adds: row b's pulses p = c + k m[b] (class c) below
    count[b] have disjoint windows (_overlap_classes), so each class is one
    gather, add and store with distinct addresses, and the classes add in
    order c = 0, 1, ...: every sample sums its pulses in an order that
    depends on its row alone, on the CPU and on the card.  start[b, p] =
    W - nfft puts a pulse in the tail that no caller reads (invalid
    pulses)."""
    b, P, nfft = pulses.shape
    if b == 0 or P == 0:
        return
    W = y.shape[-1]
    dev = y.device
    n_cls, per = (int(v) for v in torch.stack(
        [m.max(), torch.amax(-(-count // m))]).tolist())
    # every class's pulses p = c + k m [n_cls, b, per] and the flat index of
    # their first samples (dead slots to the tail), made once
    c = torch.arange(n_cls, device=dev)[:, None, None]
    p = c + torch.arange(max(per, 1), device=dev) * m[:, None]
    live = (p < count[:, None]) & (c < m[:, None])
    p = torch.clamp(p, max=P - 1)
    first = torch.where(live, torch.gather(start.expand(n_cls, -1, -1), 2, p),
                        W - nfft) + (torch.arange(b, device=dev) * W)[:, None]
    tap = torch.arange(nfft, device=dev)
    flat = y.view(-1)
    for i in range(n_cls):
        addr = (first[i][..., None] + tap).view(-1)
        v = torch.gather(pulses, 1, p[i][..., None].expand(-1, -1, nfft))
        flat[addr] = flat[addr] + v.view(-1)


def _pbp_synthesize(opt: SynthesisOptions, chunk: Chunk,
                    bins=None) -> layer0.SynthResult:
    """Batched PbP synthesis of a layer-1 chunk with a leading batch axis
    -> [B, N * nhop] signals at conf.fs.  bins: the noise part's injected
    spectra, as layer0._synth_noise takes them."""
    if not chunk.has_layer1:
        raise ValueError("PbP synthesis requires layer-1 parameters")
    conf = chunk.conf
    nhop = conf.nhop
    nx = chunk.nfrm * nhop
    y_sin = _pbp_sin(chunk, max(int(opt.pbp_oversample), 1))
    cyc = harmonics.sample_cycles(chunk.f0, nhop, conf.fs, nx)
    y_nos = layer0._synth_noise(chunk, cyc, nhop, conf.fs, opt.noise_seed,
                                bins=bins, use_pallas=opt.use_pallas,
                                idft=opt.noise_idft)
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
