"""Parameter-domain edits (counterpart of libllsm2_tpu/models/edits.py):
pitch shift with formant preservation, time stretch via frame
interpolation (BASELINE config 4), vibrato / tremolo, formant shift,
breathiness, creak, two-utterance voice morphing, phase-coherent chunk
concatenation and excerpts.  The reference exposes all of these as
user-side manipulations of the chunk between llsm_chunk_tolayer1 and
llsm_chunk_tolayer0 (the C library ships the phase utilities; the edits
are user code there too).

Every edit is a chunk -> chunk function on the chunk's device and takes
a chunk with or without leading batch axes (the frame axis is the last
axis of f0; the JAX package edits one utterance); edits compose.  The
harmonics are regenerated through models/layer1.chunk_to_layer0, whose
kernels-free tensor code runs wherever the chunk lives.
"""
from __future__ import annotations

import math

import torch

from ..container import (CHUNK_FIELDS, LAYER1_FIELDS, Chunk, _frac, _wrap,
                         cumulative_cycles, phase_propagate)
from ..fp import FP
from . import layer1


def _frame_axis(chunk: Chunk) -> int:
    return chunk.f0.dim() - 1


def _require_layer1(chunk: Chunk, what: str) -> None:
    if not chunk.has_layer1:
        raise ValueError(f"{what} requires layer-1 parameters "
                         "(layer1.chunk_to_layer1)")


def _require_same_conf(a: Chunk, b: Chunk, what: str) -> None:
    if a.conf != b.conf:
        raise ValueError(f"{what} requires matching ChunkConf")


def _vs_propagate(vsphse: torch.Tensor, f0: torch.Tensor, thop: float,
                  sign: int) -> torch.Tensor:
    """Add (+1) / remove (-1) the fundamental's linear inter-frame ramp
    2 pi (k+1) cumcycles_i from the voice-source phases, the vsphse analog
    of container.phase_propagate (vsphse inherits the ramp from phse
    through layer 1's vsphse = phse - minphase - source definition)."""
    K = vsphse.shape[-1]
    cyc = cumulative_cycles(f0, thop)                       # [..., N]
    kharm = torch.arange(1, K + 1, dtype=FP, device=cyc.device)
    ph = _frac(cyc[..., :, None] * kharm)
    return _wrap(vsphse + sign * 2.0 * math.pi * ph)


def _repitch_vsphse(chunk: Chunk, f0_new: torch.Tensor) -> Chunk:
    """Re-anchor the voice-source phases to a new F0 track: remove the old
    fundamental ramp, re-add the new one, so the regenerated layer-0
    phases advance at the new rate (without it the synthesis OLA partially
    cancels; the JAX package's test_pitch_shift_phase_coherence measures
    it)."""
    rel = _vs_propagate(chunk.vsphse, chunk.f0, chunk.conf.thop, -1)
    vs = _vs_propagate(rel, f0_new, chunk.conf.thop, +1)
    return chunk.replace(f0=f0_new, vsphse=vs)


def _frame_times(chunk: Chunk) -> torch.Tensor:
    """Frame centre times [N] in seconds, float64."""
    return torch.arange(chunk.nfrm, dtype=torch.float64,
                        device=chunk.f0.device) * chunk.conf.thop


def _sine(rate_hz: float, t: torch.Tensor) -> torch.Tensor:
    """sin(2 pi rate t) in float32, its argument taken in cycles mod 1
    first (t float64)."""
    return torch.sin(2.0 * math.pi * _frac(rate_hz * t)).to(FP)


def pitch_shift(chunk: Chunk, ratio: float) -> Chunk:
    """Multiply F0 by `ratio`, preserving formants via the layer-1
    vocal-tract envelope: the harmonics are regenerated from the
    F0-independent envelope (layer1.c -> llsm_frame_tolayer0 after editing
    f0), the voice-source phases re-propagated onto the new F0 track so
    the inter-frame phase advance stays OLA-coherent.  The chunk must
    carry layer-1 parameters."""
    _require_layer1(chunk, "pitch_shift")
    return layer1.chunk_to_layer0(_repitch_vsphse(chunk, chunk.f0 * ratio))


def vibrato(chunk: Chunk, rate_hz: float = 5.5,
            depth_semitones: float = 0.35) -> Chunk:
    """Sinusoidal pitch vibrato: f0 *= 2^(depth/12 * sin(2 pi rate t)),
    formants preserved as in pitch_shift.  The chunk must carry layer-1
    parameters."""
    _require_layer1(chunk, "vibrato")
    mod = 2.0 ** ((depth_semitones / 12.0)
                  * _sine(rate_hz, _frame_times(chunk)))
    return layer1.chunk_to_layer0(_repitch_vsphse(chunk, chunk.f0 * mod))


def tremolo(chunk: Chunk, rate_hz: float = 5.5,
            depth_db: float = 3.0) -> Chunk:
    """Sinusoidal amplitude modulation of both components:
    gain_i = 10^(depth/20 * sin(2 pi rate t_i)) scales harmonic and noise
    amplitudes (psd is linear power -> gain^2).  Works on layer-0 chunks;
    layer-1 parameters, if present, stay as they were (vtmagn describes
    the un-modulated tract)."""
    g = 10.0 ** ((depth_db / 20.0) * _sine(rate_hz, _frame_times(chunk)))
    return chunk.replace(ampl=chunk.ampl * g[:, None],
                         psd=chunk.psd * (g * g)[:, None],
                         edc=chunk.edc * g[:, None],
                         eenv_a=chunk.eenv_a * g[:, None, None])


def _interp_frames(a: torch.Tensor, pos: torch.Tensor,
                   axis: int) -> torch.Tensor:
    """Linear interpolation of per-frame data (frames on `axis`) at
    fractional frame positions pos [M] -> the same layout with M frames."""
    n = a.shape[axis]
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    t = torch.clamp(pos - i0, 0.0, 1.0)
    t = t.reshape(t.shape + (1,) * (a.dim() - axis - 1))
    return (a.index_select(axis, i0) * (1.0 - t)
            + a.index_select(axis, i0 + 1) * t)


def _interp_circular(ph: torch.Tensor, w: torch.Tensor, pos: torch.Tensor,
                     axis: int) -> torch.Tensor:
    """Amplitude-weighted circular interpolation of phases."""
    return torch.angle(_interp_frames(torch.polar(w, ph), pos, axis))


def _retime(chunk: Chunk, pos: torch.Tensor) -> Chunk:
    """Resample a chunk's frames at fractional source positions [M],
    returning a RELATIVE-phase chunk (phse and vsphse have the
    fundamental's inter-frame ramp removed; callers re-propagate onto the
    retimed F0 track).  Shared core of time_stretch and morph; extras are
    dropped."""
    n, ax = chunk.nfrm, _frame_axis(chunk)
    rel = phase_propagate(chunk, -1)

    # voicing: a target frame is voiced only if both source neighbors are
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    voiced = chunk.f0 > 0
    voiced_new = voiced[..., i0] & voiced[..., i0 + 1]

    f0i = _interp_frames(chunk.f0, pos, ax)
    f0_new = torch.where(voiced_new, f0i, torch.zeros_like(f0i))

    w = torch.clamp(rel.ampl, min=1e-8)
    ampl = _interp_frames(rel.ampl, pos, ax)
    phse = _interp_circular(rel.phse, w, pos, ax)
    mask = (_interp_frames(rel.hm_mask, pos, ax) > 0.999).to(FP)
    mask = mask * voiced_new[..., None]

    vsphse = None
    if chunk.vsphse is not None:
        vs_rel = _vs_propagate(chunk.vsphse, chunk.f0, chunk.conf.thop, -1)
        vsphse = _interp_circular(vs_rel, w, pos, ax)
    opt = lambda a: None if a is None else _interp_frames(a, pos, ax)
    return Chunk(
        f0=f0_new, ampl=ampl * mask, phse=phse * mask, hm_mask=mask,
        psd=_interp_frames(chunk.psd, pos, ax),
        edc=_interp_frames(chunk.edc, pos, ax),
        eenv_a=_interp_frames(chunk.eenv_a, pos, ax),
        eenv_p=_interp_circular(chunk.eenv_p,
                                torch.clamp(chunk.eenv_a, min=1e-8), pos, ax),
        rd=opt(chunk.rd), vtmagn=opt(chunk.vtmagn), vsphse=vsphse,
        conf=chunk.conf)


def _reramp(rel: Chunk) -> Chunk:
    """Restore absolute phases on a relative-domain chunk: re-add the
    fundamental ramp of rel.f0 to phse and vsphse."""
    out = phase_propagate(rel, +1)
    if rel.vsphse is not None:
        out = out.replace(vsphse=_vs_propagate(
            rel.vsphse, rel.f0, rel.conf.thop, +1))
    return out


def time_stretch(chunk: Chunk, ratio: float) -> Chunk:
    """Stretch the utterance duration by `ratio` via frame interpolation
    (BASELINE config 4: x1.5) to max(round(nfrm ratio), 2) frames.  Phases
    are made relative with phase_propagate(-1), interpolated circularly,
    then re-propagated over the new frame grid (voice-source phases get
    the same treatment, keeping layer-1 / PbP renders coherent)."""
    n = chunk.nfrm
    m = max(int(round(n * ratio)), 2)
    pos = torch.clamp(torch.arange(m, dtype=FP, device=chunk.f0.device)
                      / ratio, 0.0, n - 1.0)
    return _reramp(_retime(chunk, pos))


def formant_shift(chunk: Chunk, ratio: float) -> Chunk:
    """Scale all formant frequencies by `ratio` (> 1 raises them) by
    warping the layer-1 vocal-tract envelope's frequency axis (two-tap
    interpolation of each bin from its source bins, a gather), then
    regenerate the layer-0 harmonics; F0 is untouched.  The chunk must
    carry layer-1 parameters."""
    _require_layer1(chunk, "formant_shift")
    nspec = chunk.vtmagn.shape[-1]
    pos = torch.arange(nspec, dtype=FP, device=chunk.vtmagn.device) / ratio
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, nspec - 2)
    t = torch.clamp(pos - i0, 0.0, 1.0)
    vt = chunk.vtmagn[..., i0] * (1.0 - t) + chunk.vtmagn[..., i0 + 1] * t
    return layer1.chunk_to_layer0(chunk.replace(vtmagn=vt))


def breathiness(chunk: Chunk, gain_db: float,
                rd_delta: float = 0.0) -> Chunk:
    """Scale the noise component by `gain_db` (aspiration level) and
    optionally relax the glottal tension (rd_delta > 0 is breathier);
    harmonics are regenerated only when Rd changes.  psd is linear power
    on the warped axis and edc / eenv_a are amplitude envelopes, so power
    scales by g^2 and amplitudes by g."""
    g = float(10.0 ** (gain_db / 20.0))
    out = chunk.replace(psd=chunk.psd * g * g, edc=chunk.edc * g,
                        eenv_a=chunk.eenv_a * g)
    if rd_delta != 0.0:
        _require_layer1(out, "breathiness(rd_delta=...)")
        out = out.replace(rd=torch.clamp(out.rd + rd_delta, 0.1, 2.7))
        out = layer1.chunk_to_layer0(out)
    return out


def creak(chunk: Chunk, depth: float = 0.5, subdiv: int = 2) -> Chunk:
    """Creaky voice / vocal fry: re-render the utterance at f0/subdiv with
    the in-between (sub)harmonics scaled by `depth` relative to the
    vocal-tract envelope (the harmonic-domain signature of a
    period-`subdiv` pulse train with alternating amplitudes; depth 0 is
    the original voice at a nominal f0/subdiv, depth 1 full diplophonia).
    The harmonic grid halves its bandwidth coverage.  Requires layer-1
    parameters."""
    _require_layer1(chunk, "creak")
    out = layer1.chunk_to_layer0(
        _repitch_vsphse(chunk, chunk.f0 / float(subdiv)))
    k = torch.arange(1, out.ampl.shape[-1] + 1, device=out.ampl.device)
    scale = torch.where((k % subdiv) != 0, depth, 1.0).to(FP)
    return out.replace(ampl=out.ampl * scale)


# ---------------------------------------------------------------------------
# Two-chunk edits: voice morphing and phase-coherent concatenation
# ---------------------------------------------------------------------------

def _blend_frames(a: Chunk, b: Chunk, wb: torch.Tensor) -> Chunk:
    """Per-frame blend of two RELATIVE-phase chunks on the same frame grid
    with per-frame b-weight wb (broadcast to f0's shape; wa = 1 - wb).
    Where both are voiced, F0 blends geometrically, log-domain fields
    (vtmagn) linearly, phases circularly (amplitude-weighted); where only
    one is voiced that side wins outright; voicing follows the dominant
    side.  Noise fields blend in the log domain unconditionally.  Returns
    a relative-domain chunk."""
    _require_same_conf(a, b, "blend")
    wb = torch.clamp(wb, 0.0, 1.0).expand(a.f0.shape)
    wa = 1.0 - wb
    va, vb = a.f0 > 0, b.f0 > 0
    both = va & vb
    f0g = torch.exp(wa * torch.log(torch.clamp(a.f0, min=1e-3))
                    + wb * torch.log(torch.clamp(b.f0, min=1e-3)))
    voiced = both | (va & (wa > 0.5)) | (vb & (wb > 0.5))
    f0 = torch.where(both, f0g, torch.where(va, a.f0, b.f0)) * voiced

    wa_c, wb_c = wa[..., None], wb[..., None]
    ampl = wa_c * a.ampl + wb_c * b.ampl
    z = (torch.polar(wa_c * a.ampl, a.phse)
         + torch.polar(wb_c * b.ampl, b.phse))
    phse = torch.angle(z)
    mask = ((wa_c * a.hm_mask + wb_c * b.hm_mask) > 1e-3).to(FP)
    mask = mask * voiced[..., None]

    def log_lerp(x, y, floor):
        tail = (1,) * (x.dim() - wa.dim())
        return torch.exp(wa.reshape(wa.shape + tail)
                         * torch.log(torch.clamp(x, min=floor))
                         + wb.reshape(wb.shape + tail)
                         * torch.log(torch.clamp(y, min=floor)))

    ze = (torch.polar(wa[..., None, None] * a.eenv_a, a.eenv_p)
          + torch.polar(wb[..., None, None] * b.eenv_a, b.eenv_p))

    rd = vtmagn = vsphse = None
    if a.has_layer1 and b.has_layer1:
        rd = torch.where(both, wa * a.rd + wb * b.rd,
                         torch.where(va, a.rd, b.rd))
        vtmagn = torch.where(both[..., None],
                             wa_c * a.vtmagn + wb_c * b.vtmagn,
                             torch.where(va[..., None], a.vtmagn, b.vtmagn))
        zs = (torch.polar(wa_c * torch.clamp(a.ampl, min=1e-8), a.vsphse)
              + torch.polar(wb_c * torch.clamp(b.ampl, min=1e-8), b.vsphse))
        vsphse = torch.angle(zs)

    return Chunk(
        f0=f0, ampl=ampl * mask, phse=phse * mask, hm_mask=mask,
        psd=log_lerp(a.psd, b.psd, 1e-12),
        edc=log_lerp(a.edc, b.edc, 1e-10),
        eenv_a=log_lerp(a.eenv_a, b.eenv_a, 1e-10),
        eenv_p=torch.angle(ze),
        rd=rd, vtmagn=vtmagn, vsphse=vsphse, conf=a.conf)


def _relative(c: Chunk) -> Chunk:
    """phse and vsphse with the fundamental's ramp removed."""
    r = phase_propagate(c, -1)
    if c.vsphse is not None:
        r = r.replace(vsphse=_vs_propagate(c.vsphse, c.f0, c.conf.thop, -1))
    return r


def morph(a: Chunk, b: Chunk, t) -> Chunk:
    """Voice morph between two layer-1 chunks: 0 -> a, 1 -> b, with b
    linearly time-normalized onto a's frame grid.  F0 interpolates
    geometrically, the vocal-tract envelope linearly in the log domain,
    Rd linearly and the noise model in the log-power domain; harmonics
    are regenerated from the blended layer-1 parameters (layer1.c ->
    llsm_frame_tolayer0), so the result is a valid utterance at every t.
    `t` may be a scalar or per frame ([nfrm], or f0's shape)."""
    if not (a.has_layer1 and b.has_layer1):
        raise ValueError("morph requires layer-1 chunks")
    _require_same_conf(a, b, "morph")
    na, nb = a.nfrm, b.nfrm
    pos = (torch.arange(na, dtype=FP, device=a.f0.device)
           * ((nb - 1.0) / max(na - 1.0, 1.0)))
    b_on_a = _retime(b, pos)
    wb = torch.as_tensor(t, dtype=FP, device=a.f0.device)
    blended = _blend_frames(_relative(a), b_on_a, wb)
    return layer1.chunk_to_layer0(_reramp(blended))


def concat(a: Chunk, b: Chunk, crossfade_frames: int = 8) -> Chunk:
    """Splice chunk b after chunk a with a phase-coherent crossfade of
    `crossfade_frames` frames: both chunks are taken to relative phase
    (phase_propagate(-1)), b's phases are rotated per harmonic into a's
    convention by their amplitude-weighted circular offset over the
    overlap (an all-pass correction that makes re-splicing a chunk
    transparent), the overlap is frame-blended, and phases are
    re-propagated over the joined F0 track.  Layer-1 parameters are
    blended when both chunks carry them, otherwise dropped."""
    _require_same_conf(a, b, "concat")
    na, nb = a.nfrm, b.nfrm
    xf = int(crossfade_frames)
    if not 0 < xf <= min(na, nb):
        raise ValueError("concat: the crossfade must fit inside both chunks")
    n = na + nb - xf
    ax = _frame_axis(a)
    tail = lambda v: v.narrow(ax, na - xf, xf)
    head = lambda v: v.narrow(ax, 0, xf)

    ra, rb = _relative(a), _relative(b)
    has_l1 = a.has_layer1 and b.has_layer1
    both = (tail(ra.f0) > 0) & (head(rb.f0) > 0)
    wov = tail(ra.ampl) * head(rb.ampl) * both[..., None]
    zov = torch.sum(torch.polar(wov, tail(ra.phse) - head(rb.phse)),
                    dim=ax)                                    # [..., K]
    rot = torch.where(torch.abs(zov) > 1e-12, torch.angle(zov),
                      torch.zeros_like(wov[..., 0, :]))[..., None, :]
    rb = rb.replace(phse=_wrap(rb.phse + rot) * rb.hm_mask)
    if has_l1:
        rb = rb.replace(vsphse=_wrap(rb.vsphse + rot))

    def pad(v, before):
        if v is None:
            return None
        extra = n - v.shape[ax]
        pads = (0, 0) * (v.dim() - ax - 1) + ((extra, 0) if before
                                              else (0, extra))
        return torch.nn.functional.pad(v, pads)

    def extend(c, before):
        return Chunk(**{f: pad(getattr(c, f), before) for f in CHUNK_FIELDS
                        if has_l1 or f not in LAYER1_FIELDS},
                     conf=c.conf)

    ramp = (torch.arange(xf, dtype=FP, device=a.f0.device) + 0.5) / xf
    wb = torch.cat([torch.zeros(na - xf, dtype=FP, device=a.f0.device), ramp,
                    torch.ones(nb - xf, dtype=FP, device=a.f0.device)])
    return _reramp(_blend_frames(extend(ra, False), extend(rb, True), wb))


def excerpt(chunk: Chunk, start: int, stop: int) -> Chunk:
    """Cut frames [start, stop) out of a chunk (extras included).
    Frame-centre phases stay mutually consistent under slicing (synthesis
    places frame i at i*thop and only relative timing between adjacent
    frames matters), so this is a plain frame-axis slice of every
    per-frame field."""
    sl = (slice(None),) * _frame_axis(chunk) + (slice(start, stop),)
    return chunk.map(lambda a: a[sl])
