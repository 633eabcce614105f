"""Fixed-width frame coder for ML interop (counterpart of
libllsm2_tpu/models/coder.py; reference: coder.c -> llsm_create_coder /
llsm_coder_encode / llsm_coder_decode).

Encodes each layer-1 frame into one fixed-dimension float vector -- F0,
Rd, the band-envelope summary, the vocal-tract magnitude and the log
noise PSD resampled to chosen widths, the envelope harmonics -- and
decodes back.  The coder is lossy in phase: decoding regenerates phases
from the vocal tract's minimum phase and the LF source phase (vsphse = 0),
which is what makes the vectors usable as ML targets; with_phase=True
packs the phases too.  The layout is the JAX package's interchange format.

encode / decode_layer1 / decode_frames / decode are tensor functions that
take a single chunk ([nfrm] frames) or a batched one ([B, nfrm]), and
vectors [nfrm, dims] or [B, nfrm, dims]; numpy vectors go to the card
unless the caller passes device="cpu".  The quantizer (Quantizer,
fit_quantizer, quantize, dequantize) is numpy on the host, as in the JAX
package, so the two packages code the same vectors to the same integers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ChunkConf
from ..container import Chunk, phase_propagate
from ..fp import FP
from ..ops import interp
from . import layer1

LOG_FLOOR = layer1.LOG_FLOOR


@dataclasses.dataclass(frozen=True)
class CoderConfig:
    """Coder dimensions (reference: llsm_create_coder arguments).

    with_phase=True also packs the voice-source residual phases (vsphse)
    and the envelope-harmonic phases (eenv_p), making the round trip
    near-lossless: for storage and transmission rather than ML targets
    (phases are poor regression targets, which is why the default layout
    drops them)."""
    conf: ChunkConf = ChunkConf()
    nvt: int = 64       # vocal-tract magnitude dims in the vector
    npsd_c: int = 32    # noise PSD dims in the vector
    with_phase: bool = False

    @property
    def dims(self) -> int:
        _, off, size = self.layout()[-1]
        return off + size

    def layout(self):
        """(name, start, size) triples describing the vector layout."""
        c = self.conf
        fields = [("f0", 1), ("rd", 1), ("edc", c.nchannel),
                  ("vtmagn", self.nvt), ("psd", self.npsd_c),
                  ("eenv_a", c.nchannel * c.maxnhar_e)]
        if self.with_phase:
            fields += [("eenv_p", c.nchannel * c.maxnhar_e),
                       ("vsphse", c.maxnhar)]
        out, off = [], 0
        for name, size in fields:
            out.append((name, off, size))
            off += size
        return out


def _resample_lastdim(a: torch.Tensor, m: int) -> torch.Tensor:
    n = a.shape[-1]
    pos = torch.linspace(0.0, n - 1.0, m, dtype=FP, device=a.device)
    return interp.interp1_uniform(a, pos)


def _vectors(vectors, device) -> torch.Tensor:
    """Coder vectors as a float32 tensor: a tensor stays on its device
    unless `device` is given; numpy input goes to `device` (default the
    card; no fallback)."""
    if isinstance(vectors, torch.Tensor):
        v = vectors.to(FP)
        return v if device is None else v.to(device)
    return torch.tensor(np.asarray(vectors, np.float32),
                        device="cuda" if device is None else device)


def encode(coder: CoderConfig, chunk: Chunk) -> torch.Tensor:
    """Chunk with layer-1 parameters -> [..., nfrm, coder.dims] float
    vectors (reference: coder.c -> llsm_coder_encode, chunk-wide)."""
    if not chunk.has_layer1:
        raise ValueError("the coder encodes layer-1 chunks")
    psd_log = torch.log(torch.clamp(chunk.psd, min=1e-20))
    parts = [chunk.f0[..., None], chunk.rd[..., None], chunk.edc,
             _resample_lastdim(chunk.vtmagn, coder.nvt),
             _resample_lastdim(psd_log, coder.npsd_c),
             chunk.eenv_a.flatten(-2)]
    if coder.with_phase:
        parts += [chunk.eenv_p.flatten(-2), chunk.vsphse]
    return torch.cat(parts, dim=-1)


def decode_layer1(coder: CoderConfig, vectors, device=None) -> Chunk:
    """[..., nfrm, dims] vectors -> layer-1 chunk (rd, vtmagn and the noise
    model set, harmonics empty): for parameter-domain editing or PbP
    synthesis (reference: coder.c -> the layer-1 variant of
    llsm_coder_decode).  Vectors may come from ML models, so every slot
    is clamped to its physical range: unbounded log-domain values would
    overflow exp() into inf / NaN audio, negative band energies break the
    noise path, a fundamental above conf.f0_ceil overruns PbP's pulse
    budget and rd <= 0 would NaN the LF model.  Real encodes never bind
    the bounds (encode floors psd at log(1e-20) = -46.05, inside -50)."""
    v = _vectors(vectors, device)
    c = coder.conf
    sl = {name: v[..., off:off + size] for name, off, size in coder.layout()}
    lead = v.shape[:-1]
    zeros = lambda *s: torch.zeros(lead + s, dtype=FP, device=v.device)
    f0 = torch.clamp(sl["f0"][..., 0], 0.0, c.f0_ceil)
    vtmagn = torch.clamp(_resample_lastdim(sl["vtmagn"], c.nspec),
                         LOG_FLOOR, 15.0)
    vtmagn = torch.where((f0 > 0)[..., None], vtmagn,
                         torch.full_like(vtmagn, LOG_FLOOR))
    psd = torch.exp(torch.clamp(_resample_lastdim(sl["psd"], c.npsd),
                                -50.0, 30.0))
    env = lambda a: a.reshape(lead + (c.nchannel, c.maxnhar_e)).clone()
    K = c.maxnhar
    return Chunk(
        f0=f0, ampl=zeros(K), phse=zeros(K), hm_mask=zeros(K), psd=psd,
        edc=torch.clamp(sl["edc"], min=0.0), eenv_a=env(sl["eenv_a"]),
        eenv_p=(env(sl["eenv_p"]) if coder.with_phase
                else zeros(c.nchannel, c.maxnhar_e)),
        rd=torch.clamp(sl["rd"][..., 0], layer1.RD_MIN, layer1.RD_MAX),
        vtmagn=vtmagn,
        vsphse=sl["vsphse"].clone() if coder.with_phase else zeros(K),
        conf=c)


def decode_frames(coder: CoderConfig, vectors, device=None) -> Chunk:
    """Streaming decode: [..., M, dims] -> layer-0 frames for a
    block-by-block feed, without the chunk-level phase propagation of
    `decode` (which breaks at block seams).  The phase mode must match the
    coder: with_phase=False frames carry per-frame relative phases (feed
    a synthesizer that propagates phases itself); with_phase=True ones
    the absolute analyzed phases."""
    return layer1.chunk_to_layer0(decode_layer1(coder, vectors, device))


def decode(coder: CoderConfig, vectors, device=None) -> Chunk:
    """[..., nfrm, dims] vectors -> layer-0 chunk ready for synthesis
    (reference: coder.c -> llsm_coder_decode, layer-0 variant): the
    harmonics regenerated from the decoded layer-1 parameters, with
    inter-frame phase coherence restored."""
    chunk = decode_frames(coder, vectors, device)
    if coder.with_phase:
        # vsphse was measured against the absolute analyzed phases, so
        # they are restored already: propagating would corrupt them
        return chunk
    return phase_propagate(chunk, +1)


@dataclasses.dataclass(frozen=True)
class Quantizer:
    """Per-slot affine integer quantizer for coder vectors (numpy on the
    host): code = round((v - lo) / step), v' = lo + code step, with each
    slot's [lo, hi] fitted from data (robust percentiles, so one outlier
    frame cannot blow up a slot's step).

    Slots that hold exact zeros (the F0 slot's unvoiced frames: the
    voicing decision) get lo forced to 0.0, so 0 round-trips bit-exactly.

    Slots flagged in `dpcm` are coded closed-loop DPCM along the frame
    axis: frame 0 absolute, then each frame the saturating delta of the
    true value against the decoder's own reconstruction, on the fitted
    [dlo, dhi] delta range (Rd: its LF harmonic phases move steeply near
    the source-spectrum nulls, so the 8-bit absolute step de-coheres
    pulse shapes frame to frame).

    f0_slot: the F0 slot's index.  When set, the delta range is fitted
    from voiced -> voiced diffs only, unvoiced frames are coded absolute
    and the loop re-syncs absolute at each voiced run's onset; the
    decoder recovers the same voicing flags from the decoded F0 slot, so
    no side channel is needed."""
    lo: "object"            # np.ndarray [dims] float32
    hi: "object"            # np.ndarray [dims] float32
    bits: int = 8
    dpcm: "object" = None   # np.ndarray [dims] bool, or None
    dlo: "object" = None    # np.ndarray [dims] float32 (DPCM slots)
    dhi: "object" = None
    f0_slot: "object" = None   # int, or None (no voicing re-sync)

    @property
    def step(self):
        levels = (1 << self.bits) - 1
        return np.maximum(self.hi - self.lo, 1e-12) / levels

    @property
    def dstep(self):
        levels = (1 << self.bits) - 1
        return np.maximum(self.dhi - self.dlo, 1e-12) / levels


def default_dpcm_mask(coder: CoderConfig):
    """Default DPCM slots for fit_quantizer: the Rd slot (F0 stays
    absolute: its voicing jumps would blow up the delta range)."""
    mask = np.zeros(coder.dims, bool)
    for name, off, size in coder.layout():
        if name == "rd":
            mask[off:off + size] = True
    return mask


def f0_slot(coder: CoderConfig) -> int:
    """Index of the F0 slot in the coder vector (fit_quantizer(f0_slot=)
    : the voicing-aware DPCM re-sync)."""
    for name, off, size in coder.layout():
        if name == "f0":
            return off
    raise ValueError("coder layout has no f0 slot")


def fit_quantizer(vectors, bits: int = 8, pct: float = 0.1,
                  dpcm=None, f0_slot=None) -> Quantizer:
    """Fit per-slot ranges on a reference set of encoded vectors ([N,
    dims] or [B, N, dims], numpy or a tensor).  dpcm: optional bool mask
    [dims] (default_dpcm_mask): those slots get a delta range from the
    frame-to-frame diffs (max |diff| + 25% slew headroom, symmetric) and
    are coded closed-loop.  f0_slot: optional F0 slot index (Quantizer):
    the delta range then comes from voiced -> voiced diffs only, and the
    loop re-syncs at voicing boundaries."""
    vv = _host(vectors)
    v = vv.reshape(-1, vv.shape[-1])
    lo = np.percentile(v, pct, axis=0).astype(np.float32)
    hi = np.percentile(v, 100.0 - pct, axis=0).astype(np.float32)
    has_zero = (v == 0.0).mean(axis=0) > 0.001
    lo = np.where(has_zero & (lo > 0.0), 0.0, lo)
    hi = np.maximum(hi, lo + 1e-6)
    dlo = dhi = None
    if dpcm is not None:
        dpcm = np.asarray(dpcm, bool)
        if f0_slot is not None and dpcm[int(f0_slot)]:
            # the voicing flags come from the F0 slot's codes on both
            # sides: delta-coding it would corrupt every DPCM slot
            raise ValueError("the f0 slot cannot itself be DPCM-coded "
                             "(it carries the voicing re-sync flags)")
        vr = vv.reshape(-1, vv.shape[-2], vv.shape[-1]) \
            if vv.ndim > 2 else vv[None]
        d = np.abs(np.diff(vr, axis=1))                  # [B, N-1, dims]
        if f0_slot is not None and d.size:
            pair_v = (vr[:, 1:, int(f0_slot)] > 0) \
                & (vr[:, :-1, int(f0_slot)] > 0)         # [B, N-1]
            d = np.where(pair_v[:, :, None], d, 0.0)
        dmax = d.max(axis=(0, 1)) if d.size else np.zeros(vv.shape[-1])
        # headroom for closed-loop slew after a saturated step; a floor so
        # an all-constant slot still gets a usable (tiny) range
        r = np.maximum(1.25 * dmax, 1e-4).astype(np.float32)
        dlo, dhi = -r, r
    return Quantizer(lo=lo, hi=hi, bits=int(bits), dpcm=dpcm,
                     dlo=dlo, dhi=dhi,
                     f0_slot=None if f0_slot is None else int(f0_slot))


def _host(vectors) -> np.ndarray:
    """Vectors (numpy or a tensor on any device) as float32 numpy."""
    if isinstance(vectors, torch.Tensor):
        vectors = vectors.detach().cpu()
    return np.asarray(vectors, np.float32)


def _dpcm_voiced(q: Quantizer, codes_2d):
    """Voicing flags [B, N] from the coded F0 slot (exact on the decoder's
    side: the lo-forcing rule makes F0's zeros round-trip bit-exactly);
    all True when the quantizer has no f0_slot."""
    if q.f0_slot is None:
        return np.ones(codes_2d.shape[:2], bool)
    s = int(q.f0_slot)
    return (q.lo[s] + codes_2d[:, :, s] * q.step[s]) > 0


def quantize(q: Quantizer, vectors):
    """[..., N, dims] float -> uint8 / uint16 codes (saturating).  DPCM
    slots are coded closed-loop along the frame axis; with q.f0_slot set,
    unvoiced frames and voiced runs' onsets are coded absolute (re-sync
    points the decoder recovers from the F0 slot)."""
    v = _host(vectors)
    codes = np.round((np.clip(v, q.lo, q.hi) - q.lo) / q.step)
    if q.dpcm is not None and q.dpcm.any():
        m = q.dpcm
        dlo, dstep = q.dlo[m], q.dstep[m]
        flat = v.reshape(-1, *v.shape[-2:])
        out = codes.reshape(-1, *v.shape[-2:])
        voiced = _dpcm_voiced(q, out)
        # frame 0 stays the absolute code; the decoder's state starts there
        recon = q.lo[m] + out[:, 0][:, m] * q.step[m]
        prev_v = voiced[:, 0]
        for n in range(1, v.shape[-2]):
            use_d = (voiced[:, n] & prev_v)[:, None]
            delta = np.clip(flat[:, n][:, m] - recon, dlo, q.dhi[m])
            c = np.round((delta - dlo) / dstep)
            abs_recon = q.lo[m] + out[:, n][:, m] * q.step[m]
            out[:, n][:, m] = np.where(use_d, c, out[:, n][:, m])
            recon = np.where(use_d, recon + dlo + c * dstep, abs_recon)
            prev_v = voiced[:, n]
        codes = out.reshape(v.shape)
    return codes.astype(np.uint8 if q.bits <= 8 else np.uint16)


def dequantize(q: Quantizer, codes):
    """Codes -> float32 vectors (numpy, for decode / decode_frames)."""
    c = np.asarray(codes, np.float32)
    v = (q.lo + c * q.step).astype(np.float32)
    if q.dpcm is not None and q.dpcm.any():
        m = q.dpcm
        dlo, dstep = q.dlo[m], q.dstep[m]
        flat = c.reshape(-1, *c.shape[-2:])
        out = v.reshape(-1, *c.shape[-2:])
        voiced = _dpcm_voiced(q, flat)
        recon = out[:, 0][:, m]
        prev_v = voiced[:, 0]
        for n in range(1, c.shape[-2]):
            use_d = (voiced[:, n] & prev_v)[:, None]
            recon = np.where(use_d, recon + dlo + flat[:, n][:, m] * dstep,
                             out[:, n][:, m])
            out[:, n][:, m] = recon
            prev_v = voiced[:, n]
        v = out.reshape(c.shape)
    return v
