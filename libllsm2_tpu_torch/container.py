"""Chunk data model of the PyTorch port (counterpart of
libllsm2_tpu/container.py; reference: frame.c -> llsm_hmframe /
llsm_nmframe / llsm_chunk).

A chunk is one struct of tensors padded to conf.maxnhar (etc.) with an
explicit validity mask, so one utterance or a whole batch (leading batch
axes) is one set of rectangular tensors.  The layouts are the JAX
package's: ``[..., N, K]`` for harmonic fields, ``[..., N, C, Ke]`` for the
envelope harmonics.  ``chunk_from_numpy`` / ``chunk_to_numpy`` carry a
chunk across the two packages as numpy arrays.  The phase utilities
(cumulative_cycles, phase_propagate, phase_shift, phase_sync; reference:
frame.c) take a chunk with or without leading batch axes: the frame axis
is the last axis of f0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch

from .config import ChunkConf
from .fp import FP

#: the layer-0 fields every chunk carries, in declaration order
LAYER0_FIELDS = ("f0", "ampl", "phse", "hm_mask", "psd", "edc", "eenv_a",
                 "eenv_p")
LAYER1_FIELDS = ("rd", "vtmagn", "vsphse")
CHUNK_FIELDS = LAYER0_FIELDS + LAYER1_FIELDS


@dataclasses.dataclass
class Chunk:
    """One utterance (or a batch, with leading batch axes) of LLSM frames.

    Harmonic model:
      f0        [..., N]        F0 per frame, Hz; 0 = unvoiced
      ampl      [..., N, K]     harmonic amplitudes, slot k = harmonic (k+1)*f0
      phse      [..., N, K]     harmonic phases at the frame center [rad]
      hm_mask   [..., N, K]     1 where the harmonic exists
    Noise model:
      psd       [..., N, npsd]  residual PSD on the warped axis (linear power)
      edc       [..., N, C]     per-channel temporal-envelope DC (amplitude)
      eenv_a/p  [..., N, C, Ke] envelope harmonic amplitudes / phases
    Layer 1 (models.layer1.chunk_to_layer1; None on a layer-0 chunk):
      rd        [..., N]        LF glottal shape parameter per frame
      vtmagn    [..., N, nspec] vocal-tract LOG magnitude on the rfft grid
      vsphse    [..., N, K]     voice-source phase residual [rad]
    """

    f0: torch.Tensor
    ampl: torch.Tensor
    phse: torch.Tensor
    hm_mask: torch.Tensor
    psd: torch.Tensor
    edc: torch.Tensor
    eenv_a: torch.Tensor
    eenv_p: torch.Tensor
    rd: Optional[torch.Tensor] = None
    vtmagn: Optional[torch.Tensor] = None
    vsphse: Optional[torch.Tensor] = None
    # user-attached entries (reference: container.c -> llsm_container_attach:
    # the C container holds arbitrary extra slots; here a string-keyed dict
    # of tensors, per frame on the frame axis)
    extras: Optional[dict] = None
    conf: ChunkConf = ChunkConf()

    @property
    def nfrm(self) -> int:
        return self.f0.shape[-1]

    @property
    def has_layer1(self) -> bool:
        return self.rd is not None

    @property
    def voiced(self) -> torch.Tensor:
        return self.f0 > 0.0

    def replace(self, **kw) -> "Chunk":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "Chunk":
        """fn applied to every tensor field and every extra."""
        return self.replace(
            **{f: fn(getattr(self, f)) for f in CHUNK_FIELDS
               if getattr(self, f) is not None},
            extras=None if self.extras is None else
            {k: fn(v) for k, v in self.extras.items()})

    def frame(self, i: int) -> "Chunk":
        """Single-frame view (keeps the frame axis with length 1), the
        analog of indexing chunk->frames[i] in the reference."""
        axis = self.f0.dim() - 1
        return self.map(lambda a: a.narrow(axis, i, 1))

    # -- generic attachment (reference: container.c ->
    #    llsm_container_attach / _detach / _get) --------------------------
    def attach(self, name: str, value) -> "Chunk":
        extras = dict(self.extras or {})
        extras[name] = value
        return self.replace(extras=extras)

    def detach(self, name: str) -> "Chunk":
        extras = dict(self.extras or {})
        extras.pop(name, None)
        return self.replace(extras=extras or None)

    def get(self, name: str, default=None):
        return (self.extras or {}).get(name, default)


def index_batch(chunk: Chunk, i) -> Chunk:
    """Every tensor field (and extra) indexed by i on its leading axis: i =
    None adds a batch axis to a single-utterance chunk, i = 0 takes the
    first row."""
    return chunk.map(lambda a: a[i])


def create_chunk(conf: ChunkConf, nfrm: int, batch_shape=(),
                 device=None) -> Chunk:
    """Zero-initialized layer-0 chunk (reference: frame.c ->
    llsm_create_chunk) on `device`: the card unless the caller passes
    device="cpu" (no fallback: without a card the default raises)."""
    device = "cuda" if device is None else device
    z = lambda *s: torch.zeros(tuple(batch_shape) + s, dtype=FP,
                               device=device)
    K, C, Ke = conf.maxnhar, conf.nchannel, conf.maxnhar_e
    return Chunk(
        f0=z(nfrm), ampl=z(nfrm, K), phse=z(nfrm, K), hm_mask=z(nfrm, K),
        psd=z(nfrm, conf.npsd), edc=z(nfrm, C),
        eenv_a=z(nfrm, C, Ke), eenv_p=z(nfrm, C, Ke), conf=conf)


def chunk_from_numpy(d: Mapping[str, np.ndarray], conf: ChunkConf,
                     device="cuda") -> Chunk:
    """Chunk from a mapping of field name -> array (e.g. the fields of a
    JAX-package chunk passed through ``np.asarray``), as float32 tensors
    on `device`: the card unless the caller passes ``device="cpu"`` (no
    fallback: without a card the default raises).  The layer-0 fields are
    required; layer-1 ones optional."""
    missing = [f for f in LAYER0_FIELDS if f not in d]
    if missing:
        raise KeyError(f"chunk fields missing: {missing}")

    def conv(a):
        return None if a is None else torch.tensor(
            np.asarray(a, np.float32), device=device)

    return Chunk(**{f: conv(d.get(f)) for f in CHUNK_FIELDS},
                 conf=conf)


def chunk_to_numpy(chunk: Chunk) -> dict:
    """Field name -> float32 numpy array for every tensor field set."""
    out = {}
    for f in CHUNK_FIELDS:
        v = getattr(chunk, f)
        if v is not None:
            out[f] = v.detach().to("cpu", FP).numpy()
    return out


# ---------------------------------------------------------------------------
# Phase utilities (reference: frame.c -> llsm_frame_phaseshift,
# llsm_frame_phasesync, llsm_chunk_phasepropagate)
# ---------------------------------------------------------------------------

def _frac(x: torch.Tensor) -> torch.Tensor:
    return x - torch.floor(x)


def _wrap(ph: torch.Tensor) -> torch.Tensor:
    """Radians wrapped to (-pi, pi]."""
    return torch.atan2(torch.sin(ph), torch.cos(ph))


def cumulative_cycles(f0: torch.Tensor, thop: float) -> torch.Tensor:
    """Fundamental phase in cycles (mod 1) at each frame centre:
    c_i = frac(sum_{j<i} 0.5 (f0_j + f0_{j+1}) thop) over f0 [..., N]
    (unvoiced frames count 0 Hz): the trapezoidal integral of the linear
    interpolation of the frame-rate track, as ops.harmonics.sample_cycles
    integrates it.  The JAX package scans in float32 with a frac at every
    combine; the port sums in float64 and takes one frac, so the result
    sits within float32 rounding of the float64 integral at any length."""
    f0z = torch.clamp(f0, min=0.0).to(torch.float64)
    d = 0.5 * (f0z[..., :-1] + f0z[..., 1:]) * thop
    c = torch.nn.functional.pad(torch.cumsum(d, dim=-1), (1, 0))
    return _frac(_frac(c).to(FP))


def phase_propagate(chunk: Chunk, sign: int) -> Chunk:
    """Add (sign=+1) or remove (sign=-1) the linear inter-frame phase
    advance 2 pi (k+1) * cumcycles_i from every harmonic phase.

    After propagate(-1), phases are relative (edit-friendly: frames can be
    interpolated / retimed); propagate(+1) restores absolute phase
    coherence before synthesis.  Reference: frame.c ->
    llsm_chunk_phasepropagate."""
    K = chunk.ampl.shape[-1]
    cyc = cumulative_cycles(chunk.f0, chunk.conf.thop)      # [..., N]
    kharm = torch.arange(1, K + 1, dtype=FP, device=cyc.device)
    ph = _frac(cyc[..., :, None] * kharm)                   # [..., N, K]
    phse = _wrap(chunk.phse + sign * 2.0 * math.pi * ph)
    return chunk.replace(phse=phse * chunk.hm_mask)


def phase_shift(chunk: Chunk, dt: float) -> Chunk:
    """Shift every frame's harmonic phases by a time offset dt [s]:
    phi_k += 2 pi (k+1) f0 dt (reference: frame.c -> llsm_frame_phaseshift
    applied chunk-wide).  Used to realign frames after retiming edits."""
    K = chunk.ampl.shape[-1]
    kharm = torch.arange(1, K + 1, dtype=FP, device=chunk.f0.device)
    cyc = _frac(torch.clamp(chunk.f0, min=0.0) * dt)
    ph = _frac(cyc[..., :, None] * kharm)
    phse = _wrap(chunk.phse + 2.0 * math.pi * ph)
    return chunk.replace(phse=phse * chunk.hm_mask)


def phase_sync(chunk: Chunk) -> Chunk:
    """Shift each frame's phases so the fundamental has phase 0
    (reference: frame.c -> llsm_frame_phasesync applied chunk-wide): the
    shift (k+1) phi_0 is taken in cycles mod 1 before it meets the trig."""
    K = chunk.ampl.shape[-1]
    kharm = torch.arange(1, K + 1, dtype=FP, device=chunk.phse.device)
    shift = _frac(chunk.phse[..., :, :1] / (2.0 * math.pi) * kharm)
    phse = _wrap(chunk.phse - 2.0 * math.pi * shift)
    return chunk.replace(phse=phse * chunk.hm_mask)
