"""Chunk data model of the PyTorch port (counterpart of
libllsm2_tpu/container.py; reference: frame.c -> llsm_hmframe /
llsm_nmframe / llsm_chunk).

A chunk is one struct of tensors padded to conf.maxnhar (etc.) with an
explicit validity mask, so one utterance or a whole batch (leading batch
axes) is one set of rectangular tensors.  The layouts are the JAX
package's: ``[..., N, K]`` for harmonic fields, ``[..., N, C, Ke]`` for the
envelope harmonics.  ``chunk_from_numpy`` / ``chunk_to_numpy`` carry a
chunk across the two packages as numpy arrays.
"""
from __future__ import annotations

import dataclasses
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


def index_batch(chunk: Chunk, i) -> Chunk:
    """Every tensor field indexed by i on its leading axis: i = None adds a
    batch axis to a single-utterance chunk, i = 0 takes the first row."""
    return chunk.replace(**{f: getattr(chunk, f)[i] for f in CHUNK_FIELDS
                            if getattr(chunk, f) is not None})


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
