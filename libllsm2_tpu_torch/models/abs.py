"""Analysis-by-synthesis refinement: gradient-optimize chunk parameters
through the differentiable synthesizer (counterpart of
libllsm2_tpu.models.abs).

Any parameter of the model can be fitted to a waveform target by
backpropagating through the oscillator bank: the classical
analysis-by-synthesis loop as a few lines of torch.optim.  Uses: squeeze
the last dB out of a difficult analysis (leakage, strong AM/FM) by
refining amplitudes/phases against the input; invert edited or decoded
parameters toward a reference recording; serve as the decoder half of
neural parameter estimators.

Only the deterministic harmonic part is fitted (the noise component is
keyed-PRNG stochastic).  The render is the plain oscillator bank and its
OLA (harmonics.oscillator_bank, differentiable), as the JAX package
calls it with use_pallas=False; the CUDA kernels have no backward.  The
cycle track is harmonics.sample_cycles (its kernel on the card).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import SynthesisOptions
from ..container import Chunk
from ..fp import FP
from ..ops import harmonics


def abs_refine(sopt: SynthesisOptions, chunk: Chunk, target,
               n_steps: int = 60, lr: float = 0.03
               ) -> Tuple[Chunk, torch.Tensor]:
    """Refine a chunk's (one utterance, no batch axis) harmonic
    amplitudes/phases by Adam on the waveform error of the HARMONIC
    resynthesis against `target`, on the chunk's device.

    Amplitudes are optimized in the log domain (positivity; relative
    steps), phases directly; masked slots stay zero.  Returns the
    refined chunk and the loss trace [n_steps], losses[i] the loss before
    step i's update (as the JAX package's lax.scan returns it).

    target: [nx] waveform at sopt.fs (nx = nfrm * nhop; longer targets
    are truncated, shorter zero-padded), numpy or a tensor.
    """
    conf = chunk.conf
    fs = sopt.fs
    nhop = int(round(conf.thop * fs))
    nx = chunk.nfrm * nhop
    dev = chunk.f0.device
    t = (target if torch.is_tensor(target)
         else torch.tensor(np.asarray(target))).to(dev, FP)[:nx]
    t = torch.nn.functional.pad(t, (0, nx - t.shape[0]))
    cyc = harmonics.sample_cycles(chunk.f0[None], nhop, fs, nx)
    mask = chunk.hm_mask[None]
    la = torch.log(torch.clamp(chunk.ampl, min=1e-6))[None].detach()
    ph = chunk.phse[None].detach().clone()
    la.requires_grad_(True)
    ph.requires_grad_(True)
    opt = torch.optim.Adam([la, ph], lr=lr)

    def render():
        segs = harmonics.oscillator_bank(cyc, torch.exp(la) * mask, ph, mask,
                                         nhop=nhop)
        return harmonics.overlap_add_half(segs, nhop, nx)[0]

    losses = []
    for _ in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((render() - t) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        refined = chunk.replace(ampl=(torch.exp(la) * mask)[0],
                                phse=(ph * mask)[0])
    return refined, torch.stack(losses)
