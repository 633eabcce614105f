"""Observability: named scopes and profiler hooks (counterpart of
libllsm2_tpu.utils.profiling).

named_scope marks a stage for torch.profiler (record_function, entered
only while a profiler records) and, on the card, for NVTX (Nsight
timelines); device_trace captures a torch.profiler trace -- host ops,
and the card's kernels when CUDA is in use -- and writes it as a Chrome
trace (chrome://tracing, Perfetto).

The scopes layer0 opens, children inside their parents:

    llsm.analyze.refine             the F0 refine and its smoothing
    llsm.cycles                     the cycle track (analysis, synthesis)
    llsm.analyze.harmonic           the harmonic projection
    llsm.analyze.residual           deconvolution, denoiser, render
      .deconv                       the amplitude-track deconvolution
      .stats                        the denoiser's first pass
      .floor                        its per-utterance floor statistics
      .apply                        its second pass and its finish
      .gate                         the spectral gate
        .gate.dft                   the gate's transforms
      .render                       the residual's oscillator bank
    llsm.analyze.noise              noise analysis
      .envelopes                    the band envelopes
      .project                      their harmonic projection
      .psd                          the warped periodogram
    llsm.synth.harmonic             the oscillator bank
    llsm.synth.noise                the noise render
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def named_scope(name: str):
    """A named range around a stage: a torch.profiler record_function while
    a profiler records (none otherwise: it costs host time a span even
    with no profiler) and, while CUDA is initialized, an NVTX range."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        if _autograd_profiler._is_profiler_enabled:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace around a region and write it to
    logdir/trace.json (Chrome trace format), the card's kernels included
    when CUDA is initialized.  Yields the profiler (key_averages(),
    events())."""
    cuda = torch.cuda.is_initialized()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
