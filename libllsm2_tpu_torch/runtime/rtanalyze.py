"""Streaming (block) analysis of the PyTorch port: the analysis-side dual
of rtsynth (counterpart of libllsm2_tpu/runtime/rtanalyze.py; the
reference's llsm_analyze is offline only).

Every cross-frame operation of the offline analysis has a finite horizon
in frames (the pitch-synchronous windows, the deconvolution band, the F0
refine's smoothing, the denoiser's FIRs) but the noise-band envelopes,
whose brick-wall band filters have 1/t tails.  So a block of `block_hops`
frames analyzed with `halo_hops` frames of real context on both sides
reproduces the offline result for its central frames (the envelope tail
leaks ~1/(pi halo nhop) relative amplitude: -80 dB at the defaults).
Each block is one layer0._analyze call of a batch of one, of one shape
for the whole stream, with any option the offline analysis takes (the
card's kernels with use_pallas=True, the plain branches without).

Every phase the analysis emits is referenced at its own frame's centre
against that frame's own cycle count, so it does not depend on where the
block starts; no phase is carried across blocks.  The track denoiser,
when on, estimates its noise floors a block at a time (the one statistic
without a finite horizon), so its frames only approach the offline ones.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import AnalysisOptions
from ..container import CHUNK_FIELDS, Chunk, index_batch
from ..models import layer0


def concat_frames(chunks) -> Chunk:
    """Frame-axis concatenation of chunks without batch axes (no
    crossfade: for reassembling streamed blocks; for splicing units see
    models.edits.concat).  Layer-1 fields that are None stay None; extras
    are concatenated by name."""
    chunks = list(chunks)
    if not chunks:
        raise ValueError("no chunks to concatenate")
    first = chunks[0]
    if any(c.conf != first.conf for c in chunks):
        raise ValueError("chunks of different confs")

    def cat(get):
        parts = [get(c) for c in chunks]
        if all(p is None for p in parts):
            return None
        if any(p is None for p in parts):
            raise ValueError("a field is set in some chunks only")
        return torch.cat(parts)

    extras = None
    if first.extras is not None:
        extras = {k: cat(lambda c, k=k: (c.extras or {}).get(k))
                  for k in first.extras}
    return first.replace(**{f: cat(lambda c, f=f: getattr(c, f))
                            for f in CHUNK_FIELDS}, extras=extras)


class RTAnalyzer:
    """Streaming analyzer: feed (samples, F0 frames), get analyzed frames
    back with `2 halo_hops + block_hops` hops of latency.

    As in the reference's llsm_analyze, F0 is an input (ops.f0 tracks
    one).  Within one feed call, samples and F0 frames need not be
    aligned: both are buffered, and blocks run when enough of each is
    there.  Blocks run on `device`: the card ("cuda") unless the caller
    passes device="cpu" (without a card the default raises).

      rta = RTAnalyzer(create_aoptions())
      for samples, f0_frames in stream:
          chunk = rta.feed(samples, f0_frames)   # 0+ newly final frames
      tail = rta.flush()                         # the remaining frames
    """

    def __init__(self, opt: AnalysisOptions, block_hops: int = 64,
                 halo_hops: int = 48, device=None):
        layer0._check_analysis(opt)   # x at conf.fs: no resampling here
        self.opt = opt
        self.nhop = opt.conf.nhop
        self.block = int(block_hops)
        self.halo = int(halo_hops)
        if self.block < 1 or self.halo < 1:
            raise ValueError("block_hops and halo_hops must be >= 1")
        self.nfrm_blk = self.block + 2 * self.halo
        self.device = torch.device("cuda" if device is None else device)
        self._x = np.zeros(0, np.float32)       # samples from frame 0 on
        self._f0 = np.zeros(0, np.float32)
        self._emitted = 0                        # frames emitted so far

    def _have(self, n_frames: int) -> bool:
        return (len(self._f0) >= n_frames
                and len(self._x) >= n_frames * self.nhop)

    def _ready(self) -> bool:
        """Is the next block computable from the buffered input?  The first
        block is anchored at the stream start (its left edge is the stream
        edge, so the offline edge semantics hold) and emits block + halo
        frames; the next ones slide by `block`."""
        e = self._emitted
        if e == 0:
            return self._have(self.nfrm_blk)
        return self._have(e + self.block + self.halo)

    def _analyze(self, x: np.ndarray, f0: np.ndarray) -> Chunk:
        t = torch.from_numpy(np.concatenate([x, f0])).to(self.device)
        return index_batch(layer0._analyze(
            self.opt, t[None, :len(x)], t[None, len(x):]), 0)

    def _run(self, s0: int, ref_in: int, n_take: int) -> Chunk:
        """Analyze block frames [s0, s0 + nfrm_blk) and emit n_take frames
        from local index ref_in (= global frame self._emitted)."""
        lo_f = max(s0, 0)
        hi_f = s0 + self.nfrm_blk
        f0_blk = np.zeros(self.nfrm_blk, np.float32)
        avail_f = self._f0[lo_f:hi_f]
        f0_blk[lo_f - s0:lo_f - s0 + len(avail_f)] = avail_f
        x_blk = np.zeros(self.nfrm_blk * self.nhop, np.float32)
        lo_s = lo_f * self.nhop
        avail_x = self._x[lo_s:hi_f * self.nhop]
        o = lo_s - s0 * self.nhop
        x_blk[o:o + len(avail_x)] = avail_x
        chunk = self._analyze(x_blk, f0_blk)
        self._emitted += n_take
        return chunk.map(lambda a: a[ref_in:ref_in + n_take])

    def _next_block(self) -> Chunk:
        e = self._emitted
        if e == 0:
            return self._run(s0=0, ref_in=0, n_take=self.block + self.halo)
        return self._run(s0=e - self.halo, ref_in=self.halo,
                         n_take=self.block)

    def feed(self, samples=None, f0_frames=None) -> Chunk | None:
        """Buffer new input -> a chunk of the newly final frames, or None
        when no block completed."""
        if samples is not None:
            self._x = np.concatenate([self._x, np.asarray(samples,
                                                          np.float32)])
        if f0_frames is not None:
            self._f0 = np.concatenate([self._f0, np.asarray(f0_frames,
                                                            np.float32)])
        outs = []
        while self._ready():
            outs.append(self._next_block())
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else concat_frames(outs)

    def flush(self) -> Chunk | None:
        """End of stream: emit the remaining frames.  The final block is
        anchored at the stream end (its right edge is the stream edge);
        a stream shorter than one block is analyzed whole."""
        total = len(self._f0)
        e = self._emitted
        if e == 0 and total < self.nfrm_blk:
            if total == 0:
                return None
            x = np.zeros(total * self.nhop, np.float32)
            n = min(len(self._x), len(x))
            x[:n] = self._x[:n]
            self._emitted = total
            return self._analyze(x, self._f0)
        outs = []
        while total - self._emitted > self.block + self.halo:
            outs.append(self._next_block())
        if self._emitted < total:
            s0 = total - self.nfrm_blk
            outs.append(self._run(s0=s0, ref_in=self._emitted - s0,
                                  n_take=total - self._emitted))
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else concat_frames(outs)

