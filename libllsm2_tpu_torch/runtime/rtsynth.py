"""Streaming (real-time) synthesizer of the PyTorch port: the llsmrt
analog (counterpart of libllsm2_tpu/runtime/rtsynth.py; reference:
llsmrt.c -> llsm_create_rtsynth_buffer / _feed / _fetch / _delete).

A render step on the device (an oscillator bank and a WOLA noise shaper
over each frame's [2 nhop] segment, plain torch: the JAX package has no
Pallas kernel here) driven by a host loop that overlap-adds into the
native ring (runtime/native.py).  One frame of lookahead reproduces the
offline pipeline's linear F0 between frame centres, so the stream
converges to the offline render.  Host state is numpy, as in the JAX
package: the ring, the float64 cycle accumulators, the per-frame noise
from ``np.random.default_rng([seed, j])`` and the dc segments, so the
port keeps the JAX package's noise bits and F0 ramps exactly.

A render takes its FFTs in calls of `rows` rows (a frame render: the
synthesizer's feed_block; a pulse render: its pulse budget) and every
other sum in a fixed order of its own (`_tree_sum`, explicit channel
adds), so a frame or a pulse renders the same in a solo block as in a
StreamPool's batch: cuFFT and PyTorch's reductions choose their order by
the batch.  The ring takes each frame's pulses, then its segment, frame
by frame (the per-frame path's order), so a stream's output does not
depend on how its frames were grouped into renders.

Feed accepts frames as field dicts, 1-frame Chunks or whole Chunks;
fetch pops finalized samples.  Latency: 2 hops (one lookahead frame + one
OLA half-window).  Device work runs on `device`: the card ("cuda") unless
the caller passes device="cpu" (without a card the default raises).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import ChunkConf, SynthesisOptions
from ..container import LAYER0_FIELDS, Chunk
from ..fp import FP
from ..models import layer0
from ..models.layer1 import SPEED_OF_SOUND
from ..models.pbp import PULSE_GUARD
from ..ops import interp, lf, spectral, warp
from .native import OLARing


def _tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of x over `dim` by pairwise halves (zero-padded to a power of
    two): every element's sum in one fixed order of its own, whatever the
    tensor's other axes."""
    n = x.shape[dim]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        pad = list(x.shape)
        pad[dim] = p - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


@functools.lru_cache(maxsize=8)
def _frame_consts(conf: ChunkConf, device: str):
    """The render's constants: the OLA window w_ola [T] and its square root,
    the PSD positions of the rfft bins [nbin] and the channel masks [C,
    nbin] (float32, made on the CPU and moved to device)."""
    T = 2 * conf.nhop
    nbin = T // 2 + 1
    w_ola = torch.tensor(0.5 - 0.5 * np.cos(2.0 * np.pi * (np.arange(T) + 0.5)
                                            / T), dtype=FP)
    pos = warp.unwarp_interp_positions(nbin, conf.npsd, conf.fs, conf.noswarp)
    f = np.arange(nbin).astype(np.float32) * np.float32(conf.fs) \
        / np.float32(T)
    e = np.asarray(conf.chan_edges, np.float32)
    masks = torch.tensor(((f[None] >= e[:-1, None])
                          & (f[None] < e[1:, None])).astype(np.float32))
    return tuple(t.to(device) for t in (w_ola, torch.sqrt(w_ola), pos, masks))


def _render_frames(conf: ChunkConf, ampl, phse, mask, dc_seg, psd, edc,
                   eenv_a, eenv_p, noise_seg, voiced, *,
                   rows: int) -> torch.Tensor:
    """Render M frames' [2 nhop] OLA segments (harmonic + noise) -> [M, 2
    nhop], its FFTs in calls of `rows` rows (the module docstring).  ampl,
    phse, mask [M, K]; dc_seg, noise_seg [M, T] (cycles mod 1 of the
    fundamental and white noise over the frame's two hops); psd [M,
    npsd]; edc [M, C]; eenv_a/p [M, C, Ke]; voiced [M]."""
    T = 2 * conf.nhop
    dev = ampl.device
    w_ola, w, pos, masks = _frame_consts(conf, str(dev))
    v = voiced[:, None]

    kh = torch.arange(1, ampl.shape[-1] + 1, dtype=FP, device=dev)
    ph = kh[:, None] * dc_seg[:, None, :]                      # [M, K, T]
    ph = ph - torch.round(ph)
    osc = torch.cos(2.0 * math.pi * ph + phse[..., None])
    seg_h = _tree_sum(osc * (ampl * mask)[..., None], 1) * w_ola * v

    # noise: sqrt-Hann WOLA of the supplied white noise, shaped by the
    # unwarped PSD, split into the channels and modulated by each one's
    # envelope
    spec = layer0._row_groups(lambda a: torch.fft.rfft(a, n=T),
                              noise_seg * w, rows)             # [M, nbin]
    gain = torch.sqrt(torch.clamp(interp.interp1_uniform(psd, pos), min=0.0))
    bands = layer0._row_groups(
        lambda a: torch.fft.irfft(a, n=T),
        (spec * gain)[:, None, :] * masks, rows) * w           # [M, C, T]
    ke = torch.arange(1, eenv_a.shape[-1] + 1, dtype=FP, device=dev)
    phc = ke[:, None] * dc_seg[:, None, :]                     # [M, Ke, T]
    phc = phc - torch.round(phc)
    osc_e = torch.cos(2.0 * math.pi * phc[:, None]
                      + eenv_p[..., None])                     # [M, C, Ke, T]
    env = edc[..., None] + _tree_sum(osc_e * eenv_a[..., None], 2) \
        * v[..., None]
    # unit-RMS modulator: the PSD already carries the modulation's power,
    # so normalize by sqrt(edc^2 + sum a^2 / 2) (layer0._env_coefs)
    base = torch.sqrt(edc ** 2 + 0.5 * _tree_sum((eenv_a * v[..., None]) ** 2,
                                                 2))
    mod = torch.clamp(env, min=0.0) / torch.clamp(base, min=1e-8)[..., None]
    seg_n = torch.zeros_like(seg_h)
    for c in range(bands.shape[1]):
        seg_n = seg_n + bands[:, c] * mod[:, c]
    return seg_h + seg_n


def _render_pulses(conf: ChunkConf, vtm0, vtm1, wlerp, rd0, rd1, f00, f01,
                   frac, valid, os_: int = 4, *, rows: int) -> torch.Tensor:
    """Render P glottal pulses with per-pulse source / tract parameters
    (streaming PbP; reference: llsmrt.c PbP mode) -> [P, os_ nfft_spec].

    vtm0/vtm1 [P, nspec] are each pulse's bracketing frames' log tract
    magnitudes, rd0/rd1/f00/f01 [P] their source parameters; each frame's
    combined source x tract spectrum is built and the two are lerped with
    wlerp [P], as models.pbp lerps them, so the stream converges to the
    offline PbP render.  frac / valid [P]: fractional onset delay and
    validity.  os_ is sopt.pbp_oversample; each pulse lands PULSE_GUARD
    samples into its row (callers place rows at onset - PULSE_GUARD).  Its
    FFTs run in calls of `rows` rows, as _render_frames' do."""
    P = vtm0.shape[0]
    dev = vtm0.device
    nfft = os_ * conf.nfft_spec
    nspec = os_ * (conf.nspec - 1) + 1
    fs = conf.fs
    fbins = torch.linspace(0.0, fs / 2.0, nspec, dtype=FP, device=dev)
    group = lambda fn, t: layer0._row_groups(fn, t, rows)

    # both bracketing frames of every pulse in one pass: rows [0, P) are
    # the onset frames', [P, 2P) the next frames'
    vtm = torch.cat([vtm0, vtm1])
    f0c = torch.clamp(torch.cat([f00, f01]), min=1e-2)
    vt = torch.polar(torch.exp(spectral.upsample_linear(vtm, os_)),
                     spectral.upsample_linear(
                         group(spectral.minphase_phase, vtm), os_))
    params = lf.lf_from_rd(torch.cat([rd0, rd1]))
    src = lf.lf_spectrum(fbins / f0c[:, None],
                         params.map(lambda a: a[:, None]))
    src1 = lf.lf_spectrum(torch.ones_like(f0c), params)
    comb = vt * src / torch.clamp(torch.abs(src1), min=1e-12)[:, None]
    w = wlerp[:, None]
    spec_c = (1.0 - w) * comb[:P] + w * comb[P:]

    lip = torch.polar(2.0 * math.pi * torch.clamp(fbins, min=1e-3)
                      * conf.lip_radius / SPEED_OF_SOUND,
                      torch.full_like(fbins, math.pi / 2.0))
    period = 1.0 / torch.clamp((1.0 - wlerp) * f00 + wlerp * f01, min=1e-2)
    # the fractional delay plus the guard, in cycles mod 1 before the trig
    cyc = fbins / fs * (frac[:, None] + PULSE_GUARD)
    delay = torch.polar(torch.ones_like(cyc),
                        (-2.0 * math.pi) * (cyc - torch.round(cyc)))
    spec = (period[:, None] / 2.0 * fs) * spec_c * lip * delay
    return group(lambda a: torch.fft.irfft(a, n=nfft), spec) * valid[:, None]


def _stage(arrays, device) -> list:
    """numpy arrays -> float32 tensors on device, through one staging
    buffer and one host-to-device copy."""
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    buf = torch.from_numpy(flat).to(device)
    out, o = [], 0
    for a in arrays:
        n = int(np.size(a))
        out.append(buf[o:o + n].view(np.shape(a)))
        o += n
    return out


def _render_host(conf: ChunkConf, ins: dict, rows: int, device) -> np.ndarray:
    """_render_frames of host input arrays (RTSynthesizer._FIELDS) on
    device -> host segments: one copy each way."""
    segs = _render_frames(conf, *_stage([ins[k] for k in
                                         RTSynthesizer._FIELDS], device),
                          rows=rows)
    return segs.cpu().numpy()


def _pulses_host(conf: ChunkConf, args, os_: int, rows: int,
                 device) -> np.ndarray:
    """_render_pulses of host argument arrays on device -> host pulse rows:
    one copy each way."""
    return _render_pulses(conf, *_stage(args, device), int(os_),
                          rows=rows).cpu().numpy()


class RTSynthesizer:
    """Streaming synthesizer (reference: llsm_rtsynth_buffer).

    Args:
      sopt: synthesis options (the render reads noise_seed and
        pbp_oversample).
      conf: chunk conf.
      capacity_frames: ring capacity in frames.
      phase_mode: "absolute" (frames carry coherent phases, e.g. straight
        from analysis) or "propagate" (frames carry relative phases, e.g.
        from coder.decode_frames; the synthesizer accumulates the
        fundamental cycle count and re-propagates, reference:
        llsm_chunk_phasepropagate applied online).
      synth_mode: "harmonic" (oscillator bank) or "pbp" (glottal pulses
        from layer-1 frames; the frames' harmonics are not rendered).
      device: where the render runs ("cuda" unless given).
    """

    # frames a render step takes (the group size of its rows); StreamPool
    # sets it a pool
    feed_block = 16
    # input-array order of _render_frames (shared with rtserve)
    _FIELDS = ("ampl", "phse", "mask", "dc", "psd", "edc", "ea", "ep",
               "noise", "voiced")

    def __init__(self, sopt: SynthesisOptions, conf: ChunkConf,
                 capacity_frames: int = 64, phase_mode: str = "absolute",
                 synth_mode: str = "harmonic", device=None):
        if phase_mode not in ("absolute", "propagate"):
            raise ValueError(f"phase_mode={phase_mode!r}")
        if synth_mode not in ("harmonic", "pbp"):
            raise ValueError(f"synth_mode={synth_mode!r}")
        self.sopt = sopt
        self.conf = conf
        self.phase_mode = phase_mode
        self.synth_mode = synth_mode
        self.device = torch.device("cuda" if device is None else device)
        self.nhop = conf.nhop
        # PbP pulses land PULSE_GUARD samples before their onset (the
        # fractional delay's acausal tail), behind the last finalized
        # point when nhop <= PULSE_GUARD: PbP mode finalizes that much
        # later (output unchanged)
        self._adv_lag = PULSE_GUARD if synth_mode == "pbp" else 0
        self._capacity = capacity_frames * self.nhop
        self.reset()

    # -- helpers ---------------------------------------------------------
    def _noise_block(self, j: int) -> np.ndarray:
        if self._noise_memo is not None and self._noise_memo[0] == j:
            return self._noise_memo[1]
        rng = np.random.default_rng([int(self.sopt.noise_seed), max(j, 0)])
        b = rng.standard_normal(self.nhop).astype(np.float32)
        if j < 0:
            b = np.zeros_like(b)
        self._noise_memo = (j, b)   # frame i+1 re-reads block i
        return b

    @staticmethod
    def _dc_segments(nhop: int, fs: float, f0p, f0c, f0n) -> np.ndarray:
        """Cycle offsets over [-nhop, nhop) of M frames from the offline
        pipeline's piecewise-linear F0 (float64 on the host, mod 1 last).
        f0p/f0c/f0n are [M] float64; the one source of both the per-frame
        and the block paths (they must agree bit for bit)."""
        t = np.arange(-nhop, nhop, dtype=np.float64)[None, :]
        a = (t + nhop) / nhop
        f_back = f0p[:, None] + (f0c - f0p)[:, None] * a   # t in [-nhop, 0)
        f_fwd = f0c[:, None] + (f0n - f0c)[:, None] * (t / nhop)
        f_t = np.where(t < 0, f_back, f_fwd)               # [M, 2 nhop]
        dc = np.zeros_like(f_t)
        dc[:, nhop:] = (np.cumsum(f_t[:, nhop:], axis=1)
                        - f_t[:, nhop:]) / fs              # exclusive
        back = -np.cumsum(f_t[:, nhop - 1::-1], axis=1) / fs
        dc[:, :nhop] = back[:, ::-1]
        return (dc % 1.0).astype(np.float32)

    @staticmethod
    def chunk_frames_np(chunk: Chunk):
        """Split a chunk (no batch axis) into per-frame field dicts, with
        one device-to-host copy of all its fields."""
        names = list(LAYER0_FIELDS)
        if chunk.has_layer1:
            names += ["rd", "vtmagn"]
        N = chunk.nfrm
        ts = [getattr(chunk, f).reshape(N, -1).to(FP) for f in names]
        host = torch.cat(ts, dim=1).cpu().numpy()
        cols, o = {}, 0
        for f, t in zip(names, ts):
            n = t.shape[1]
            cols[f] = host[:, o:o + n].reshape((N,)
                                               + tuple(getattr(chunk, f)
                                                       .shape[1:]))
            o += n
        key = dict(hm_mask="mask")
        out = []
        for i in range(N):
            d = {key.get(f, f): cols[f][i] for f in names}
            d["f0"] = float(cols["f0"][i])
            if "rd" in d:
                d["rd"] = float(cols["rd"][i])
            out.append(d)
        return out

    def _frame_fields(self, frame):
        if isinstance(frame, Chunk):
            return self.chunk_frames_np(frame)[0]
        return dict(frame)

    def _queue(self, frames):
        if isinstance(frames, Chunk):
            return self.chunk_frames_np(frames)
        if isinstance(frames, dict):
            return [dict(frames)]
        return [self._frame_fields(f) for f in frames]

    def _pulse_params(self, cur, nxt, f0c, oi, fr):
        """Per-pulse bracketing-frame parameters (as models.pbp: lerp the
        combined spectra toward the next frame when both are voiced, else
        hold the onset frame's) -> (vt0, vt1, wlerp, rd0, rd1, f00, f01)."""
        w = (oi + fr) / self.nhop
        use_next = (nxt is not None and nxt.get("f0", 0.0) > 0
                    and "vtmagn" in nxt)
        rd0 = float(cur.get("rd", 1.0))
        if not use_next:
            return (cur["vtmagn"], cur["vtmagn"], 0.0, rd0, rd0, f0c, f0c)
        return (cur["vtmagn"], nxt["vtmagn"], w,
                rd0, float(nxt.get("rd", 1.0)), f0c, float(nxt["f0"]))

    # -- public API (reference: llsm_rtsynth_buffer_feed / _fetch) --------
    def reset(self) -> None:
        """Drop all buffered state (a new utterance on the same
        synthesizer)."""
        self.ring = OLARing(self._capacity)
        self._pending = None      # one-frame lookahead
        self._prev_f0 = 0.0
        self._i = 0               # index of the next frame to render
        self._cycles = 0.0        # fundamental cycles at the centre (f64)
        self._pulse_cycles = 0.0  # cycle phase for PbP onset placement
        self._fed = 0
        self._noise_memo = None
        self.dispatches = 0       # device render calls (observability)

    def feed(self, frame) -> None:
        """Feed one frame (a field dict or a 1-frame Chunk); the frame
        before it renders now."""
        cur = self._frame_fields(frame)
        if self._pending is not None:
            self._render_group([self._pending, cur], self._prev_f0)
            self._prev_f0 = self._pending["f0"]
        self._pending = cur
        self._fed += 1

    def feed_many(self, frames) -> None:
        """Feed a sequence of frames (or a multi-frame Chunk), rendering
        feed_block hops a render step instead of one: the same frames,
        noise keys and lookahead as feed(), in ~1 render a feed_block
        frames (+1 in PbP mode) instead of one a frame."""
        queue = self._queue(frames)
        self._fed += len(queue)
        if self._pending is not None:
            queue.insert(0, self._pending)
        if len(queue) < 2:
            self._pending = queue[-1] if queue else self._pending
            return
        self._render_block(queue)
        self._prev_f0 = queue[-2]["f0"]
        self._pending = queue[-1]

    def _assemble_group(self, grp, f0_prev):
        """Inputs of one render group.

        grp: M + 1 frame dicts -- grp[:-1] render, grp[-1] is the lookahead
        (the linear-F0 target).  Arrays are zero-padded to feed_block rows.
        Advances the phase-propagation cycle accumulator by M hops (the
        ring and _i are not touched: _commit_group).  Returns (inputs dict,
        M, pulse_jobs); a pulse job is (abs_frame, onset, frac, vt0, vt1,
        wlerp, rd0, rd1, f00, f01).  The dc / noise / phase blocks compute
        the per-frame path's float64 operations in its order, so their
        inputs equal the per-frame path's bit for bit."""
        conf = self.conf
        nhop = self.nhop
        MB = self.feed_block
        K = conf.maxnhar
        M = len(grp) - 1
        assert 1 <= M <= MB
        # raw and voicing-substituted f0 sequences
        f0_raw = np.array([g["f0"] for g in grp], np.float64)  # [M+1]
        f0c = np.where(f0_raw[:M] > 0, f0_raw[:M], 0.0)        # [M]
        prev_raw = np.concatenate(([f0_prev], f0_raw[:M - 1]))
        f0p = np.where(prev_raw > 0, prev_raw, f0c)
        f0n = np.where(f0_raw[1:M + 1] > 0, f0_raw[1:M + 1], f0c)

        C, Ke = conf.nchannel, conf.maxnhar_e
        ins = dict(
            ampl=np.zeros((MB, K), np.float32),
            phse=np.zeros((MB, K), np.float32),
            mask=np.zeros((MB, K), np.float32),
            dc=np.zeros((MB, 2 * nhop), np.float32),
            psd=np.zeros((MB, conf.npsd), np.float32),
            edc=np.zeros((MB, C), np.float32),
            ea=np.zeros((MB, C, Ke), np.float32),
            ep=np.zeros((MB, C, Ke), np.float32),
            noise=np.zeros((MB, 2 * nhop), np.float32),
            voiced=np.zeros((MB,), np.float32))
        if self.synth_mode != "pbp":
            ins["ampl"][:M] = np.stack([g["ampl"] for g in grp[:M]])
        for k, f in (("mask", "mask"), ("psd", "psd"), ("edc", "edc"),
                     ("ea", "eenv_a"), ("ep", "eenv_p")):
            ins[k][:M] = np.stack([g[f] for g in grp[:M]])
        ins["voiced"][:M] = (f0c > 0).astype(np.float32)
        ins["dc"][:M] = self._dc_segments(nhop, conf.fs, f0p, f0c, f0n)

        # noise: rows are sliding pairs of consecutive per-frame blocks
        i0 = self._i
        blocks = np.empty((M + 1, nhop), np.float32)
        for bj, j in enumerate(range(i0 - 1, i0 + M)):
            blocks[bj] = self._noise_block(j)
        ins["noise"][:M] = np.lib.stride_tricks.sliding_window_view(
            blocks.reshape(-1), 2 * nhop)[::nhop][:M]

        # phases (+ the propagate mode's cycle ramp); the accumulator is
        # sequential but scalar
        cyc = np.empty((M,), np.float64)
        c = self._cycles
        for j in range(M):
            cyc[j] = c
            c = (c + 0.5 * (f0c[j] + f0n[j]) * conf.thop) % 1.0
        self._cycles = c
        # cast before adding the float64 ramp, as the per-frame path does
        phse = np.stack([g["phse"] for g in grp[:M]]).astype(np.float32,
                                                             copy=False)
        if self.phase_mode == "propagate":
            kh = np.arange(1, K + 1)
            ramp = (2.0 * np.pi) * ((kh[None, :] * cyc[:, None]) % 1.0)
            ins["phse"][:M] = np.where((f0c > 0)[:, None], phse + ramp, phse)
        else:
            ins["phse"][:M] = phse

        pulse_jobs = []
        if self.synth_mode == "pbp":
            for j in range(M):
                cur = grp[j]
                if f0c[j] > 0 and "vtmagn" in cur:
                    f0cj = float(f0c[j])
                    for oi, fr in self._pulse_onsets(f0cj):
                        pulse_jobs.append((i0 + j, oi, fr, *self._pulse_params(
                            cur, grp[j + 1], f0cj, oi, fr)))
        return ins, M, pulse_jobs

    @staticmethod
    def _pack_pulse_jobs(conf: ChunkConf, pulse_jobs, budget: int):
        """Pulse jobs padded to `budget` rows -> _render_pulses' argument
        arrays (numpy)."""
        P = len(pulse_jobs)
        if P > budget:
            raise ValueError(f"{P} pulses exceed the budget of {budget}")
        vt0 = np.zeros((budget, conf.nspec), np.float32)
        vt1 = np.zeros((budget, conf.nspec), np.float32)
        wl = np.zeros((budget,), np.float32)
        rdv0 = np.ones((budget,), np.float32)
        rdv1 = np.ones((budget,), np.float32)
        f0v0 = np.full((budget,), 100.0, np.float32)
        f0v1 = np.full((budget,), 100.0, np.float32)
        frv = np.zeros((budget,), np.float32)
        val = np.zeros((budget,), np.float32)
        if P:
            vt0[:P] = np.stack([pj[3] for pj in pulse_jobs])
            vt1[:P] = np.stack([pj[4] for pj in pulse_jobs])
            wl[:P] = [pj[5] for pj in pulse_jobs]
            rdv0[:P] = [pj[6] for pj in pulse_jobs]
            rdv1[:P] = [pj[7] for pj in pulse_jobs]
            f0v0[:P] = [pj[8] for pj in pulse_jobs]
            f0v1[:P] = [pj[9] for pj in pulse_jobs]
            frv[:P] = [pj[2] for pj in pulse_jobs]
            val[:P] = 1.0
        return vt0, vt1, wl, rdv0, rdv1, f0v0, f0v1, frv, val

    def _add_pulse(self, pulse, onset_pos: int) -> None:
        """OLA one rendered pulse row into the ring: the row starts
        PULSE_GUARD samples before the onset; its head is clipped where
        that reaches before the stream start."""
        pos = onset_pos - PULSE_GUARD
        if pos < 0:
            pulse = pulse[-pos:]
            pos = 0
        self.ring.add(pulse, pos)

    def _commit_group(self, segs, M: int, pulses, pulse_jobs) -> None:
        """OLA M rendered segments and the group's pulse rows into the
        ring, frame by frame, and finalize the readable samples."""
        nhop = self.nhop
        p = 0
        for j in range(M):
            # this frame's pulses, then its segment, as the per-frame path
            while p < len(pulse_jobs) and pulse_jobs[p][0] == self._i:
                self._add_pulse(pulses[p], self._i * nhop + pulse_jobs[p][1])
                p += 1
            pos = self._i * nhop - nhop
            seg = segs[j]
            if pos < 0:
                seg = seg[-pos:]
                pos = 0
            self.ring.add(seg, pos)
            self._i += 1
        # finalize up to the last rendered frame's centre (its trailing
        # half-window still takes the next frame's overlap); PbP holds back
        # PULSE_GUARD more for the next group's guard heads
        self.ring.advance(max(0, (self._i - 1) * nhop - self._adv_lag))

    def _render_group(self, grp, f0_prev) -> None:
        """Render grp[:-1] (grp[-1] is the lookahead) in one render step
        (and one pulse render in PbP mode) and commit it to the ring."""
        ins, M, pulse_jobs = self._assemble_group(grp, f0_prev)
        segs = _render_host(self.conf, ins, self.feed_block, self.device)
        self.dispatches += 1
        pulses = None
        if pulse_jobs:
            budget = self._pulse_budget()
            args = self._pack_pulse_jobs(self.conf, pulse_jobs, budget)
            pulses = _pulses_host(self.conf, args, self.sopt.pbp_oversample,
                                  budget, self.device)
            self.dispatches += 1
        self._commit_group(segs, M, pulses, pulse_jobs)

    def _render_block(self, queue) -> None:
        """Render queue[:-1] (queue[-1] is the lookahead) in groups of
        feed_block frames."""
        MB = self.feed_block
        m = len(queue) - 1
        for s in range(0, m, MB):
            self._render_group(queue[s:min(s + MB, m) + 1],
                               self._prev_f0 if s == 0 else queue[s - 1]["f0"])

    def _pulse_budget(self) -> int:
        """Pulse capacity of a render group: f0_ceil cycles over
        feed_block hops, plus slack."""
        return int(self.conf.f0_ceil * self.feed_block * self.nhop
                   / self.conf.fs) + 2

    def _pulse_onsets(self, f0c: float):
        """Advance the pulse-cycle accumulator over one hop -> the (integer
        offset, fractional delay) of each onset in the hop."""
        fs = self.conf.fs
        c0 = self._pulse_cycles
        hop_cycles = f0c * self.nhop / fs
        out = []
        n_cross = int(np.floor(c0 + hop_cycles) - np.floor(c0))
        for p in range(n_cross):
            o = (np.ceil(c0) + p - c0) / f0c * fs
            out.append((int(np.floor(o)), float(o - np.floor(o))))
        self._pulse_cycles = (c0 + hop_cycles) % 1.0
        return out

    def flush(self) -> None:
        """Render the last pending frame (constant-F0 extrapolation: an
        unvoiced lookahead holds its F0 and, in PbP, its spectra)."""
        if self._pending is not None:
            self._render_group([self._pending, dict(self._pending, f0=0.0)],
                               self._prev_f0)
            self.ring.advance(self._i * self.nhop)
            self._prev_f0 = self._pending["f0"]
            self._pending = None

    def readable(self) -> int:
        return self.ring.readable()

    def fetch(self, n: int) -> np.ndarray:
        return self.ring.read(n)


def stream_chunk(sopt: SynthesisOptions, chunk: Chunk, block: int = 0,
                 device=None, **kw) -> np.ndarray:
    """Push a whole chunk (no batch axis) through the streaming path and
    collect the output: block > 0 feeds `block` frames a feed_many call,
    block == 0 frame by frame.  Renders on the chunk's device unless
    `device` is given; kw go to RTSynthesizer."""
    rt = RTSynthesizer(sopt, chunk.conf, capacity_frames=chunk.nfrm + 8,
                       device=chunk.f0.device if device is None else device,
                       **kw)
    frames = RTSynthesizer.chunk_frames_np(chunk)
    out = []
    step = block if block > 0 else 1
    for s in range(0, len(frames), step):
        if block > 0:
            rt.feed_many(frames[s:s + block])
        else:
            rt.feed(frames[s])
        got = rt.fetch(rt.readable())
        if len(got):
            out.append(got)
    rt.flush()
    got = rt.fetch(rt.readable())
    if len(got):
        out.append(got)
    return np.concatenate(out) if out else np.zeros(0, np.float32)
