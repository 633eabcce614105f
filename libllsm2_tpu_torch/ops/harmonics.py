"""Harmonic analysis and additive synthesis (counterpart of
libllsm2_tpu/ops/harmonics.py; reference: dsputils.c CZT and peak-picking
paths, layer0.c frame loop and sinusoidal synthesis).

Every function takes a leading batch axis ``[B, ...]`` where the JAX
package maps one utterance under ``jax.vmap``.  With ``use_pallas=True``
(the default here) the projections and renders run the hand-written
kernels of ops/kernels.py, as the JAX package's Pallas branches do; with
``use_pallas=False`` they run the JAX package's jnp branches in plain
PyTorch, on the tensors' device.  The plain branches compute each row
alone, in chunks of a fixed number of frames, so a row's result does not
depend on its batch (the CUDA libraries choose their order of sums by a
call's shape) and their [frames, K, W] temporaries stay bounded.  Phase
arguments are reduced to cycles mod 1 before trig.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..fp import FP, FP64
from . import kernels
from .windows import COSINE_SERIES, window_centered


# elements of a [frames, K, W] basis chunk of the plain projections and
# renders: bounds each temporary to 128 MB at any input size
_PLAIN_ELEMS = 1 << 25


def each_row(fn, *ts):
    """fn on each row of the tensors ts (their leading axis) as a batch of
    one, the outputs (a tensor or a tuple of them) concatenated over the
    rows: every row is computed alone, in calls of the same shapes
    whatever the batch."""
    outs = [fn(*(t[b:b + 1] for t in ts)) for b in range(ts[0].shape[0])]
    if torch.is_tensor(outs[0]):
        return torch.cat(outs)
    return tuple(torch.cat(v) for v in zip(*outs))


def frame_chunks(fn, step: int, *ts):
    """fn over chunks of `step` frames of the tensors ts (axis 0 the
    frames), the outputs (a tensor or a tuple) concatenated."""
    outs = [fn(*(t[s:s + step] for t in ts))
            for s in range(0, ts[0].shape[0], step)]
    if torch.is_tensor(outs[0]):
        return torch.cat(outs)
    return tuple(torch.cat(v) for v in zip(*outs))


def _phase_cycles(kn: torch.Tensor, f_over_fs: torch.Tensor) -> torch.Tensor:
    """(k*n) * f/fs reduced to [-0.5, 0.5] cycles."""
    ph = kn * f_over_fs
    return ph - torch.round(ph)


def sample_cycles(f0: torch.Tensor, nhop: int, fs: float, nx: int,
                  base: torch.Tensor | None = None,
                  start: int = 0) -> torch.Tensor:
    """Fundamental phase in cycles MOD 1 at every sample: f0 [B, N] ->
    [B, nx], nx a multiple of nhop: F0 lerped between frame centers
    (i*nhop), summed in float32 within each hop and in float64 over the
    hop totals (kernels.sample_cycles_ref).  On the card a kernel sums each
    row in an order of its own, so a row's track is the same alone and in
    any batch (kernels.sample_cycles).  Under LLSM_FP64=1 the plain version
    sums in float64 on every device, as the JAX package's jnp does.  base
    and start: a frame shard's block of a longer track
    (kernels.sample_cycles_ref)."""
    if FP64:
        return kernels.sample_cycles_ref(f0, nhop, fs, nx, base, start)
    return kernels.sample_cycles(f0, nhop, fs, nx, base, start)


def frame_hops(x: torch.Tensor, nfrm: int, nhop: int, halfhops: int,
               mode: str = "constant") -> torch.Tensor:
    """Sliding frames [..., nfrm, 2*halfhops*nhop] at centers i*nhop of
    x [..., nfrm*nhop]; row i covers samples [(i - halfhops)*nhop,
    (i + halfhops)*nhop), zero- ("constant") or edge-padded ("edge")."""
    p = halfhops * nhop
    if mode == "edge":
        xp = torch.cat([x[..., :1].expand(x.shape[:-1] + (p,)), x,
                        x[..., -1:].expand(x.shape[:-1] + (p,))], dim=-1)
    else:
        xp = F.pad(x, (p, p))
    return xp.unfold(-1, 2 * p, nhop)[..., :nfrm, :]


def win_frames(x: torch.Tensor, cyc: torch.Tensor, nfrm: int, nhop: int,
               center: int):
    """The analysis frames at centers i*nhop as buffers: x [Bx, nx], cyc
    [Bc, nx] (x row b takes cyc row b // (Bx // Bc)) -> (frames, dc)
    [Bx nfrm, 2 center], x zero-padded and cyc edge-padded, dc the cycle
    offset from each frame's center sample."""
    Bx = x.shape[0]
    hh = center // nhop
    if hh * nhop != center:
        raise ValueError("win_frames: center must be a multiple of nhop")
    cyc = torch.repeat_interleave(cyc, Bx // cyc.shape[0], dim=0)
    frames = frame_hops(x.to(FP), nfrm, nhop, hh).reshape(Bx * nfrm, -1)
    dc = (frame_hops(cyc, nfrm, nhop, hh, mode="edge")
          - cyc[..., ::nhop][..., :nfrm, None]).reshape(Bx * nfrm, -1)
    return frames, dc


def cycle_segments(cyc: torch.Tensor, centers: torch.Tensor,
                   halfwin: int) -> torch.Tensor:
    """Per-frame cycle offsets cyc[c+n] - cyc[c] for n in [-halfwin,
    halfwin]: cyc [..., nx], centers [N] -> [..., N, 2*halfwin+1].  Edge
    frames use edge-replicated phase."""
    W = 2 * halfwin + 1
    cp = torch.cat([cyc[..., :1].expand(cyc.shape[:-1] + (halfwin,)), cyc,
                    cyc[..., -1:].expand(cyc.shape[:-1] + (halfwin + 1,))],
                   dim=-1)
    idx = centers[:, None] + torch.arange(W, device=cyc.device)[None, :]
    return cp[..., idx] - cyc[..., centers][..., None]


def harmonic_analysis(x, f0, cyc, *, nhop: int, fs: float, max_k: int,
                      halfwin_max: int, rel_winsize: float, fnyq: float,
                      window: str = "hanning", with_dc: bool = False,
                      mxu: bool = False, use_pallas: bool = True,
                      frame_chunk: int = 0, centers=None):
    """Harmonic amplitudes/phases of every frame by the chirped
    pitch-synchronous projection (harmonics.py:101-321 of the JAX
    package).

    x [B, nx], cyc [Bc, nx] (Bc divides B: row b of x takes cyc row
    b // (B // Bc), as the envelope pass's channels share their
    utterance's track); f0 [B, N] (0 = unvoiced) -> ampl, phse, mask
    [B, N, max_k] (phase at the frame center), plus the windowed DC
    [B, N] with with_dc (every frame, unvoiced ones with the f0 = 100 Hz
    placeholder window).  Frames are centred at i*nhop, or at the integer
    samples `centers` [N] when given.

    use_pallas: a cosine-series window at uniform centres runs the fused
    kernel, which frames x and cyc itself, or with mxu=True the unframed
    projection; at `centers`, or with any other window (mltsine), frames
    are gathered and windowed here and go through the plain projection
    kernel.  frame_chunk > 0 (uniform centres, not mxu) projects
    frame_chunk frames a call and makes each chunk's amplitudes and phases
    before the next, so no full-size projection temporaries exist at
    once; the result equals the unchunked call's.  use_pallas=False: the
    JAX package's jnp projection (per_chunk) on gathered 2 halfwin_max + 1
    sample frames."""
    B, N = f0.shape
    H = halfwin_max
    dev = x.device
    kharm = torch.arange(1, max_k + 1, dtype=FP, device=dev)
    voiced = f0 > 0.0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    halfwidth = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0, float(H))
    mask = (voiced[..., None] & (kharm * f0s[..., None] < fnyq)).to(FP)
    if not use_pallas:
        ampl, phse, dcv = _plain_analysis(x, cyc, halfwidth, nhop=nhop,
                                          H=H, max_k=max_k, window=window,
                                          centers=centers)
        if with_dc:
            return ampl * mask, phse * mask, mask, dcv
        return ampl * mask, phse * mask, mask
    # unvoiced outputs are masked, so their window shrinks to the minimum
    # unless the caller wants the (unmaskable) DC
    halfwidth_e = halfwidth if with_dc else torch.where(
        voiced, halfwidth, torch.full_like(halfwidth, 2.0))
    # live slots: ceil(fnyq/f0) >= the mask's slot count under rounding
    kl = torch.clamp(torch.where(voiced, torch.ceil(fnyq / f0s),
                                 torch.zeros_like(f0s)), 0, max_k)
    hh = -(-H // nhop)           # window halfwidth in whole hops

    def finish(re, im, wsum, xsum):
        wsum = torch.clamp(wsum, min=1e-9)
        return (2.0 * torch.sqrt(re ** 2 + im ** 2) / wsum[..., None],
                torch.atan2(im, re), xsum / wsum)

    if centers is not None:
        ampl, phse, dcv = finish(*_gather_project(
            x, cyc, halfwidth_e, torch.as_tensor(centers, device=dev), H=H,
            max_k=max_k, window=window))
    elif mxu and window in COSINE_SERIES:
        if cyc.shape[0] != B:
            cyc = torch.repeat_interleave(cyc, B // cyc.shape[0], dim=0)
        ampl, phse, dcv = finish(*kernels.harmonic_project_mxu(
            x, cyc, halfwidth_e, max_k, nhop, hh, window=window))
    elif frame_chunk > 0:
        ampl, phse, dcv = _chunked_project(finish, x, cyc, halfwidth_e, kl,
                                           frame_chunk, nhop=nhop, hh=hh,
                                           max_k=max_k, window=window)
    else:
        ampl, phse, dcv = finish(*_project(x, cyc, halfwidth_e, kl, nhop=nhop,
                                           C=hh * nhop, max_k=max_k,
                                           window=window))
    if with_dc:
        return ampl * mask, phse * mask, mask, dcv
    return ampl * mask, phse * mask, mask


def _project(x, cyc, hw, kl, *, nhop: int, C: int, max_k: int,
             window: str):
    """The kernels' projection of frames at centers i*nhop (frames
    [-C, C) around each): x [Bx, nx], cyc [Bc, nx], hw and kl [Bx, N] ->
    (re, im [Bx, N, K], wsum, xsum [Bx, N]); a cosine-series window by the
    fused kernel, any other on frame buffers through harmonic_project."""
    Bx, N = hw.shape
    hw_int = torch.ceil(hw).to(torch.int32)
    lo, hi = C - hw_int, C + hw_int + 1
    if window in COSINE_SERIES:
        return kernels.harmonic_project_win(
            x, cyc, hw, max_k, lo, hi, nhop=nhop, center=C, window=window,
            kl=kl.to(torch.int32))
    frames, dcf = win_frames(x, cyc, N, nhop, C)
    noff = torch.arange(2 * C, dtype=FP, device=x.device) - C
    w = window_centered(window, noff, hw.reshape(-1, 1))
    xw = frames * w
    re, im = kernels.harmonic_project(dcf, xw, max_k, lo.reshape(-1),
                                      hi.reshape(-1))
    return (re.reshape(Bx, N, max_k), im.reshape(Bx, N, max_k),
            w.sum(dim=-1).reshape(Bx, N), xw.sum(dim=-1).reshape(Bx, N))


def _chunked_project(finish, x, cyc, hw, kl, FC: int, *, nhop: int, hh: int,
                     max_k: int, window: str):
    """_project + finish over chunks of FC frames (harmonics.py:257-290):
    chunk [c0, c0 + nf) projects x and cyc cut to its frames and hh hops
    of real context each side (zero / edge-padded past the signal), the
    context frames idle (halfwidth 2, no live column, no slot), and its
    (ampl, phse, dc) go straight into the outputs."""
    Bx, N = hw.shape
    Bc, nx = cyc.shape
    C = hh * nhop
    dev = x.device
    ampl = torch.empty((Bx, N, max_k), dtype=FP, device=dev)
    phse = torch.empty_like(ampl)
    dcv = torch.empty((Bx, N), dtype=FP, device=dev)
    idle = lambda t, v: torch.full((t.shape[0], hh), v, dtype=t.dtype,
                                   device=dev)
    for c0 in range(0, N, FC):
        nf = min(FC, N - c0)
        s0, s1 = c0 * nhop - C, (c0 + nf) * nhop + C
        lo, hi = max(s0, 0), min(s1, nx)
        xs = F.pad(x[:, lo:hi], (lo - s0, s1 - hi))
        cs = torch.cat([cyc[:, :1].expand(Bc, lo - s0), cyc[:, lo:hi],
                        cyc[:, -1:].expand(Bc, s1 - hi)], dim=-1)
        pad = lambda t, v: torch.cat([idle(t, v), t[:, c0:c0 + nf],
                                      idle(t, v)], dim=1)
        out = finish(*_project(xs, cs, pad(hw, 2.0), pad(kl, 0.0),
                               nhop=nhop, C=C, max_k=max_k, window=window))
        ampl[:, c0:c0 + nf], phse[:, c0:c0 + nf], dcv[:, c0:c0 + nf] = (
            v[:, hh:hh + nf] for v in out)
    return ampl, phse, dcv


def _gather_project(x, cyc, hw, centers, *, H: int, max_k: int,
                    window: str):
    """Gather framing at the integer samples `centers` [N]
    (harmonics.py:299-305): frames of W = 2H + 1 samples, x zero- and cyc
    edge-padded, windowed here and projected by the plain projection
    kernel (the pre-windowed counterpart of harmonic_project_pallas) ->
    (re, im [Bx, N, K], wsum, xsum [Bx, N])."""
    Bx, N = hw.shape
    W = 2 * H + 1
    dev = x.device
    idx = centers[:, None] + torch.arange(W, device=dev)
    frames = F.pad(x.to(FP), (H, H + 1))[:, idx]           # [Bx, N, W]
    dcf = cycle_segments(cyc, centers, H)                  # [Bc, N, W]
    dcf = torch.repeat_interleave(dcf, Bx // cyc.shape[0], dim=0)
    noff = torch.arange(W, dtype=FP, device=dev) - H
    w = window_centered(window, noff, hw[..., None])
    xw = frames * w
    hw_int = torch.ceil(hw).to(torch.int32)
    re, im = kernels.harmonic_project(
        dcf.reshape(Bx * N, W), xw.reshape(Bx * N, W), max_k,
        (H - hw_int).reshape(-1), (H + hw_int + 1).reshape(-1))
    return (re.reshape(Bx, N, max_k), im.reshape(Bx, N, max_k),
            w.sum(dim=-1), xw.sum(dim=-1))


def _plain_analysis(x, cyc, halfwidth, *, nhop: int, H: int, max_k: int,
                    window: str, centers=None):
    """The JAX package's jnp projection (harmonics.py:171-189 and
    :306-317): frames of W = 2H + 1 samples around each centre (i*nhop, or
    `centers`), x zero- and cyc edge-padded, the window of each frame's
    halfwidth, the chirped basis as [frames, K, W] cos / sin and two
    contractions.  x [Bx, nx], cyc [Bc, nx], halfwidth [Bx, N] -> (ampl,
    phse [Bx, N, K], the windowed DC [Bx, N]), before the mask; each row
    alone, in chunks of frames."""
    Bx, N = halfwidth.shape
    W = 2 * H + 1
    dev = x.device
    rep = Bx // cyc.shape[0]
    kharm = torch.arange(1, max_k + 1, dtype=FP, device=dev)
    n_off = torch.arange(W, dtype=FP, device=dev) - H
    step = max(_PLAIN_ELEMS // (max_k * W), 1)
    if centers is not None:
        centers = torch.as_tensor(centers, device=dev)

    def per_chunk(frames, dc, hw):
        w = window_centered(window, n_off, hw[:, None])        # [F, W]
        xw = frames * w
        arg = 2.0 * math.pi * _phase_cycles(kharm[:, None], dc[:, None, :])
        re = torch.einsum("fkw,fw->fk", torch.cos(arg), xw)
        im = torch.einsum("fkw,fw->fk", -torch.sin(arg), xw)
        wsum = torch.clamp(w.sum(dim=-1), min=1e-9)
        return (2.0 * torch.sqrt(re ** 2 + im ** 2) / wsum[:, None],
                torch.atan2(im, re), xw.sum(dim=-1) / wsum)

    def row(b):
        xp = F.pad(x[b].to(FP), (H, H + 1))
        c = cyc[b // rep]
        cp = torch.cat([c[:1].expand(H), c, c[-1:].expand(H + 1)])
        if centers is None:
            frames = xp.unfold(0, W, nhop)[:N]
            dc = cp.unfold(0, W, nhop)[:N] - c[::nhop][:N, None]
        else:
            idx = centers[:, None] + torch.arange(W, device=dev)
            frames = xp[idx]
            dc = cp[idx] - c[centers][:, None]
        return frame_chunks(per_chunk, step, frames, dc, halfwidth[b])

    outs = [row(b) for b in range(Bx)]
    return tuple(torch.stack(v) for v in zip(*outs))


def refine_f0(x, f0, *, nhop: int, fs: float, halfwin_max: int,
              rel_winsize: float, window: str = "hanning", iters: int = 2,
              max_rel_dev: float = 0.05, f0_ceil: float = 600.0,
              use_pallas: bool = True, bounds=None):
    """Refine F0 by the fundamental's phase slope.  use_pallas (the JAX
    package's Pallas branches): on a lowpass-decimated signal where some
    D in 8/4/2 divides the hop and clears f0_ceil (harmonics.py:372-492),
    else at the full rate through the projection kernel
    (harmonics.py:494-543).  use_pallas=False: the full-rate jnp probes
    (harmonics.py:515-543), whatever the hop.  x [B, nx], f0 [B, N] ->
    [B, N].

    On the CPU each row is refined by a call of its own, so a row gives
    the same bits alone and in any batch: PyTorch's CPU library takes the
    FIR's batched product of strided rows by another routine for one row
    than for many, and its elementwise loops compute a call's full vectors
    with SLEEF but the rest (a [B, N] row's tail, a thread's share's edge)
    with libm, whose atan2 differs in the last bit.  On the card each
    branch is one launch, kernels.refine_f0_dec or (no D) kernels.
    refine_f0_full, which sums every row and frame in an order of its own:
    no row groups, no padding.

    bounds: (lo, hi), the samples of x that lie within the signal (a frame
    shard's block with halos: the halo past the signal's edge is zeros).
    The decimating FIR's output outside them is zeroed, as the FIR of the
    whole signal never computes it and the probes read zero padding
    there.  The full-rate branch ignores it: its probes read x itself,
    whose halo past the signal's edge is the zero padding they read."""
    B, N = f0.shape
    if not use_pallas:
        return _refine_f0_plain(x, f0, nhop=nhop, fs=fs, halfwin_max=halfwin_max,
                                rel_winsize=rel_winsize, window=window,
                                iters=iters, max_rel_dev=max_rel_dev)
    if B > 1 and x.device.type == "cpu":
        kw = dict(nhop=nhop, fs=fs, halfwin_max=halfwin_max,
                  rel_winsize=rel_winsize, window=window, iters=iters,
                  max_rel_dev=max_rel_dev, f0_ceil=f0_ceil, bounds=bounds)
        return torch.cat([refine_f0(x[b:b + 1], f0[b:b + 1], **kw)
                          for b in range(B)])
    D, h_t, g, pass_hz = refine_decimation(nhop, x.shape[-1], fs, f0_ceil)
    if D == 1:
        return kernels.refine_f0_full(x, f0, nhop=nhop, fs=fs,
                                      halfwin_max=halfwin_max,
                                      rel_winsize=rel_winsize, window=window,
                                      iters=iters, max_rel_dev=max_rel_dev)
    return kernels.refine_f0_dec(
        x, f0, h_t, D=D, g=g, nhop=nhop, fs=fs, halfwin_max=halfwin_max,
        rel_winsize=rel_winsize, window=window, iters=iters,
        max_rel_dev=max_rel_dev, pass_hz=pass_hz, bounds=bounds)


@functools.lru_cache(maxsize=64)
def refine_decimation(nhop: int, nx: int, fs: float, f0_ceil: float):
    """The decimated refine's factor and lowpass (harmonics.py:372-397):
    -> (D, taps, g, pass_hz), D the first of 8, 4, 2 dividing the hop and
    nx whose band clears f0_ceil (else 1 and no FIR), taps a tuple of the
    float64 windowed-sinc lowpass with passband pass_hz = 1.12 f0_ceil and
    linear phase (integer group delay g).  Made once per shape and rate."""
    for D in (8, 4, 2):
        if nhop % D == 0 and nx % D == 0 and 0.45 * fs / D > 1.1 * f0_ceil:
            break
    else:
        return 1, None, 0, 0.0
    fs_d = fs / D
    pass_hz = 1.12 * f0_ceil
    stop_hz = fs_d - pass_hz
    beta = 0.1102 * (65.0 - 8.7)
    ntaps = int(np.ceil(
        (65.0 - 7.95) / (2.285 * 2.0 * np.pi
                         * ((stop_hz - pass_hz) / fs)))) | 1
    g = (ntaps - 1) // 2
    n_t = np.arange(ntaps) - g
    fc = 0.5 * (pass_hz + stop_hz) / fs
    h_t = 2.0 * fc * np.sinc(2.0 * fc * n_t) * np.kaiser(ntaps, beta)
    return D, tuple(h_t / h_t.sum()), g, pass_hz


def _refine_f0_plain(x, f0, *, nhop: int, fs: float, halfwin_max: int,
                     rel_winsize: float, window: str, iters: int,
                     max_rel_dev: float):
    """refine_f0's jnp probes (harmonics.py:515-543): each probe projects
    the 2 halfwin_max + 1 samples around centre +- delta, windowed about
    the centre, on the constant-f0 fundamental, with sums over the frame;
    the presence gate is a fifth probe at 2 f0.  Each row alone (as the
    plain projection).  x [B, nx], f0 [B, N] -> [B, N]."""
    B, N = f0.shape
    H = halfwin_max
    W = 2 * H + 1
    dev = x.device
    delta = max(H // 8, 2)
    dt = 2.0 * delta / fs
    n_off = torch.arange(W, dtype=FP, device=dev) - H

    def row(xb, f0b):
        xp = F.pad(xb[0].to(FP), (H + W, H + W + 1))
        f0b = f0b[0]
        voiced = f0b > 0.0

        def probe(off, f0s, halfwidth):
            # frame n: samples n nhop + off + [-H, H] of x
            frames = xp[W + off:].unfold(0, W, nhop)[:N]
            xw = frames * window_centered(window, n_off, halfwidth[:, None])
            arg = 2.0 * math.pi * _phase_cycles(n_off, (f0s / fs)[:, None])
            re = torch.sum(torch.cos(arg) * xw, dim=-1)
            im = torch.sum(-torch.sin(arg) * xw, dim=-1)
            return torch.atan2(im, re), re * re + im * im

        f0s = torch.where(voiced, f0b, torch.full_like(f0b, 100.0))
        p1 = torch.zeros_like(f0s)
        for _ in range(iters):
            halfwidth = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0,
                                    float(H))
            ph_m, _ = probe(-delta, f0s, halfwidth)
            ph_p, p1 = probe(delta, f0s, halfwidth)
            err = ph_p - ph_m - 2.0 * math.pi * f0s * dt
            err = torch.atan2(torch.sin(err), torch.cos(err))
            f0_new = f0s + err / (2.0 * math.pi * dt)
            f0s = torch.minimum(torch.maximum(f0_new,
                                              f0b * (1 - max_rel_dev) - 1.0),
                                f0b * (1 + max_rel_dev) + 1.0)
        hw_g = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0, float(H))
        _, p2 = probe(delta, 2.0 * f0s, hw_g)
        f0s = torch.where(p1 > 0.0625 * p2, f0s, f0b)
        return torch.where(voiced, f0s, torch.zeros_like(f0s))[None]

    return each_row(row, x, f0)


def oscillator_bank(cyc, ampl, phse, mask, *, nhop: int) -> torch.Tensor:
    """Per-frame harmonic segments for 50%-overlap Hann OLA, in plain
    PyTorch (the JAX package's jnp branch, harmonics.py:591-608; with
    overlap_add_half, kernels.osc_bank's plain composition): cyc [B, nx],
    ampl/phse/mask [B, N, K] -> [B, N, 2*nhop], segment i spanning samples
    [(i-1)*nhop, (i+1)*nhop):
        s_i[t] = hann_ola(t) sum_k m a_k cos(2 pi (k+1)(cyc[c_i+t]-cyc[c_i])
                                            + phi_k).
    Each row alone, in chunks of frames; differentiable in ampl and
    phse."""
    B, N, K = ampl.shape
    T = 2 * nhop
    dev = cyc.device
    w_ola = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * (torch.arange(T, dtype=FP, device=dev) + 0.5) / T)
    kh = torch.arange(1, K + 1, dtype=FP, device=dev)
    step = max(_PLAIN_ELEMS // (K * T), 1)

    def per_chunk(dc, a, ph0):
        ph = _phase_cycles(kh[None, :, None], dc[:, None, :])
        osc = torch.cos(2.0 * math.pi * ph + ph0[:, :, None])
        return torch.einsum("nkt,nk->nt", osc, a)

    def row(c, am, p):
        dc = (frame_hops(c[0], N, nhop, 1, mode="edge")
              - c[0, ::nhop][:N, None])
        return frame_chunks(per_chunk, step, dc, am[0], p[0])[None]

    return each_row(row, cyc, ampl * mask, phse) * w_ola


def overlap_add_half(segments: torch.Tensor, nhop: int,
                     nx: int) -> torch.Tensor:
    """OLA of [B, N, 2*nhop] segments at centers i*nhop into [B, nx];
    segment i covers samples [(i-1)*nhop, (i+1)*nhop)."""
    B, N, _ = segments.shape
    a = segments[..., :nhop].reshape(B, -1)    # lands at blocks i-1
    y = segments[..., nhop:].reshape(B, -1).clone()   # lands at blocks i
    y[:, :(N - 1) * nhop] += a[:, nhop:]
    if nx <= N * nhop:
        return y[:, :nx]
    return F.pad(y, (0, nx - N * nhop))


def harmonic_peak_pick(x, f0, *, fs: float, max_k: int, halfwin_max: int,
                       rel_winsize: float, fnyq: float,
                       window: str = "blackman_harris", local_bins: int = 16,
                       nhop: int | None = None, centers=None):
    """Peak-picking harmonic estimation (harmonics.py:626-731 of the JAX
    package; reference: dsputils.c HMPP -- windowed FFT, the spectral peak
    nearest each k*f0, qifft refinement, then the exact projection at the
    refined frequencies).  Each harmonic searches +- local_bins bins
    masked to +- 0.4 f0.  x [B, nx], f0 [B, N] -> ampl, phse, mask
    [B, N, max_k].  Frames at uniform centres i*nhop are cut from the
    hop-blocked signal (frame_hops, 2 ceil(H / nhop) nhop samples); at
    `centers` [N] they are gathered (2H + 1 samples).  Each row alone, the
    projection in chunks of frames."""
    from .spectral import next_pow2, qifft
    B, N = f0.shape
    H = halfwin_max
    dev = x.device
    kharm = torch.arange(1, max_k + 1, dtype=FP, device=dev)
    voiced = f0 > 0.0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    halfwidth = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0, float(H))
    mask = (voiced[..., None] & (kharm * f0s[..., None] < fnyq)).to(FP)
    if centers is None:
        hh = -(-H // nhop)
        W, C = 2 * hh * nhop, hh * nhop
    else:
        centers = torch.as_tensor(centers, device=dev)
        W, C = 2 * H + 1, H
    n_off = torch.arange(W, dtype=FP, device=dev) - C
    nfft = next_pow2(W)
    nbin = nfft // 2 + 1
    offs = torch.arange(-local_bins, local_bins + 1, device=dev)
    step = max(_PLAIN_ELEMS // (max_k * W), 1)

    def project(xw, f):
        arg = 2.0 * math.pi * _phase_cycles(n_off, (f / fs)[:, :, None])
        return (torch.einsum("fkw,fw->fk", torch.cos(arg), xw),
                torch.einsum("fkw,fw->fk", -torch.sin(arg), xw))

    def row(xb, f0b, hwb, mb):
        if centers is None:
            frames = frame_hops(xb[0].to(FP), N, nhop, hh)
        else:
            frames = F.pad(xb[0].to(FP), (H, H + 1))[
                centers[:, None] + torch.arange(W, device=dev)]
        w = window_centered(window, n_off, hwb[0][:, None])
        xw = frames * w                                      # [N, W]
        logmag = torch.log(torch.abs(torch.fft.rfft(xw, n=nfft)) + 1e-12)
        bin_exp = kharm * f0b[0][:, None] / fs * nfft        # [N, K]
        cand = torch.clamp(torch.round(bin_exp).to(torch.int64)[..., None]
                           + offs, 1, nbin - 2)              # [N, K, L]
        lm = logmag[:, None, :].expand(N, max_k, nbin)
        lim = 0.4 * f0b[0][:, None, None] / fs * nfft
        valid = torch.abs(cand.to(FP) - bin_exp[..., None]) <= lim
        lm_local = torch.where(valid, torch.gather(lm, -1, cand),
                               torch.full_like(bin_exp[..., None], -1e9))
        pk = torch.argmax(lm_local, dim=-1, keepdim=True)
        pk_bin = torch.gather(cand, -1, pk)[..., 0]          # [N, K]
        refined, _ = qifft(lm, pk_bin)
        f_ref = torch.where(mb[0] > 0, refined / nfft * fs,
                            kharm * f0b[0][:, None])
        re, im = frame_chunks(project, step, xw, f_ref)
        wsum = torch.clamp(w.sum(dim=-1), min=1e-9)
        return (2.0 * torch.sqrt(re ** 2 + im ** 2) / wsum[:, None])[None], \
            torch.atan2(im, re)[None]

    ampl, phse = each_row(row, x, f0s, halfwidth, mask)
    return ampl * mask, phse * mask, mask
