"""Harmonic analysis and additive synthesis on the main path (counterpart
of libllsm2_tpu/ops/harmonics.py; reference: dsputils.c CZT path,
layer0.c frame loop and sinusoidal synthesis).

Every function takes a leading batch axis ``[B, ...]`` where the JAX
package maps one utterance under ``jax.vmap``.  Only the branches the
JAX package runs with ``use_pallas=True`` at uniform frame centers (and
without frame_chunk) are ported; phase arguments are reduced to cycles
mod 1 before trig.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..fp import FP
from . import kernels
from .windows import COSINE_SERIES, window_centered


def _phase_cycles(kn: torch.Tensor, f_over_fs: torch.Tensor) -> torch.Tensor:
    """(k*n) * f/fs reduced to [-0.5, 0.5] cycles."""
    ph = kn * f_over_fs
    return ph - torch.round(ph)


def sample_cycles(f0: torch.Tensor, nhop: int, fs: float,
                  nx: int) -> torch.Tensor:
    """Fundamental phase in cycles MOD 1 at every sample: f0 [B, N] ->
    [B, nx], nx a multiple of nhop.

    F0 is linearly interpolated between frame centers (i*nhop) and
    integrated in two levels: a float32 cumsum within each hop (a few
    cycles, exact enough) plus a prefix sum of the per-hop totals.  That
    prefix sum is taken in float64 and reduced mod 1 (the JAX package uses
    a mod-1 associative scan): a float32 cumsum over 1600 hops would lose
    ~1e-4 cycles.  Integer cycles are irrelevant downstream."""
    if nx % nhop:
        raise ValueError("sample_cycles: nx must be a multiple of nhop")
    n = f0.shape[-1]
    dev = f0.device
    f0s = torch.where(f0 > 0, f0, torch.zeros_like(f0))
    pos = torch.arange(nx, dtype=FP, device=dev) / nhop
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    t = torch.clamp(pos - i0, 0.0, 1.0)
    f0_samp = f0s[..., i0] * (1.0 - t) + f0s[..., i0 + 1] * t
    d = f0_samp / fs
    within = torch.cumsum(d.reshape(d.shape[:-1] + (-1, nhop)), dim=-1)
    tot = torch.remainder(within[..., -1], 1.0).to(torch.float64)
    off = torch.remainder(torch.cumsum(tot, dim=-1), 1.0).to(FP)
    off = torch.cat([torch.zeros_like(off[..., :1]), off[..., :-1]], dim=-1)
    c = torch.remainder(off[..., None] + within, 1.0).reshape(d.shape)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


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
                      mxu: bool = False):
    """Harmonic amplitudes/phases of every frame by the chirped
    pitch-synchronous projection (the JAX package's use_pallas=True
    branches at frame centers i*nhop).

    x [B, nx], cyc [Bc, nx] (Bc divides B: row b of x takes cyc row
    b // (B // Bc), as the envelope pass's channels share their
    utterance's track); f0 [B, N] (0 = unvoiced) -> ampl, phse, mask
    [B, N, max_k] (phase at the frame center), plus the windowed DC
    [B, N] with with_dc (every frame, unvoiced ones with the f0 = 100 Hz
    placeholder window).  A cosine-series window runs the fused kernel,
    which frames x and cyc itself, or with mxu=True the unframed
    projection; any other window (mltsine) is applied here to frame
    buffers, which go through the plain projection kernel."""
    B, N = f0.shape
    H = halfwin_max
    dev = x.device
    kharm = torch.arange(1, max_k + 1, dtype=FP, device=dev)
    voiced = f0 > 0.0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    halfwidth = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0, float(H))
    mask = (voiced[..., None] & (kharm * f0s[..., None] < fnyq)).to(FP)
    # unvoiced outputs are masked, so their window shrinks to the minimum
    # unless the caller wants the (unmaskable) DC
    halfwidth_e = halfwidth if with_dc else torch.where(
        voiced, halfwidth, torch.full_like(halfwidth, 2.0))
    hh = -(-H // nhop)           # window halfwidth in whole hops
    if mxu and window in COSINE_SERIES:
        cyc = torch.repeat_interleave(cyc, B // cyc.shape[0], dim=0)
        re, im, wsum, xsum = kernels.harmonic_project_mxu(
            x, cyc, halfwidth_e, max_k, nhop, hh, window=window)
        ampl = 2.0 * torch.sqrt(re ** 2 + im ** 2)
        # the kernel projects on the absolute cycle: rotate to the centers
        cyc_c = cyc[..., ::nhop][..., :N]
        ang_c = 2.0 * math.pi * _phase_cycles(kharm, cyc_c[..., None])
        re, im = (re * torch.cos(ang_c) - im * torch.sin(ang_c),
                  re * torch.sin(ang_c) + im * torch.cos(ang_c))
    else:
        C = hh * nhop            # window center column of a frame
        hw_int = torch.ceil(halfwidth_e).to(torch.int32)
        lo, hi = C - hw_int, C + hw_int + 1
        if window in COSINE_SERIES:
            # live slots: ceil(fnyq/f0) >= the mask's slot count under
            # rounding
            kl = torch.where(voiced, torch.ceil(fnyq / f0s).to(torch.int32),
                             torch.zeros_like(hw_int))
            re, im, wsum, xsum = kernels.harmonic_project_win(
                x, cyc, halfwidth_e, max_k, lo, hi, nhop=nhop, center=C,
                window=window, kl=torch.clamp(kl, 0, max_k))
        else:
            frames, dcf = win_frames(x, cyc, N, nhop, C)
            noff = torch.arange(2 * C, dtype=FP, device=dev) - C
            w = window_centered(window, noff, halfwidth_e.reshape(-1, 1))
            xw = frames * w
            re, im = kernels.harmonic_project(dcf, xw, max_k, lo.reshape(-1),
                                              hi.reshape(-1))
            re, im = re.reshape(B, N, max_k), im.reshape(B, N, max_k)
            wsum = w.sum(dim=-1).reshape(B, N)
            xsum = xw.sum(dim=-1).reshape(B, N)
        ampl = 2.0 * torch.sqrt(re ** 2 + im ** 2)
    wsum = torch.clamp(wsum, min=1e-9)
    ampl = ampl / wsum[..., None]
    phse = torch.atan2(im, re)
    if with_dc:
        return ampl * mask, phse * mask, mask, xsum / wsum
    return ampl * mask, phse * mask, mask


def refine_f0(x, f0, *, nhop: int, fs: float, halfwin_max: int,
              rel_winsize: float, window: str = "hanning", iters: int = 2,
              max_rel_dev: float = 0.05, f0_ceil: float = 600.0):
    """Refine F0 by the fundamental's phase slope (the JAX package's
    use_pallas=True branches): on a lowpass-decimated signal where some
    D in 8/4/2 divides the hop and clears f0_ceil (harmonics.py:372-492),
    else at the full rate through the projection kernel
    (harmonics.py:494-543).  x [B, nx], f0 [B, N] -> [B, N]."""
    B, N = f0.shape
    nx = x.shape[-1]
    dev = x.device
    H = halfwin_max
    voiced = f0 > 0.0
    delta = max(H // 8, 2)
    D = 1
    for cand in (8, 4, 2):
        if nhop % cand == 0 and nx % cand == 0 \
                and 0.45 * fs / cand > 1.1 * f0_ceil:
            D = cand
            break
    if D == 1:
        return _refine_f0_full_rate(x, f0, nhop=nhop, fs=fs, halfwin_max=H,
                                    rel_winsize=rel_winsize, window=window,
                                    iters=iters, max_rel_dev=max_rel_dev)
    fs_d = fs / D
    nxd = nx // D
    # polyphase decimating FIR: windowed-sinc lowpass with passband
    # 1.12*f0_ceil, linear phase (integer group delay g)
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
    h_t = h_t / h_t.sum()
    Qh = -(-ntaps // D)
    hq = torch.as_tensor(np.pad(h_t, (0, Qh * D - ntaps)).reshape(Qh, D),
                         dtype=FP, device=dev)
    padL, padR = g, Qh * D - g
    xp_f = F.pad(x.to(FP), (padL, padR))
    Bm = xp_f[..., : ((nx + padL + padR) // D) * D].reshape(B, -1, D)
    xd = torch.zeros((B, nxd), dtype=FP, device=dev)
    for q in range(Qh):
        xd = xd + Bm[:, q:q + nxd, :] @ hq[q]
    nhop_d = nhop // D
    H_d = -(-H // D)
    delta_d = max(delta // D, 1)
    dt_d = 2.0 * delta_d * D / fs
    hh = -(-(H_d + delta_d) // nhop_d)
    Wf = 2 * hh * nhop_d
    C = hh * nhop_d
    fr = frame_hops(xd, N, nhop_d, hh)                     # [B, N, Wf]
    col = torch.arange(Wf, dtype=FP, device=dev)

    def probe(coff, f0s, halfwidth_d, with_double=False):
        noff_f = col - coff
        w = window_centered(window, noff_f, halfwidth_d[..., None])
        xw = fr * w
        arg = 2.0 * math.pi * _phase_cycles(noff_f, (f0s / fs_d)[..., None])
        c, s = torch.cos(arg), torch.sin(arg)
        re = torch.sum(c * xw, dim=-1)
        im = torch.sum(-s * xw, dim=-1)
        if not with_double:
            return torch.atan2(im, re), re * re + im * im
        # harmonic-2 power from the same frames via the double angle
        re2 = torch.sum((2.0 * c * c - 1.0) * xw, dim=-1)
        im2 = torch.sum(-2.0 * s * c * xw, dim=-1)
        return (torch.atan2(im, re), re * re + im * im,
                re2 * re2 + im2 * im2)

    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    p1 = p2 = torch.zeros_like(f0s)
    for it in range(iters):
        halfwidth_d = torch.clamp(rel_winsize * fs_d / (2.0 * f0s), 2.0,
                                  float(H_d))
        ph_m, _ = probe(C - delta_d, f0s, halfwidth_d)
        if it == iters - 1:
            ph_p, p1, p2 = probe(C + delta_d, f0s, halfwidth_d,
                                 with_double=True)
        else:
            ph_p, p1 = probe(C + delta_d, f0s, halfwidth_d)
        expected = 2.0 * math.pi * f0s * dt_d
        err = ph_p - ph_m - expected
        err = torch.atan2(torch.sin(err), torch.cos(err))
        f0_new = f0s + err / (2.0 * math.pi * dt_d)
        f0s = torch.minimum(torch.maximum(f0_new, f0 * (1 - max_rel_dev) - 1.0),
                            f0 * (1 + max_rel_dev) + 1.0)
    # fundamental-presence gate: keep the supplied track where harmonic 1
    # is buried under harmonic 2 (period-doubled sources)
    gate_ok = (p1 > 0.0625 * p2) | (2.0 * f0s >= pass_hz)
    f0s = torch.where(gate_ok, f0s, f0)
    return torch.where(voiced, f0s, torch.zeros_like(f0s))


def _refine_f0_full_rate(x, f0, *, nhop: int, fs: float, halfwin_max: int,
                         rel_winsize: float, window: str, iters: int,
                         max_rel_dev: float):
    """refine_f0 without decimation (harmonics.py:494-543): each probe
    projects left-aligned frames (window centred at ceil(halfwidth)) onto
    the fundamental with harmonic_project at K = 1; the presence gate is a
    fifth probe at 2 f0.  x [B, nx], f0 [B, N] -> [B, N]."""
    B, N = f0.shape
    dev = x.device
    H = halfwin_max
    W = 2 * H + 1
    voiced = f0 > 0.0
    xp = F.pad(x.to(FP), (H + W, H + W + 1))
    delta = max(H // 8, 2)
    dt = 2.0 * delta / fs
    centers = torch.arange(N, device=dev) * nhop
    col = torch.arange(W, device=dev)

    def probe(cts, f0s, halfwidth):
        # the basis phase reference shifts by (H - hw) per frame; the
        # update only uses ph_p - ph_m at equal halfwidth, so it cancels
        hw_int = torch.ceil(halfwidth).to(torch.int64)          # [B, N]
        noff = (col - hw_int[..., None]).to(FP)                 # [B, N, W]
        idx = (cts + W + H - hw_int)[..., None] + col
        frames = torch.gather(xp, 1, idx.reshape(B, -1)).reshape(B, N, W)
        xw = frames * window_centered(window, noff, halfwidth[..., None])
        dc = _phase_cycles(noff, (f0s / fs)[..., None])
        re, im = kernels.harmonic_project(
            dc.reshape(B * N, W), xw.reshape(B * N, W), 1,
            torch.zeros_like(hw_int).reshape(-1), (2 * hw_int + 1).reshape(-1))
        re, im = re.reshape(B, N), im.reshape(B, N)
        return torch.atan2(im, re), re * re + im * im

    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    p1 = torch.zeros_like(f0s)
    for _ in range(iters):
        halfwidth = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0, float(H))
        ph_m, _ = probe(centers - delta, f0s, halfwidth)
        ph_p, p1 = probe(centers + delta, f0s, halfwidth)
        expected = 2.0 * math.pi * f0s * dt
        err = ph_p - ph_m - expected
        err = torch.atan2(torch.sin(err), torch.cos(err))
        f0_new = f0s + err / (2.0 * math.pi * dt)
        f0s = torch.minimum(torch.maximum(f0_new, f0 * (1 - max_rel_dev) - 1.0),
                            f0 * (1 + max_rel_dev) + 1.0)
    # fundamental-presence gate, measured by its own probe at 2 f0 (not the
    # decimated branch's double-angle fold)
    hw_g = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0, float(H))
    _, p2 = probe(centers + delta, 2.0 * f0s, hw_g)
    f0s = torch.where(p1 > 0.0625 * p2, f0s, f0)
    return torch.where(voiced, f0s, torch.zeros_like(f0s))


def oscillator_bank(cyc, ampl, phse, mask, *, nhop: int) -> torch.Tensor:
    """Per-frame harmonic segments for 50%-overlap Hann OLA, in plain
    PyTorch (with overlap_add_half, kernels.osc_bank's plain composition):
    cyc [B, nx], ampl/phse/mask [B, N, K] -> [B, N, 2*nhop], segment i
    spanning samples [(i-1)*nhop, (i+1)*nhop):
        s_i[t] = hann_ola(t) sum_k m a_k cos(2 pi (k+1)(cyc[c_i+t]-cyc[c_i])
                                            + phi_k)."""
    B, N, K = ampl.shape
    T = 2 * nhop
    dev = cyc.device
    w_ola = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * (torch.arange(T, dtype=FP, device=dev) + 0.5) / T)
    dc = (frame_hops(cyc, N, nhop, 1, mode="edge")
          - cyc[..., ::nhop][..., :N, None]).reshape(B * N, T)
    kh = torch.arange(1, K + 1, dtype=FP, device=dev)
    a = (ampl * mask).reshape(B * N, K)
    ph0 = phse.reshape(B * N, K)
    segs = torch.empty((B * N, T), dtype=FP, device=dev)
    step = max((1 << 24) // (K * T), 1)     # ~64 MB of [rows, K, T] a chunk
    for s in range(0, B * N, step):
        ph = _phase_cycles(kh[None, :, None], dc[s:s + step, None, :])
        osc = torch.cos(2.0 * math.pi * ph + ph0[s:s + step, :, None])
        segs[s:s + step] = torch.einsum("nkt,nk->nt", osc, a[s:s + step])
    return segs.reshape(B, N, T) * w_ola


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
