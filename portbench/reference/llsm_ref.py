"""The plain reference of the benchmark: layer-0 analysis and synthesis
of the LLSM vocoder in plain PyTorch (float32; TF32 is the caller's to
set), as the port's CUDA kernels compute them.

A frozen copy of the PyTorch port's plain twins of its kernels (the
``*_ref`` functions of its ops/kernels.py, each the JAX package's jnp or
Pallas math) and of the glue around them in its models/layer0.py and
ops/harmonics.py, cut down to the path the benchmark's configurations
run: the decimated F0 refine, the cycle track, the fused-window
projection, the analytic deconvolution handing its complex track to the
track denoiser and its spectral gate, the residual, the band envelopes
and their projection, the warped periodogram; the oscillator bank and the
shaped, band-split, envelope-modulated noise with JAX's threefry draw.
It imports nothing of the port or of the JAX package, and a rewritten
kernel leaves it as it is.  Every function takes a leading batch axis.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

FP = torch.float32
CP = torch.complex64

#: True in the control: every matrix product (einsum, matmul) takes its
#: operands rounded to TF32 (10 mantissa bits, to nearest, ties away from
#: zero, as the tensor cores' conversion) and accumulates in float32 -- the
#: reference computed in TF32, the precision below float32 with TF32 off
PRODUCTS_IN_TF32 = False


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """t (float32 or complex64) with every float rounded to TF32."""
    if t.is_complex():
        return torch.complex(round_tf32(t.real), round_tf32(t.imag))
    bits = t.to(FP).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(FP)


@contextlib.contextmanager
def precision(tf32: bool):
    """Run the reference in float32 with TF32 off, or with tf32 its matrix
    products in TF32 (PRODUCTS_IN_TF32, and PyTorch's TF32 switches on)."""
    global PRODUCTS_IN_TF32
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = (PRODUCTS_IN_TF32, cuda.allow_tf32, cudnn.allow_tf32)
    PRODUCTS_IN_TF32 = cuda.allow_tf32 = cudnn.allow_tf32 = bool(tf32)
    try:
        with torch.no_grad():
            yield
    finally:
        PRODUCTS_IN_TF32, cuda.allow_tf32, cudnn.allow_tf32 = prev


def _p(t: torch.Tensor) -> torch.Tensor:
    """A matrix product's operand, in TF32 where the control asks."""
    return round_tf32(t) if PRODUCTS_IN_TF32 else t

# ---

COSINE_SERIES = {
    "hanning": (0.5, -0.5),
    "hamming": (0.54, -0.46),
    "blackman": (0.42, -0.5, 0.08),
    "blackman_harris": (0.35875, -0.48829, 0.14128, -0.01168),
    "nuttall98": (0.3635819, -0.4891775, 0.1365995, -0.0106411),
}


def window_eval(name: str, u: torch.Tensor) -> torch.Tensor:
    """Evaluate window `name` at normalized positions u in [0, 1]; positions
    outside [0, 1] evaluate to 0 (compact support)."""
    inside = (u >= 0.0) & (u <= 1.0)
    if name == "mltsine":
        w = torch.sin(math.pi * u)
    else:
        w = torch.zeros_like(u)
        for m, a in enumerate(COSINE_SERIES[name]):
            w = w + a * torch.cos(2.0 * math.pi * m * u)
    return torch.where(inside, w, torch.zeros_like(w))


def window_centered(name: str, n: torch.Tensor, halfwidth) -> torch.Tensor:
    """Window centered at 0 with support [-halfwidth, +halfwidth]; `n` are
    sample offsets from the center, `halfwidth` may be a tensor."""
    u = (n / halfwidth + 1.0) * 0.5
    return window_eval(name, u)


# ---

def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def periodogram(frames: torch.Tensor, window: torch.Tensor,
                nfft: int) -> torch.Tensor:
    """Windowed periodogram, power-per-bin convention normalized by
    sum(w^2) so that unit-variance white noise gives a flat PSD of 1."""
    wsumsq = torch.sum(window ** 2)
    spec = torch.fft.rfft(frames * window, n=nfft)
    return (spec.real ** 2 + spec.imag ** 2) / torch.clamp(wsumsq, min=1e-12)


# ---

def warp_frequency(f, warp_const):
    """Linear frequency [Hz] -> warped coordinate (float32)."""
    return warp_const * torch.log1p(torch.as_tensor(f, dtype=FP) / warp_const)


def warped_band_matrix(npsd: int, nbin: int, fs: float, warp_const: float,
                       device="cpu") -> torch.Tensor:
    """[npsd, nbin] row-normalized averaging matrix taking a linear-axis
    half-spectrum (nbin rfft bins, 0..fs/2) to npsd warped-axis band means.
    Built on the CPU in float32 (so the band edges do not depend on the
    device's transcendental rounding) and moved to `device`."""
    f = torch.arange(nbin, dtype=FP) * (fs / 2.0) / (nbin - 1)
    wmax = warp_frequency(fs / 2.0, warp_const)
    band = torch.floor(warp_frequency(f, warp_const) / wmax * npsd)
    band = torch.clamp(band, 0, npsd - 1).to(torch.int64)
    onehot = (band[None, :] == torch.arange(npsd)[:, None]).to(FP)
    counts = torch.clamp(onehot.sum(dim=1, keepdim=True), min=1.0)
    return (onehot / counts).to(device)


# ---

def interp1_uniform(fp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of fp (last axis sampled on the uniform grid
    0..len-1) at fractional positions pos, clamped at the edges.  The
    leading axes of fp and pos broadcast: pos [P] serves every row, pos
    [..., P] one row each (the JAX package's vmap(interp1_uniform)) ->
    [..., P]."""
    n = fp.shape[-1]
    lead = torch.broadcast_shapes(fp.shape[:-1], pos.shape[:-1])
    pos = torch.clamp(pos, 0.0, n - 1.0)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    frac = pos - i0
    fp = fp.expand(lead + (n,))
    i0 = i0.expand(lead + i0.shape[-1:])
    f0 = torch.gather(fp, -1, i0)
    f1 = torch.gather(fp, -1, i0 + 1)
    return f0 + (f1 - f0) * frac


# ---

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


def harmonic_analysis(x, f0, cyc, *, nhop: int, fs: float, max_k: int,
                      halfwin_max: int, rel_winsize: float, fnyq: float,
                      window: str = "hanning", with_dc: bool = False):
    """Harmonic amplitudes/phases of every frame by the chirped
    pitch-synchronous projection, frames centred at i*nhop: x [B, nx], cyc
    [Bc, nx] (Bc divides B: row b of x takes cyc row b // (B // Bc));
    f0 [B, N] (0 = unvoiced) -> ampl, phse, mask [B, N, max_k], plus the
    windowed DC [B, N] with with_dc (unvoiced frames with the f0 = 100 Hz
    placeholder window).  Unvoiced frames' window shrinks to the minimum
    unless the DC is wanted; slots past ceil(fnyq / f0) are zero."""
    B, N = f0.shape
    H = halfwin_max
    dev = x.device
    kharm = torch.arange(1, max_k + 1, dtype=FP, device=dev)
    voiced = f0 > 0.0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    halfwidth = torch.clamp(rel_winsize * fs / (2.0 * f0s), 2.0, float(H))
    mask = (voiced[..., None] & (kharm * f0s[..., None] < fnyq)).to(FP)
    halfwidth_e = halfwidth if with_dc else torch.where(
        voiced, halfwidth, torch.full_like(halfwidth, 2.0))
    kl = torch.clamp(torch.where(voiced, torch.ceil(fnyq / f0s),
                                 torch.zeros_like(f0s)), 0, max_k)
    C = -(-H // nhop) * nhop
    hw_int = torch.ceil(halfwidth_e).to(torch.int32)
    re, im, wsum, xsum = harmonic_project_win_ref(
        x, cyc, halfwidth_e, max_k, C - hw_int, C + hw_int + 1, nhop=nhop,
        center=C, window=window, kl=kl.to(torch.int32))
    wsum = torch.clamp(wsum, min=1e-9)
    ampl = 2.0 * torch.sqrt(re ** 2 + im ** 2) / wsum[..., None]
    phse = torch.atan2(im, re)
    if with_dc:
        return ampl * mask, phse * mask, mask, xsum / wsum
    return ampl * mask, phse * mask, mask


def refine_f0(x, f0, *, nhop: int, fs: float, halfwin_max: int,
              rel_winsize: float, f0_ceil: float, window: str = "hanning",
              iters: int = 2, max_rel_dev: float = 0.05):
    """Refine F0 by the fundamental's phase slope on the lowpass-decimated
    signal (refine_f0_dec_ref).  x [B, nx], f0 [B, N] -> [B, N]."""
    D, h_t, g, pass_hz = refine_decimation(nhop, x.shape[-1], fs, f0_ceil)
    if D == 1:
        raise ValueError("the reference holds the decimated refine only: "
                         f"no decimation divides hop {nhop} at {fs} Hz")
    return refine_f0_dec_ref(
        x, f0, h_t, D=D, g=g, nhop=nhop, fs=fs, halfwin_max=halfwin_max,
        rel_winsize=rel_winsize, window=window, iters=iters,
        max_rel_dev=max_rel_dev, pass_hz=pass_hz)


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


def oscillator_bank(cyc, ampl, phse, mask, *, nhop: int) -> torch.Tensor:
    """Per-frame harmonic segments for 50%-overlap Hann OLA, in plain
    PyTorch (the JAX package's jnp branch, harmonics.py:591-608; with
    overlap_add_half, osc_bank's plain composition): cyc [B, nx],
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
        return torch.einsum("nkt,nk->nt", _p(osc), _p(a))

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


# ---

_REF_ELEMS = 1 << 24


def osc_bank_ref(cyc, ampl, phse, mask, nhop, x=None):
    """Plain version of osc_bank: oscillator_bank's framed
    segments (the jnp math of harmonics.py:570-607), overlap-added."""
    y = overlap_add_half(oscillator_bank(cyc, ampl, phse, mask, nhop=nhop),
                         nhop, cyc.shape[-1])
    return y if x is None else x - y


def harmonic_project_win_ref(x, cyc, hw, max_k, lo, hi, *, nhop, center,
                             window="hanning", kl=None):
    """Plain version of harmonic_project_win: win_frames'
    buffers through the jnp math of harmonics.py:171-188."""
    Bx, N = hw.shape
    frames, dc = win_frames(x, cyc, N, nhop, center)
    hw, lo, hi = hw.reshape(-1), lo.reshape(-1), hi.reshape(-1)
    dev = x.device
    col = torch.arange(2 * center, device=dev)
    noff = (col - center).to(FP)[None, :]
    w = window_centered(window, noff, hw[:, None])
    w = w * ((col[None, :] >= lo[:, None]) & (col[None, :] < hi[:, None]))
    xw = frames * w
    re, im = harmonic_project_ref(dc, xw, max_k)
    if kl is not None:
        live = torch.arange(max_k, device=dev)[None, :] < kl.reshape(-1, 1)
        re, im = re * live, im * live
    return (re.reshape(Bx, N, max_k), im.reshape(Bx, N, max_k),
            w.sum(dim=-1).reshape(Bx, N), xw.sum(dim=-1).reshape(Bx, N))


def harmonic_project_ref(dc, xw, max_k, lo=None, hi=None):
    """Plain version of harmonic_project (the jnp math of
    test_pallas.py:35-47, with k dc reduced mod 1)."""
    R, W = dc.shape
    dev = dc.device
    if lo is not None and hi is not None:
        col = torch.arange(W, device=dev)[None, :]
        xw = xw * ((col >= lo[:, None]) & (col < hi[:, None]))
    kh = torch.arange(1, max_k + 1, dtype=FP, device=dev)
    re = torch.empty((R, max_k), dtype=FP, device=dev)
    im = torch.empty((R, max_k), dtype=FP, device=dev)
    step = max(_REF_ELEMS // (max_k * W), 1)
    for s in range(0, R, step):
        arg = 2.0 * math.pi * _phase_cycles(kh[None, :, None],
                                            dc[s:s + step, None, :])
        re[s:s + step] = torch.einsum("nkw,nw->nk", _p(torch.cos(arg)),
                                      _p(xw[s:s + step]))
        im[s:s + step] = torch.einsum("nkw,nw->nk", _p(-torch.sin(arg)),
                                      _p(xw[s:s + step]))
    return re, im


def deconv_full_ref(ampl, phse, cyc, hw, mask, D, nhop, stride, *,
                    return_complex=True):
    """Plain version of deconv_full: the quadrature field e^{2 pi j cyc}
    from frame_hops(mode="edge") and the centre cycles sliced from the
    track, the banded step (_deconv_step), then the mask and, for the
    polar track, sqrt / atan2 (the JAX caller, layer0.py:229-246)."""
    N = ampl.shape[1]
    nq = (2 * nhop) // stride
    C2 = frame_hops(cyc, N, nhop, 1, mode="edge")           # [B, N, 2nhop]
    ang = 2.0 * math.pi * C2[..., stride // 2::stride][..., :nq]
    c_re, c_im = _deconv_step(ampl, phse, cyc[..., ::nhop][..., :N], hw,
                              torch.cos(ang), torch.sin(ang), D, nhop,
                              stride)
    if return_complex:
        return c_re * mask, c_im * mask
    return (torch.sqrt(c_re ** 2 + c_im ** 2) * mask,
            torch.atan2(c_im, c_re) * mask)


def _shift_frames(v: torch.Tensor, d: int) -> torch.Tensor:
    """v[:, i] -> v[:, i + d] along the frame axis (dim 1), zero-padded:
    shifts stay inside each utterance."""
    if d == 0:
        return v
    out = torch.zeros_like(v)
    if d > 0:
        out[:, :-d] = v[:, d:]
    else:
        out[:, -d:] = v[:, :d]
    return out


def _deconv_step(ampl, phse, cyc_c, hw, eq_re, eq_im, D, nhop, stride):
    """The banded Neumann step of deconv_full_ref on the centre cycles cyc_c
    [B, N] and the quadrature field eq [B, N, nq] (the jnp math of
    layer0.py:248-299) -> the un-aligned (re, im), before the mask."""
    B, N, K = ampl.shape
    nq = eq_re.shape[-1]
    dev = ampl.device
    r = -nhop + (torch.arange(nq, dtype=FP, device=dev) + 0.5) * stride
    w_ola = 0.5 + 0.5 * torch.cos(math.pi * r / nhop)
    d_off = torch.arange(-D, D + 1, dtype=FP, device=dev)
    n_abs = d_off[:, None] * nhop + r[None, :]                  # [2D+1, nq]
    w_i = window_centered("hanning", n_abs, hw[..., None, None])
    P = w_i * w_ola                                     # [B, N, 2D+1, nq]
    tot = torch.clamp(P.sum(dim=(-2, -1), keepdim=True), min=1e-9)
    Pn = P / tot
    T_band = Pn.sum(dim=-1)                                     # [B, N, 2D+1]
    eq = torch.complex(eq_re, eq_im)
    X_band = torch.stack([
        (Pn[:, :, j].to(CP) * _shift_frames(eq, d)).sum(dim=-1)
        for j, d in enumerate(range(-D, D + 1))], dim=-1)       # [B, N, 2D+1]
    kh = torch.arange(1, K + 1, dtype=FP, device=dev)
    ph = _phase_cycles(kh, cyc_c[..., None])
    align = torch.polar(torch.ones_like(ph), -2.0 * math.pi * ph)
    c = torch.polar(ampl, phse) * align                         # [B, N, K]
    zero = torch.zeros_like(c[..., :1])
    c_up = torch.cat([c[..., 1:], zero], dim=-1)                # c'_{k+1}
    c_dn = torch.cat([zero, c[..., :-1]], dim=-1)               # c'_{k-1}
    Sm = torch.zeros_like(c)
    for j, d in enumerate(range(-D, D + 1)):
        Sm = Sm + T_band[..., j:j + 1] * _shift_frames(c, d) \
            + X_band[..., j:j + 1] * _shift_frames(c_up, d) \
            + X_band[..., j:j + 1].conj() * _shift_frames(c_dn, d)
    c2 = (2.0 * c - Sm) * align.conj()
    return c2.real.contiguous(), c2.imag.contiguous()


@functools.lru_cache(maxsize=32)
def band_ranges(nbin: int, fs: float, edges: tuple) -> tuple:
    """Each noise band's bins [lo, hi), flattened to 2 C ints (lo = hi for
    an empty band): bin k at f = k fs / T in float32 (T = 2 (nbin - 1))
    lies in band c where edges[c] <= f < edges[c + 1]; f rises with k, so a
    band's bins are one range (the JAX package's band masks,
    layer0._synth_noise)."""
    f = torch.arange(nbin, dtype=FP) * fs / (2 * (nbin - 1))
    out = []
    for c in range(len(edges) - 1):
        k = torch.nonzero((f >= edges[c]) & (f < edges[c + 1])).flatten()
        out += [int(k[0]), int(k[-1]) + 1] if len(k) else [0, 0]
    return tuple(out)


def _band_segments(shaped_spec: torch.Tensor, masks: torch.Tensor,
                   w: torch.Tensor, T: int) -> torch.Tensor:
    """Windowed per-band time segments [B, C, N, T] from the shaped noise
    spectra [B, N, nbin]: the inverse real DFT as one contraction with the
    synthesis window and band masks folded into the matrix (JAX
    layer0._band_segments, matmul branch)."""
    nbin = shaped_spec.shape[-1]
    dev = shaped_spec.device
    b = torch.arange(nbin, dtype=torch.int64, device=dev)
    t = torch.arange(T, dtype=torch.int64, device=dev)
    # exact cycles mod 1 via integer arithmetic before trig
    ang = 2.0 * math.pi * (torch.remainder(b[:, None] * t[None, :], T)
                           .to(FP) / T)
    wb = torch.full((nbin,), 2.0 / T, dtype=FP, device=dev)
    wb[0] = wb[-1] = 1.0 / T
    scale = wb[:, None] * w[None, :]                         # [nbin, T]
    cos_c = masks[:, :, None] * (torch.cos(ang) * scale)     # [C, nbin, T]
    sin_c = masks[:, :, None] * (torch.sin(ang) * scale)
    return (torch.einsum("znb,cbt->zcnt", _p(shaped_spec.real), _p(cos_c))
            - torch.einsum("znb,cbt->zcnt", _p(shaped_spec.imag), _p(sin_c)))


def noise_mod_ola_ref(cyc, edc, ar, ai, base, re, im, gain, bands):
    """Plain version of noise_mod_ola: the shaped spectra (the JAX
    package's layer0.py:1168-1175), the band iDFT (_band_segments) and the
    OLA + modulation + band sum of the segments (noise_mod_ola_seg_ref)."""
    nbin = gain.shape[-1]
    nhop = nbin - 1
    T = 2 * nhop
    dev = cyc.device
    scale = torch.full((nbin,), math.sqrt(T / 2.0), dtype=FP, device=dev)
    scale[0] = scale[-1] = math.sqrt(float(T))
    # the DC and Nyquist bins are real: their imaginary draws are dropped
    im_scale = scale.clone()
    im_scale[0] = im_scale[-1] = 0.0
    shaped = torch.complex(re * scale, im * im_scale) * gain
    k = torch.arange(nbin, device=dev)
    masks = torch.stack([((k >= lo) & (k < hi)).to(FP)
                         for lo, hi in zip(bands[::2], bands[1::2])])
    # sqrt-Hann WOLA pair: perfect reconstruction at 50% overlap
    w = torch.sqrt(0.5 - 0.5 * torch.cos(
        2.0 * math.pi * (torch.arange(T, dtype=FP, device=dev) + 0.5) / T))
    segs = _band_segments(shaped, masks, w, T)               # [B, C, N, T]
    return noise_mod_ola_seg_ref(cyc, edc, ar, ai, base, segs)


def noise_mod_ola_seg_ref(cyc, edc, ar, ai, base, segs):
    """Plain version of noise_mod_ola_seg: each band's OLA times its
    envelope over its baseline (layer0.py:1190-1195), the envelopes by
    env_render_ref."""
    nhop = segs.shape[-1] // 2
    env, base_s = env_render_ref(cyc, edc, ar, ai, base, nhop)
    y = torch.zeros_like(cyc)
    for c in range(segs.shape[1]):
        band_y = overlap_add_half(segs[:, c], nhop, cyc.shape[-1])
        y = y + band_y * (env[:, c] / base_s[:, c])
    return y


def env_render_ref(cyc, edc, ar, ai, base, nhop: int | None = None):
    """Plain version of env_render (the frame-structured lerp + rotation
    recurrence of layer0._render_envelopes, layer0.py:1008-1041); with an
    explicit nhop, cyc may be shorter than N*nhop (the render is cut)."""
    B, N, C, Ke = ar.shape
    nx = cyc.shape[-1]
    nhop = nx // N if nhop is None else nhop
    t = torch.arange(nhop, dtype=FP, device=cyc.device) / nhop

    def lerp(a):  # [B, N, ...] -> [B, nx, ...]
        rest = a.shape[2:]
        tt = t.reshape((1, 1, nhop) + (1,) * len(rest))
        out = a[:, :-1, None] + tt * (a[:, 1:] - a[:, :-1])[:, :, None]
        out = out.reshape((B, (N - 1) * nhop) + rest)
        tail = a[:, -1:].expand((B, nhop) + rest)   # last frame constant
        return torch.cat([out, tail], dim=1)[:, :nx]

    ph1 = 2.0 * math.pi * (cyc - torch.round(cyc))
    c1, s1 = torch.cos(ph1), torch.sin(ph1)
    osc_c, osc_s = [c1], [s1]
    for _ in range(Ke - 1):
        osc_c.append(osc_c[-1] * c1 - osc_s[-1] * s1)
        osc_s.append(osc_c[-2] * s1 + osc_s[-1] * c1)
    osc_c = torch.stack(osc_c, dim=-1)[:, :, None, :]            # [B, nx, 1, Ke]
    osc_s = torch.stack(osc_s, dim=-1)[:, :, None, :]
    env = lerp(edc) + torch.sum(lerp(ar) * osc_c - lerp(ai) * osc_s, dim=-1)
    return (torch.clamp(env, min=0.0).transpose(1, 2),
            torch.clamp(lerp(base), min=1e-8).transpose(1, 2))


@functools.lru_cache(maxsize=64)
def _taps32_cached(taps: tuple) -> tuple:
    return tuple(float(t) for t in np.asarray(taps, dtype=np.float32))


def _taps32(taps) -> tuple:
    """FIR taps rounded to float32, as the kernels (and the Pallas kernel's
    Python-float constants) apply them; converted once per tap tuple."""
    return _taps32_cached(taps if isinstance(taps, tuple) else tuple(taps))


def fir_frames_ref(v, taps):
    """Plain version of fir_frames: the shift-and-add chain in tap order,
    in float32, on v or each tensor of the pair v.  A FIR is a
    convolution, which a library runs as a matrix product: in the control
    its operands are TF32 (_p)."""
    if not torch.is_tensor(v):
        return tuple(fir_frames_ref(u, taps) for u in v)
    h = len(taps) // 2
    out = torch.zeros_like(v)
    v = _p(v)
    for j, t in enumerate(_taps32(taps)):
        if PRODUCTS_IN_TF32:
            t = float(round_tf32(torch.tensor(t, dtype=FP)))
        out = out + t * _shift_frames(v, j - h)
    return out


def _coherent_fit(cre, cim, csr, csi, w):
    """Per-row weighted least-squares fit of the fast residual r = c - c_s
    across k, r ~ (m0 + m1 k) c_s, weights w [B, N, K] -> (rcr, rci) the
    coherent part and (rir, rii) the incoherent rest (pallas_osc.py:965-987
    and :1063-1087; the ridge keeps near-singular rows finite)."""
    kh = torch.arange(1, cre.shape[-1] + 1, dtype=FP, device=cre.device)
    rr = cre - csr
    ri = cim - csi
    p = (csr * csr + csi * csi) * w
    crr = (csr * rr + csi * ri) * w       # Re(conj(c_s) r)
    cri = (csr * ri - csi * rr) * w       # Im(conj(c_s) r)
    s = lambda t: torch.sum(t, dim=-1, keepdim=True)
    a00, a01, a11 = s(p), s(kh * p), s(kh * kh * p)
    b0r, b0i, b1r, b1i = s(crr), s(cri), s(kh * crr), s(kh * cri)
    det = a00 * a11 - a01 * a01
    inv = 1.0 / (det + 1e-5 * a00 * a11 + 1e-12)
    m0r = (a11 * b0r - a01 * b1r) * inv
    m0i = (a11 * b0i - a01 * b1i) * inv
    m1r = (a00 * b1r - a01 * b0r) * inv
    m1i = (a00 * b1i - a01 * b0i) * inv
    wr = m0r + m1r * kh
    wi = m0i + m1i * kh
    rcr = wr * csr - wi * csi
    rci = wr * csi + wi * csr
    return rcr, rci, rr - rcr, ri - rci


def denoise_stats_ref(a, p, cyc_c, mask, voiced, taps1, taps2, *,
                      complex_input=False):
    """Plain version of denoise_stats (_denoise_body and
    _denoise_stats_kernel, pallas_osc.py:885-1040): the utterances are
    zero-extended by h1 + h2 frames at both ends, which is what the Pallas
    kernel's zero halo gives."""
    B, N, K = a.shape
    t1, t2 = _taps32(taps1), _taps32(taps2)
    h1, h2 = len(t1) // 2, len(t2) // 2
    e = h1 + h2
    pad = lambda t: torch.nn.functional.pad(t.to(FP), (0, 0, e, e))
    a_e, p_e, m_e = pad(a), pad(p), pad(mask)                 # [B, N+2e, K]
    cy_e, vo_e = pad(cyc_c[..., None]), pad(voiced[..., None])
    kh = torch.arange(1, K + 1, dtype=FP, device=a.device)
    if complex_input:
        ph = -cy_e * kh
        ph = ph - torch.round(ph)
        ang = 2.0 * math.pi * ph
        ar, ai = torch.cos(ang), torch.sin(ang)
        cre_all = a_e * ar - p_e * ai
        cim_all = a_e * ai + p_e * ar
    else:
        ph = p_e / (2.0 * math.pi) - cy_e * kh
        ph = ph - torch.round(ph)
        ang = 2.0 * math.pi * ph
        cre_all = a_e * torch.cos(ang)
        cim_all = a_e * torch.sin(ang)
    ext = lambda t: t[:, h1:h1 + N + 2 * h2]      # frames [-h2, N + h2)
    csr = ext(fir_frames_ref(cre_all, t1))
    csi = ext(fir_frames_ref(cim_all, t1))
    guard = ext(fir_frames_ref(vo_e, t1)) > 0.999
    cre, cim = ext(cre_all), ext(cim_all)
    _, _, rir, rii = _coherent_fit(cre, cim, csr, csi, ext(m_e))
    core = lambda t: t[:, h2:h2 + N]
    prr = core(rir - fir_frames_ref(rir, t2))
    pri = core(rii - fir_frames_ref(rii, t2))
    cre, cim, csr, csi = core(cre), core(cim), core(csr), core(csi)
    cs2 = csr * csr + csi * csi
    r2 = (cre - csr) ** 2 + (cim - csi) ** 2
    return (prr * prr + pri * pri, cs2, r2, core(guard)[..., 0], cre, cim,
            csr, csi)


def denoise_apply_ref(cre, cim, csr, csi, cyc_c, mask, guard, v, wmul,
                      strength, *, spectral=False):
    """Plain version of denoise_apply (_denoise_apply_body and its two
    kernels, pallas_osc.py:1043-1139, with the polar output of the JAX
    host, layer0.py:680-681)."""
    g = (guard if guard.dtype == torch.bool else guard > 0.5)[..., None]
    rcr, rci, rir, rii = _coherent_fit(cre, cim, csr, csi,
                                       wmul[:, None, :] * mask)
    pw = rir * rir + rii * rii
    gain = torch.clamp(1.0 - strength * v[:, None, :] / (pw + 1e-20),
                       0.0, 1.0)
    a = torch.complex(torch.where(g, csr + rcr + gain * rir, cre),
                      torch.where(g, csi + rci + gain * rii, cim))
    if not spectral:
        return denoise_finish_ref(a, torch.zeros_like(a), cyc_c, mask)
    zero = torch.zeros_like(csr)
    return a, torch.complex(torch.where(g, csr + rir, zero),
                            torch.where(g, csi + rii, zero))


def denoise_finish_ref(a, delta, cyc_c, mask):
    """Plain version of denoise_finish."""
    kh = torch.arange(1, a.shape[-1] + 1, dtype=FP, device=a.device)
    ua = 2.0 * math.pi * _phase_cycles(kh, cyc_c[..., None])
    z = (a + delta) * torch.polar(torch.ones_like(ua), ua)
    return torch.abs(z) * mask, torch.angle(z) * mask


_U32 = 0xFFFFFFFF


_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)


_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
              1.00167406, 2.83297682)


def _threefry(k1, k2, x0, x1):
    """Threefry-2x32 (20 rounds; jax/_src/prng.py threefry2x32) on int64
    tensors holding uint32 values -> (x0, x1) hashed."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _U32, (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = ((x1 << r) & _U32 | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """jax.random.normal's float32 step from 32 random bits: the mantissa
    of a float in [1, 2) minus 1, scaled to u in (-1, 1), sqrt(2)
    erf_inv(u), every operation a separate float32 rounding."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    # (1 - lo) rounds to 2 in float32, as in jax.random.uniform
    u = torch.clamp(f * float(np.float32(1.0) - lo) + float(lo),
                    min=float(lo))
    w = -torch.log1p(-(u * u))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(small, _ERFINV_LO[i], _ERFINV_HI[i])
    p = coef(0)
    for i in range(1, len(_ERFINV_LO)):
        p = coef(i) + p * w
    return float(np.float32(math.sqrt(2.0))) * (p * u)


def noise_bins_ref(seed: int, frame_base: int, B: int, N: int, nbin: int,
                   device=None):
    """Standard-normal noise spectra of frames [frame_base, frame_base + N)
    as the JAX package draws them: frame f's (re, im) bins are
    jax.random.normal(kr, (nbin,)) and normal(ki, (nbin,)) with kr, ki =
    split(fold_in(PRNGKey(seed), f)), threefry-2x32 in int64 tensors
    masked to 32 bits; one [N, nbin] draw each, expanded to [B, N, nbin]."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    frame = (frame_base + torch.arange(N, **i64)) & _U32
    zero = torch.zeros_like(frame)
    # fold_in(PRNGKey(seed), frame), then split: the key pair of each draw
    f0, f1 = _threefry(0, int(seed) & _U32, zero, frame)
    keys = [_threefry(f0, f1, zero, zero + j) for j in (0, 1)]
    col = torch.arange(nbin, **i64)[None, :]
    out = []
    for k0, k1 in keys:
        b0, b1 = _threefry(k0[:, None], k1[:, None], torch.zeros_like(col),
                           col)
        out.append(_normal_from_bits(b0 ^ b1).expand(B, N, nbin))
    return tuple(out)


def sample_cycles_ref(f0: torch.Tensor, nhop: int, fs: float, nx: int,
                      base: torch.Tensor | None = None,
                      start: int = 0) -> torch.Tensor:
    """Plain version of sample_cycles.  F0 is linearly interpolated between
    frame centers (i*nhop) and integrated in two levels: a cumsum of the
    float32 steps within each hop (a few cycles; accumulated in float64,
    each partial rounded to float32) plus a prefix sum of
    the per-hop totals.  That prefix sum is taken in float64 and reduced mod 1
    (the JAX package uses a mod-1 associative scan): a float32 cumsum over
    1600 hops would lose ~1e-4 cycles.  Integer cycles are irrelevant
    downstream.

    A frame shard's block of a longer track (parallel.seqparallel) gives
    start, the whole track's index of its first frame (negative in the
    first shard's halo), and base [...] (float64), each row's cycles
    before its first sample: the exact sum of the whole track's hop totals
    before it (cycle_totals).  Positions are then the whole track's, the
    prefix sum starts from base, and the block's samples are the whole
    track's bit for bit."""
    if nx % nhop:
        raise ValueError("sample_cycles: nx must be a multiple of nhop")
    d = cycle_steps(f0, nhop, fs, nx, start)
    # each partial summed in float64 and rounded, on every device (the
    # CPU's float32 cumsum does so itself; a CUDA one would drift)
    within = torch.cumsum(d.reshape(d.shape[:-1] + (-1, nhop)).to(
        torch.float64), dim=-1).to(d.dtype)
    tot = torch.remainder(within[..., -1], 1.0).to(torch.float64)
    pre = torch.cumsum(tot, dim=-1)
    b = None if base is None else torch.as_tensor(
        base, dtype=torch.float64, device=d.device).reshape(d.shape[:-1])
    if b is not None:
        pre = b[..., None] + pre
    off = torch.remainder(pre, 1.0).to(FP)
    first = torch.zeros_like(off[..., :1]) if b is None else \
        torch.remainder(b, 1.0).to(FP)[..., None]
    off = torch.cat([first, off[..., :-1]], dim=-1)
    c = torch.remainder(off[..., None] + within, 1.0).reshape(d.shape)
    return torch.cat([first, c[..., :-1]], dim=-1)


def cycle_steps(f0: torch.Tensor, nhop: int, fs: float, nx: int,
                start: int = 0) -> torch.Tensor:
    """The cycles each sample advances, d = F0 / fs, F0 (clamped at 0)
    lerped between frame centres (i*nhop): f0 [..., N] -> [..., nx] in
    float32, the operations the kernel repeats (f0_over_fs).  start: the
    whole track's index of frame 0 (a frame shard's block), whose sample
    positions the float32 lerp takes."""
    n = f0.shape[-1]
    f0s = torch.where(f0 > 0, f0, torch.zeros_like(f0))
    # the divisors as tensors on the device: PyTorch's CUDA divides by a
    # host scalar as a product with its reciprocal, which rounds otherwise
    div = lambda v: torch.tensor(v, dtype=f0s.dtype, device=f0.device)
    # each sample index rounded to float32 on its own, as the kernel and
    # jnp.arange take it: a float32 torch.arange rounds some indices past
    # 2^24 otherwise
    pos = torch.arange(start * nhop, start * nhop + nx, dtype=torch.int64,
                       device=f0.device).to(FP) / div(nhop)
    i0 = torch.clamp(torch.floor(pos).to(torch.int64) - start, 0, n - 2)
    t = torch.clamp(pos - (i0 + start), 0.0, 1.0)
    return (f0s[..., i0] * (1.0 - t) + f0s[..., i0 + 1] * t) / div(fs)


def _refine_dims(nx: int, D: int, nhop: int, fs: float, H: int) -> dict:
    """The decimated refine's sizes (harmonics.py:379-427): the decimated
    length and hop, the window's and the probes' reach in decimated
    samples, the probe spacing in seconds, the frame's half span C and
    width Wf."""
    nhop_d = nhop // D
    H_d = -(-H // D)
    delta_d = max(max(H // 8, 2) // D, 1)
    hh = -(-(H_d + delta_d) // nhop_d)
    return dict(nxd=nx // D, nhop_d=nhop_d, H_d=H_d, delta_d=delta_d,
                dt_d=2.0 * delta_d * D / fs, fs_d=fs / D, C=hh * nhop_d,
                hh=hh, Wf=2 * hh * nhop_d)


def refine_f0_dec_ref(x, f0, taps, *, D, g, nhop, fs, halfwin_max,
                      rel_winsize, window, iters, max_rel_dev, pass_hz,
                      bounds=None):
    """Plain version of refine_f0_dec (the JAX package's jnp,
    harmonics.py:399-468): the polyphase FIR as Qh products of the [B,
    nxd + Qh, D] sample blocks with the taps' rows, the frames of
    frame_hops, and each probe as PyTorch sums over the frame's
    Wf samples.  On the CPU refine_f0 calls it a row at a time."""
    nx = x.shape[-1]
    dev = x.device
    dm = _refine_dims(nx, D, nhop, fs, halfwin_max)
    nxd, fs_d, H_d, delta_d = dm["nxd"], dm["fs_d"], dm["H_d"], dm["delta_d"]
    C, Wf, dt_d = dm["C"], dm["Wf"], dm["dt_d"]
    h_t = np.asarray(taps, dtype=np.float64)
    Qh = -(-len(h_t) // D)
    hq = torch.as_tensor(np.pad(h_t, (0, Qh * D - len(h_t))).reshape(Qh, D),
                         dtype=FP, device=dev)
    padL, padR = g, Qh * D - g
    xp_f = torch.nn.functional.pad(x.to(FP), (padL, padR))
    Bm = xp_f[..., : ((nx + padL + padR) // D) * D].reshape(x.shape[0], -1, D)
    xd = torch.zeros((x.shape[0], nxd), dtype=FP, device=dev)
    for q in range(Qh):
        xd = xd + _p(Bm[:, q:q + nxd, :]) @ _p(hq[q])
    if bounds is not None:
        keep = torch.arange(nxd, device=dev) * D
        xd = torch.where((keep >= bounds[0]) & (keep < bounds[1]), xd,
                         torch.zeros_like(xd))
    fr = frame_hops(xd, f0.shape[-1], dm["nhop_d"], dm["hh"])  # [B, N, Wf]
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

    voiced = f0 > 0.0
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


# ---

def _env_decimation(conf, requested: int, nx: int) -> int:
    """Largest valid envelope decimation <= requested: a power of two that
    divides the hop and the FFT size, with every noise channel's band
    inside one alias window of the decimated grid (checked on the same
    ceil-rounded FFT-bin indices _band_envelopes folds)."""
    edges = conf.chan_edges
    nfft = next_pow2(nx)
    D = 1
    while 2 * D <= max(int(requested), 1):
        D *= 2
    while D > 1:
        nfft_d = nfft // D
        ok = conf.nhop % D == 0 and nfft % D == 0
        for c in range(conf.nchannel):
            lo, hi = edges[c], edges[c + 1]
            b_lo = int(-(-lo * nfft // conf.fs))
            b_hi = min(int(-(-hi * nfft // conf.fs)), nfft // 2 + 1)
            if b_hi <= b_lo or b_lo // nfft_d != (b_hi - 1) // nfft_d:
                ok = False
        if ok:
            return D
        D //= 2
    return 1


ROW_GROUP = 64


ROW_GROUP_FRAMES = 1600


def _group_rows(nfrm: int) -> int:
    """Rows a call of the grouped stages for utterances of nfrm frames:
    ROW_GROUP halved until G nfrm^2 <= ROW_GROUP ROW_GROUP_FRAMES^2, so a
    batch of one pads at most about the work of ROW_GROUP 8 s rows."""
    G = ROW_GROUP
    while G > 1 and G * nfrm * nfrm > ROW_GROUP * ROW_GROUP_FRAMES ** 2:
        G //= 2
    return G


def _row_groups(fn, t: torch.Tensor, rows: int) -> torch.Tensor:
    """fn(t) over groups of exactly `rows` rows of t (its leading axis),
    the last group zero-padded -> fn's output over t's rows, each row the
    same whatever the batch and its place in it."""
    outs = []
    for r0 in range(0, t.shape[0], rows):
        part = t[r0:r0 + rows]
        n = part.shape[0]
        if n < rows:
            part = torch.cat([part, part.new_zeros((rows - n,)
                                                   + part.shape[1:])])
        outs.append(fn(part)[:n])
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _frame_sums(t: torch.Tensor, rows: int) -> torch.Tensor:
    """Sums over the frame axis (1) of t [B, N, ...] in groups of `rows`
    rows."""
    return _row_groups(lambda a: torch.sum(a, dim=1), t, rows)


def _band_envelopes(residual: torch.Tensor, conf,
                    decimate: int = 1, *,
                    rows: int | None = None) -> torch.Tensor:
    """Per-channel temporal amplitude envelopes of the residual [B, nx]
    from the FFT-domain analytic signal -> [B, C, nx // decimate].  With
    D > 1 each band's one-sided spectrum is folded into an nfft/D grid (a
    coherent frequency shift, since the band lies in one alias window), so
    |z| is exactly the full-rate envelope sampled every D samples.  The
    transforms run in groups of `rows` rows (default _group_rows of the
    utterance's frames), so a row's envelopes do not depend on its
    batch."""
    B, nx = residual.shape
    dev = residual.device
    C = conf.nchannel
    nfft = next_pow2(nx)
    rows = rows or _group_rows(nx // conf.nhop)
    # the bands lie in [0, fs/2): the one-sided spectrum is all they read
    X = _row_groups(lambda r: torch.fft.rfft(r, n=nfft), residual, rows)
    edges = conf.chan_edges
    D = decimate
    nfft_d = nfft // D
    # every band's spectrum [B, C, nfft_d], one inverse transform for all
    y = torch.zeros((B, C, nfft_d), dtype=X.dtype, device=dev)
    if D == 1:
        f = torch.fft.fftfreq(nfft, 1.0 / conf.fs, device=dev)[:X.shape[1]]
        for c in range(C):
            m = ((f >= edges[c]) & (f < edges[c + 1])).to(FP)
            y[:, c, :X.shape[1]] = X * m * 2.0
    else:
        for c in range(C):
            b_lo = int(-(-edges[c] * nfft // conf.fs))
            b_hi = min(int(-(-edges[c + 1] * nfft // conf.fs)),
                       nfft // 2 + 1)
            shift = (b_lo // nfft_d) * nfft_d
            y[:, c, b_lo - shift:b_hi - shift] = 2.0 * X[:, b_lo:b_hi]
    del X
    z = _row_groups(torch.fft.ifft, y.reshape(B * C, nfft_d), rows)
    if D > 1:
        z = z * (1.0 / D)
    return torch.abs(z).reshape(B, C, nfft_d)[..., :nx // D]


PSD_UNGROUPED_NFFT = 512


def _warped_psd(residual: torch.Tensor, nfrm: int, conf,
                rows: int | None = None) -> torch.Tensor:
    """Per-frame PSD of the residual [B, nx] on the warped axis
    [B, N, npsd] (reference: dsputils.c warped PSD estimation); with
    `rows`, periodograms longer than PSD_UNGROUPED_NFFT or tracks longer
    than ROW_GROUP_FRAMES take their FFTs and band product in groups of
    that many rows (_row_groups), so a row's PSD does not depend on its
    batch."""
    nhop = conf.nhop
    winlen = 4 * nhop
    nfft = next_pow2(winlen)
    # np.hanning is the SYMMETRIC window, as jnp.hanning
    w = torch.as_tensor(np.hanning(winlen), dtype=FP, device=residual.device)
    band_mat = warped_band_matrix(conf.npsd, nfft // 2 + 1, conf.fs,
                                       conf.noswarp, device=residual.device)

    def psd(r):
        frames = frame_hops(r, nfrm, nhop, 2)
        return _p(periodogram(frames, w, nfft)) @ _p(band_mat.T)
    if rows is None or (nfft <= PSD_UNGROUPED_NFFT
                        and nfrm <= ROW_GROUP_FRAMES):
        return psd(residual)
    return _row_groups(psd, residual, rows)


def _deconv_correction(conf, f0, cyc, ampl, phse, mask):
    """Analytic amplitude-track deconvolution: one Neumann step c' <- 2c -
    S c on the phase-aligned complex tracks (deconv_full_ref), returning
    the masked complex track (re, im) for the track denoiser."""
    nhop = conf.nhop
    D = -(-conf.halfwin_max // nhop) + 1
    if D > 128:
        raise ValueError(f"the reference holds the banded step to D = 128, "
                         f"not {D}")
    voiced = f0 > 0.0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    halfwidth = torch.clamp(conf.rel_winsize * conf.fs / (2.0 * f0s), 2.0,
                            float(conf.halfwin_max))
    stride = max(min(8, nhop), 1)
    return deconv_full_ref(ampl, phse, cyc, halfwidth, mask, D, nhop, stride,
                           return_complex=True)


@functools.lru_cache(maxsize=32)
def _hann_taps(M: int) -> tuple:
    """Normalized symmetric Hann FIR of M taps (np.hanning(M + 2)[1:-1])."""
    w = np.hanning(M + 2)[1:-1]
    return tuple((w / w.sum()).tolist())


#: a gate's decision is reported as marginal where its two sides lie
#: within this share of each other: two float32 evaluations of the same
#: sums, in different orders, can then decide it either way
GATE_MARGIN = 1e-3


def _margin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Relative distance |a - b| / max(|a|, |b|) of a decision a > b; inf
    where both are zero (0 > 0 decides alike in any order)."""
    top = torch.maximum(a.abs(), b.abs())
    return torch.where(top > 0, (a - b).abs() / torch.where(
        top > 0, top, torch.ones_like(top)), torch.full_like(top, math.inf))


def _denoise_floor_stats(pp, cs2_m, r2, amp2_m, ok, *,
                         rows: int | None = None, report: dict | None = None):
    """Per-utterance floor statistics of the track denoiser: [B, N, K]
    powers and the usable-slot mask ok -> (v [B, K] gate floor, wmul
    [B, K] coherent-fit weights), every sum over one utterance's frames.
    v is the Winsorized mean of pp over usable frames, zeroed with fewer
    than 16 of them, below -35 dB of the slow power, or where the slow
    track keeps under 10% of the raw energy; wmul drops noise-dominated
    tracks from the fit (JAX layer0.py:329-365 says why).  The frame sums
    run in groups of `rows` rows (default _group_rows(N)): PyTorch splits
    them by the row count.  With `report`, its "floor_margin" [B, K] is
    the least margin (_margin) of a gate that decides the track's v, and
    "q_margin" that of the q gate alone (inf where v is zero before it)."""
    rows = rows or _group_rows(pp.shape[1])
    zero = torch.zeros((), dtype=FP, device=pp.device)
    osum = lambda t: _frame_sums(torch.where(ok, t, zero), rows)
    cnt = torch.sum(ok, dim=1).to(FP)              # a count: exact
    n_ok = torch.clamp(cnt, min=1.0)
    v = osum(pp) / n_ok
    for _ in range(3):
        v = osum(torch.minimum(pp, 3.0 * v[:, None, :])) / n_ok
    v = torch.where(cnt >= 16.0, v, zero)
    p_bar = osum(cs2_m) / n_ok
    floor_margin = _margin(v, 10.0 ** -3.5 * p_bar)
    v = torch.where(v > 10.0 ** -3.5 * p_bar, v, zero)
    p_raw = osum(amp2_m) / n_ok
    q = p_bar / torch.clamp(p_raw, min=1e-20)
    if report is not None:
        q_margin = torch.where(v > 0, _margin(q, torch.full_like(q, 0.1)),
                               torch.full_like(q, math.inf))
        report["floor_margin"] = torch.minimum(floor_margin, q_margin)
        report["q_margin"] = q_margin
        report["v_unzeroed"] = v
    v = torch.where(q > 0.1, v, zero)
    f_k = osum(r2) / n_ok
    wmul = torch.clamp(1.0 - 2.0 * f_k / torch.clamp(p_bar, min=1e-20),
                       0.0, 1.0)
    return v, wmul


class _GateDFT(NamedTuple):
    """Constant transforms of the decimated spectral gate."""
    Wf: torch.Tensor       # [NPd, Nd] forward DFT
    Whigh: torch.Tensor    # [H/2, N] every second probe-band bin, full rate
    Wi: torch.Tensor       # [Nd, NPd] inverse DFT (1/NPd folded in)
    n_high: int


def _gate_sizes(N: int, D: int):
    NP = 1 << max(int(N - 1).bit_length(), 4)
    Nd = (N + D - 1) // D
    NPd = 1 << max(int(Nd - 1).bit_length(), 4)
    return NP, Nd, NPd


@functools.lru_cache(maxsize=8)
def _gate_dft(N: int, D: int, thop: float, cutoff_hz: float,
              device: torch.device) -> _GateDFT:
    """The decimated gate's DFT matrices, built once per shape and device
    (Whigh alone is ~9 MB at N = 1600)."""
    NP, Nd, NPd = _gate_sizes(N, D)
    f_np = np.fft.fftfreq(NP, thop)
    high_n = np.where(np.abs(f_np) > 2.0 * cutoff_hz)[0][::2]
    # complex64 entries (the JAX package's), in CP arithmetic
    mat = lambda a: torch.as_tensor(a.astype(np.complex64),
                                    device=device).to(CP)
    return _GateDFT(
        Wf=mat(np.exp((-2j * np.pi / NPd)
                      * np.outer(np.arange(NPd), np.arange(Nd)))),
        Whigh=mat(np.exp((-2j * np.pi / NP)
                         * np.outer(high_n, np.arange(N)))),
        Wi=mat(np.exp((2j * np.pi / NPd)
                      * np.outer(np.arange(Nd), np.arange(NPd))) / NPd),
        n_high=len(high_n))


def _spectral_gate(c_s, full, pp, guard, v, mask, thop: float,
                   cutoff_hz: float, a_spec: float, decimate: int = 1, *,
                   rows: int | None = None, report: dict | None = None):
    """Per-frame-frequency-bin noise gate on the slow track (JAX
    layer0.py:368-599, whose docstring gives the reasons): c_s, full
    [B, N, K] complex (slow part; guarded c_s + r_inc), pp [B, N, K], guard
    [B, N, 1] bool, v [B, K], mask [B, N, K] -> the aligned-domain
    subtraction delta [B, N, K], zero on unguarded rows.  Every statistic
    (probe level, engagement, noise profile, local blend) is taken within
    one utterance.  decimate D > 1 gates at the frame rate / D by DFT
    matmuls and block-lerps the delta back; D = 1 uses FFTs.  The products
    run in complex64 (fp32, no TF32).  The transforms, products and frame
    sums, whose order the libraries choose by the row count, run in groups
    of `rows` rows (default _group_rows(N)).  The local-noisiness blend's
    frame FIRs run through fir_frames_ref.  With `report`, its
    "engaged_margin" [B, K] is the margin (_margin) of each live track's
    engagement, its "engaged" [B, K] the decision and its "engage_floor"
    [B, K] the level v has to pass."""
    B, N, K = c_s.shape
    D = max(int(decimate), 1)
    G = rows or _group_rows(N)
    grouped = lambda fn, t: _row_groups(fn, t, G)
    power = lambda z: z.real ** 2 + z.imag ** 2
    zero = torch.zeros((), dtype=FP, device=c_s.device)
    czero = torch.zeros((), dtype=c_s.dtype, device=c_s.device)
    if D > 1:
        mats = _gate_dft(N, D, float(thop), float(cutoff_hz), c_s.device)
        sg_d = torch.where(guard[:, ::D], c_s[:, ::D], czero)   # [B, Nd, K]
        Xs = grouped(lambda t: torch.matmul(_p(mats.Wf), _p(t)), sg_d)   # [B, NPd, K]
        lev_k = grouped(lambda t: torch.sum(power(
            torch.matmul(_p(mats.Whigh), _p(t))), dim=1), full) \
            / (float(max(mats.n_high, 1)) * D)
    else:
        NP = _gate_sizes(N, 1)[0]
        hb = np.abs(np.fft.fftfreq(NP, thop)) > 2.0 * cutoff_hz
        hbt = torch.as_tensor(hb, device=c_s.device)[None, :, None]
        fft = lambda t: torch.fft.fft(t, n=NP, dim=1)
        Xs = grouped(fft, torch.where(guard, c_s, czero))
        lev_k = grouped(lambda t: torch.sum(torch.where(
            hbt, power(fft(t)), zero), dim=1), full) / float(max(hb.sum(), 1))
    Ps = power(Xs)
    # engagement stricter than the time gate's: -15 dB of the slow power
    gd = guard & (mask > 0)
    n_gd = torch.clamp(torch.sum(gd, dim=1).to(FP), min=1.0)   # exact
    p_bar = _frame_sums(torch.where(gd, power(c_s), zero), G) / n_gd
    engaged = (v > 10.0 ** -1.5 * p_bar) & (mask != 0).any(dim=1)   # [B, K]
    if report is not None:
        report["engaged_margin"] = torch.where(
            (mask != 0).any(dim=1), _margin(v, 10.0 ** -1.5 * p_bar),
            torch.full_like(v, math.inf))
        report["engaged"] = engaged
        report["engage_floor"] = 10.0 ** -1.5 * p_bar
    wk = engaged.to(FP)[:, None, :]
    nwk = torch.sum(engaged.to(FP), dim=-1)                        # [B]
    wsum = torch.clamp(nwk, min=1e-9)[:, None]
    lev_safe = torch.where(engaged, torch.clamp(lev_k, min=1e-30),
                           torch.ones_like(lev_k))
    pn = Ps / lev_safe[:, None, :]
    prof = torch.sum(pn * wk, dim=-1) / wsum                       # [B, NP]
    for _ in range(3):                                             # Winsorize
        cl = torch.minimum(pn, 3.0 * prof[..., None])
        prof = torch.sum(cl * wk, dim=-1) / wsum
    sm = 15                                                        # circular MA
    prof = sum(torch.roll(prof, j - sm // 2, dims=1) for j in range(sm)) / sm
    nf = lev_k[:, None, :] * prof[..., None]
    g = torch.clamp(1.0 - a_spec * nf / (Ps + 1e-30), 0.0, 1.0)
    # >= 3 noisy tracks for a usable profile; clean tracks untouched
    use = (nwk >= 3.0)[:, None, None] & engaged[:, None, :]
    g = torch.where(use, g, torch.ones_like(g))
    if D > 1:
        # inverse of the gated DIFFERENCE (g - 1) Xs, so transform rounding
        # stays relative to the delta; block-lerp back to the frame rate
        delta_d = grouped(lambda t: torch.matmul(_p(mats.Wi), _p(t)),
                          (g - 1.0) * Xs)                        # [B, Nd, K]
        nxt = torch.cat([delta_d[:, 1:], delta_d[:, -1:]], dim=1)
        wts = (torch.arange(D, dtype=FP, device=c_s.device) / D)[:, None]
        up = delta_d[:, :, None] * (1.0 - wts) + nxt[:, :, None] * wts
        s_dn = c_s + up.reshape(B, -1, K)[:, :N]
    else:
        s_dn = grouped(lambda t: torch.fft.ifft(t, dim=1), g * Xs)[:, :N]

    # local-noisiness blend: frame-smoothed probe power against the floor
    M = int(round(1.0 / (thop * cutoff_hz))) | 1
    okf = gd.to(FP)
    if D > 1:
        BB = 2 * D
        Nb = -(-N // BB)
        bmean = lambda a: torch.nn.functional.pad(
            a, (0, 0, 0, Nb * BB - N)).reshape(B, Nb, BB, K).mean(dim=2)
        MB = max(int(round(M / BB)), 1) | 1
        wb = _hann_taps(MB)
        num, den = fir_frames_ref((bmean(pp * okf), bmean(okf)), wb)
        lp = torch.repeat_interleave(num / torch.clamp(den, min=1e-9), BB,
                                     dim=1)[:, :N]
    else:
        num, den = fir_frames_ref((pp * okf, okf), _hann_taps(M))
        lp = num / torch.clamp(den, min=1e-9)
    w_loc = torch.clamp(3.0 * lp / torch.clamp(v[:, None, :], min=1e-30)
                        - 0.5, 0.0, 1.0)
    return torch.where(guard, w_loc * (s_dn - c_s), czero)


def _track_denoise(conf, f0, cyc_c, c_complex, mask, cutoff_hz: float,
                   strength: float, *, a_spec: float, spec_decimate: int,
                   report: dict | None = None):
    """The dynamics-adaptive harmonic-track denoiser with its spectral gate,
    on the raw complex track (re, im) of the deconvolution: pass A
    (denoise_stats_ref), the per-utterance floor statistics, pass B
    (denoise_apply_ref), the per-bin gate's delta and the finish.  f0,
    cyc_c [B, N]; mask [B, N, K] -> (ampl, phse).  With `report`, the
    gates' margins (_denoise_floor_stats, _spectral_gate)."""
    frame_rate = 1.0 / conf.thop
    M = int(round(frame_rate / cutoff_hz)) | 1          # odd tap count
    Mp = int(round(frame_rate / (2.0 * cutoff_hz))) | 1
    taps1, taps2 = _hann_taps(M), _hann_taps(Mp)
    voiced = (f0 > 0).to(FP)
    (pp, cs2, r2, guard, cre, cim, csr, csi) = denoise_stats_ref(
        c_complex[0], c_complex[1], cyc_c, mask, voiced, taps1, taps2,
        complex_input=True)
    amp2_m = (cre * cre + cim * cim) * mask
    ok = guard[..., None] & (mask > 0)
    v, wmul = _denoise_floor_stats(pp, cs2 * mask, r2, amp2_m, ok,
                                   report=report)
    a, full = denoise_apply_ref(cre, cim, csr, csi, cyc_c, mask, guard, v,
                                wmul, float(strength), spectral=True)
    delta = _spectral_gate(torch.complex(csr, csi), full, pp,
                           guard[..., None], v, mask, conf.thop, cutoff_hz,
                           a_spec, decimate=spec_decimate, report=report)
    return denoise_finish_ref(a, delta, cyc_c, mask)


def gate_marginal(report: dict, eps: float = GATE_MARGIN) -> torch.Tensor:
    """The tracks [B, K] whose denoised output a float32 rounding can move
    by more than rounding, from a denoiser run's report: those with a gate
    within eps of its threshold (the floor's v, the q gate, the
    engagement) and, in a row where a track's engagement could go either
    way, every engaged track of the row, since the row's noise profile is
    the mean over its engaged tracks (and nwk >= 3 counts them)."""
    track = (report["floor_margin"] < eps) | (report["engaged_margin"] < eps)
    flips = (report["engaged_margin"] < eps) | (
        (report["q_margin"] < eps)
        & (report["v_unzeroed"] > report["engage_floor"]))
    row = flips.any(dim=-1, keepdim=True)
    return track | (row & (report["engaged"] | track))


def _moving_sum(v: torch.Tensor, S: int) -> torch.Tensor:
    """jnp.convolve(v, ones(S), mode="same") along the last axis, as a
    zero-padded windowed sum (no cuDNN, so no TF32 on the card)."""
    vp = torch.nn.functional.pad(v, (S // 2, (S - 1) // 2))
    return vp.unfold(-1, S, 1).sum(dim=-1)




def analyze(conf, opt, x: torch.Tensor, f0: torch.Tensor) -> dict:
    """Batched analysis: x [B, nx'], f0 [B, N] -> the chunk's fields with
    a leading batch axis, each stage on the last one's output: refine,
    harmonic_track, denoise, analyze_noise.  x is cut or zero-padded to
    N*nhop samples and is at conf.fs."""
    out = {"f0": refine(conf, opt, x, f0)}
    out.update(harmonic_track(conf, opt, x, out["f0"]))
    out.update(denoise(conf, opt, out["f0"], out["track_re"], out["track_im"],
                       out["hm_mask"]))
    out.update(analyze_noise(conf, opt, x, out["f0"], out["ampl"],
                             out["phse"], out["hm_mask"]))
    return out


def _frames(conf, x: torch.Tensor, nfrm: int) -> torch.Tensor:
    nx = nfrm * conf.nhop
    x = x.to(FP)[:, :nx]
    return torch.nn.functional.pad(x, (0, nx - x.shape[1]))


def refine(conf, opt, x: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """The refined F0 [B, N] of x from the given track: the decimated
    refine with its smoothed correction.  The options are the
    configuration's (check_options)."""
    check_options(opt)
    nfrm = f0.shape[1]
    x = _frames(conf, x, nfrm)
    f0 = f0.to(FP)
    f0_ref = refine_f0(
        x, f0, nhop=conf.nhop, fs=conf.fs, halfwin_max=conf.halfwin_max,
        rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    S = opt["f0_refine_smooth"]
    if S <= 1:
        return f0_ref
    # voicing-masked moving average of the refine CORRECTION
    voiced_m = (f0 > 0).to(FP)
    num = _moving_sum((f0_ref - f0) * voiced_m, S)
    den = torch.clamp(_moving_sum(voiced_m, S), min=1.0)
    return torch.where(voiced_m > 0, f0 + num / den, torch.zeros_like(f0))


def harmonic_track(conf, opt, x: torch.Tensor, f0: torch.Tensor) -> dict:
    """The harmonic track before the denoiser, from x and the refined F0
    [B, N]: the czt projection at every live harmonic and the analytic
    deconvolution's masked complex track (track_re, track_im [B, N, K]),
    with the harmonic mask (hm_mask).  No gate decides anything here."""
    check_options(opt)
    nhop = conf.nhop
    nfrm = f0.shape[1]
    x = _frames(conf, x, nfrm)
    f0 = f0.to(FP)
    cyc = sample_cycles_ref(f0, nhop, conf.fs, nfrm * nhop)
    ampl, phse, mask = harmonic_analysis(
        x, f0, cyc, nhop=nhop, fs=conf.fs, max_k=conf.maxnhar,
        halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
        fnyq=conf.fnyq)
    re, im = _deconv_correction(conf, f0, cyc, ampl, phse, mask)
    return dict(hm_mask=mask, track_re=re, track_im=im)


def denoise(conf, opt, f0: torch.Tensor, track_re: torch.Tensor,
            track_im: torch.Tensor, mask: torch.Tensor,
            report: dict | None = None) -> dict:
    """The track denoiser on a harmonic track before it (harmonic_track's
    fields) -> the chunk's ampl, phse [B, N, K]; with `report`, the gates'
    margins (gate_marginal reads them)."""
    check_options(opt)
    nhop = conf.nhop
    nfrm = f0.shape[1]
    cyc = sample_cycles_ref(f0.to(FP), nhop, conf.fs, nfrm * nhop)
    cyc_c = cyc[..., ::nhop][..., :nfrm].contiguous()
    ampl, phse = _track_denoise(
        conf, f0.to(FP), cyc_c, (track_re, track_im), mask,
        opt["track_denoise_hz"], opt["track_denoise_strength"],
        a_spec=opt["track_spectral_strength"],
        spec_decimate=opt["track_spectral_decimate"], report=report)
    return dict(ampl=ampl, phse=phse)


def analyze_noise(conf, opt, x: torch.Tensor, f0: torch.Tensor,
                  ampl: torch.Tensor, phse: torch.Tensor,
                  mask: torch.Tensor) -> dict:
    """The noise half of the analysis, from the signal and a harmonic
    analysis of it (refined f0 [B, N], ampl, phse, mask [B, N, K]): the
    residual, its band envelopes and their projection (edc, eenv_a,
    eenv_p), its warped periodogram (psd)."""
    nhop = conf.nhop
    B, nfrm = f0.shape
    nx = nfrm * nhop
    x = _frames(conf, x, nfrm)
    cyc = sample_cycles_ref(f0.to(FP), nhop, conf.fs, nx)
    residual = osc_bank_ref(cyc, ampl, phse, mask, nhop, x)
    # band envelopes (at the decimated rate fs/D) + warped PSD
    D = _env_decimation(conf, opt["env_decimate"], nx)
    envs = _band_envelopes(residual, conf, D)              # [B, C, nx/D]
    Cn, Ke = conf.nchannel, conf.maxnhar_e
    ea, ep, _, edc = harmonic_analysis(
        envs.reshape(B * Cn, -1), torch.repeat_interleave(f0, Cn, dim=0),
        cyc[:, ::D], nhop=nhop // D, fs=conf.fs / D, max_k=Ke,
        halfwin_max=-(-conf.halfwin_max // D), rel_winsize=conf.rel_winsize,
        fnyq=min(conf.fnyq, 0.4 * conf.fs / D), with_dc=True)
    edc = torch.clamp(edc, min=0.0).reshape(B, Cn, nfrm).transpose(1, 2)
    eenv_a = ea.reshape(B, Cn, nfrm, Ke).transpose(1, 2)   # [B, N, C, Ke]
    eenv_p = ep.reshape(B, Cn, nfrm, Ke).transpose(1, 2)
    psd = _warped_psd(residual, nfrm, conf, rows=_group_rows(nfrm))
    return dict(psd=psd, edc=edc.contiguous(), eenv_a=eenv_a.contiguous(),
                eenv_p=eenv_p.contiguous())


def _env_coefs(chunk: dict, cyc_c: torch.Tensor):
    """Rotated, voicing-masked envelope-harmonic coefficients of a batched
    chunk: (edc [B, N, C], ar, ai [B, N, C, Ke], base [B, N, C]).  eenv_p
    is measured at the frame center, the renderers use the absolute cycle
    track, so the phases are re-referenced by -2 pi k cyc_c; base is the
    unit-RMS modulator normalizer sqrt(edc^2 + sum a^2/2)."""
    voiced = (chunk["f0"] > 0).to(FP)[..., None, None]
    Ke = chunk["eenv_a"].shape[-1]
    kh = torch.arange(1, Ke + 1, dtype=FP, device=cyc_c.device)
    ph = chunk["eenv_p"] / (2.0 * math.pi) - kh * cyc_c[..., None, None]
    ph = (ph - torch.round(ph)) * (2.0 * math.pi)
    ar = chunk["eenv_a"] * torch.cos(ph) * voiced
    ai = chunk["eenv_a"] * torch.sin(ph) * voiced
    base = torch.sqrt(chunk["edc"] ** 2 + 0.5 * torch.sum(
        (chunk["eenv_a"] * voiced) ** 2, dim=-1))
    return chunk["edc"], ar, ai, base


def _synth_noise(conf, chunk: dict, cyc: torch.Tensor, nhop: int, fs: float,
                 noise_seed: int) -> torch.Tensor:
    """Noise component of a batched chunk -> [B, N*nhop]: each frame's
    white-noise spectrum (noise_bins_ref, keyed by (noise_seed, frame)) is
    shaped by sqrt(PSD), band-split, windowed back to time, overlap-added
    and modulated by the temporal envelopes (noise_mod_ola_ref)."""
    B, N = chunk["f0"].shape
    T = 2 * nhop
    nbin = T // 2 + 1
    dev = cyc.device
    # the PSD axis is warped over the analysis band [0, conf.fs/2]
    f = torch.arange(nbin, dtype=FP, device=dev) * fs / T
    nyq_a = conf.fs / 2.0
    wmax = warp_frequency(nyq_a, conf.noswarp).to(dev)
    pos = torch.clamp(warp_frequency(f, conf.noswarp) / wmax * conf.npsd
                      - 0.5, 0.0, conf.npsd - 1.0)
    gain = torch.sqrt(torch.clamp(interp1_uniform(chunk["psd"], pos),
                                  min=0.0))                  # [B, N, nbin]
    if fs > conf.fs:
        raise ValueError("the reference renders at the analysis rate")
    re, im = noise_bins_ref(noise_seed, 0, B, N, nbin, dev)
    edc, ar, ai, base = _env_coefs(chunk, cyc[..., ::nhop][..., :N])
    bands = band_ranges(nbin, float(fs), tuple(conf.chan_edges))
    return noise_mod_ola_ref(cyc, edc, ar, ai, base, re, im, gain, bands)


def synthesize(conf, sopt, chunk: dict) -> tuple:
    """Batched synthesis of a chunk's fields -> (y_sin, y_nos) [B, nx],
    rendered at sopt["fs"] (harmonics above its Nyquist masked), which
    must give an integral hop."""
    fs = sopt["fs"]
    if abs(conf.thop * fs - round(conf.thop * fs)) > 1e-6:
        raise ValueError("the reference renders at rates with an integral hop")
    nhop = int(round(conf.thop * fs))
    f0 = chunk["f0"]
    nx = f0.shape[-1] * nhop
    cyc = sample_cycles_ref(f0, nhop, fs, nx)
    K = chunk["ampl"].shape[-1]
    kharm = torch.arange(1, K + 1, dtype=FP, device=cyc.device)
    f0s = torch.where(f0 > 0, f0, torch.full_like(f0, 100.0))
    hm_mask = chunk["hm_mask"] * (kharm * f0s[..., None] < 0.5 * fs)
    y_sin = osc_bank_ref(cyc, chunk["ampl"], chunk["phse"], hm_mask, nhop)
    y_nos = _synth_noise(conf, chunk, cyc, nhop, fs, sopt["noise_seed"])
    return y_sin, y_nos


# the options the reference runs; any other value is refused
REFERENCE_OPTIONS = {
    "hm_method": "czt", "hm_passes": 1, "hm_correction": "deconv",
    "f0_refine": True, "hm_kernel": "rotation", "frame_chunk": 0,
    "track_denoise": True, "track_denoise_spectral": True,
    "track_lowpass_hz": 0.0, "fs_input": 0.0,
}


def check_options(opt: dict) -> None:
    """Refuse analysis options outside the path the reference holds."""
    for k, v in REFERENCE_OPTIONS.items():
        if opt.get(k) != v:
            raise ValueError(f"the reference holds {k} = {v!r}, not "
                             f"{opt.get(k)!r}")


class Conf(NamedTuple):
    """The chunk configuration the reference reads, with the derived sizes
    it uses."""
    fs: float
    thop: float
    maxnhar: int
    maxnhar_e: int
    npsd: int
    nchannel: int
    chanfreq: tuple
    noswarp: float
    fnyq: float
    f0_floor: float
    f0_ceil: float
    rel_winsize: float

    @property
    def nhop(self) -> int:
        return max(int(round(self.thop * self.fs)), 1)

    @property
    def halfwin_max(self) -> int:
        return int(math.ceil(self.rel_winsize * self.fs
                             / (2.0 * self.f0_floor)))

    @property
    def chan_edges(self) -> tuple:
        return (0.0,) + tuple(self.chanfreq) + (self.fs / 2.0,)

    @classmethod
    def from_dict(cls, d: dict) -> "Conf":
        return cls(**{k: (tuple(d[k]) if k == "chanfreq" else d[k])
                      for k in cls._fields})
