"""The port's hand-written Hopper kernels and their plain PyTorch twins
(counterpart of libllsm2_tpu/ops/pallas_osc.py).

Each public function dispatches on the device of its tensors: a CPU
tensor runs the plain version (``*_ref``), a CUDA tensor launches the CUDA
kernel from ``csrc/`` (built by ops/_build.py on first use) or raises.
There is no fallback between the two.  ``LAUNCHES[name]`` counts the
kernel launches of each wrapper (and nothing else), so a run can show
that it went through the kernels.

Every kernel computes what its TPU kernel computes; the TPU blocking
(128-frame blocks, 8-row chunks, MXU banded matmuls) is not carried
over.  Each source file says what bounds its kernel on the H100 and how
its design answers that.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ..fp import CP, FP
from . import _build
from .windows import COSINE_SERIES, window_centered

LAUNCHES = {"osc_bank": 0, "harmonic_project_win": 0, "deconv_full": 0,
            "noise_mod_ola": 0, "denoise_stats": 0, "denoise_apply": 0,
            "harmonic_project": 0, "harmonic_project_mxu": 0,
            "fir_frames": 0, "env_render": 0, "noise_bins": 0}

# frames per chunk of the plain versions: bounds their [frames, K, T]
# temporaries to ~64 MB at any input size
_REF_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises otherwise or on a
    device mismatch."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"vs {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _launch(name: str, *args) -> None:
    rc = getattr(_build.library(), "llsm_" + name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _phase_cycles(k: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    ph = k * d
    return ph - torch.round(ph)


# ---------------------------------------------------------------------------
# 1. oscillator bank (pallas_osc.osc_bank_pallas)
# ---------------------------------------------------------------------------

def osc_bank(cyc: torch.Tensor, ampl: torch.Tensor, phse: torch.Tensor,
             mask: torch.Tensor, nhop: int,
             x: torch.Tensor | None = None) -> torch.Tensor:
    """Oscillator bank with its Hann OLA, from the cycle track to the
    signal: cyc [B, nx] mod-1 cycle track (nx = N nhop), ampl/phse/mask
    [B, N, K] -> y [B, nx] = overlap_add_half of the frames' segments
    w_ola(t) sum_k a m cos(2 pi (k+1) (cyc[c_n + t] - cyc[c_n]) + phi) at
    centers c_n = n nhop, or x - y given x [B, nx] (the analysis
    residual).  Slots above each frame's highest live one are skipped.
    One launch on the card; no [B N, 2 nhop] frame or segment buffer."""
    if not _on_cuda(cyc, ampl, phse, mask, *(() if x is None else (x,))):
        return osc_bank_ref(cyc, ampl, phse, mask, nhop, x)
    B, N, K = ampl.shape
    if cyc.shape != (B, N * nhop) or phse.shape != (B, N, K) \
            or mask.shape != (B, N, K) \
            or (x is not None and x.shape != cyc.shape):
        raise ValueError("osc_bank: shape mismatch")
    cyc, ampl, phse, mask = map(_f32, (cyc, ampl, phse, mask))
    x = None if x is None else _f32(x)
    y = torch.empty_like(cyc)
    _launch("osc_bank", cyc.data_ptr(), ampl.data_ptr(), phse.data_ptr(),
            mask.data_ptr(), None if x is None else x.data_ptr(),
            y.data_ptr(), B, N, K, int(nhop), _stream(cyc))
    return y


def osc_bank_ref(cyc, ampl, phse, mask, nhop, x=None):
    """Plain version of osc_bank: harmonics.oscillator_bank's framed
    segments (the jnp math of harmonics.py:570-607), overlap-added."""
    from .harmonics import oscillator_bank, overlap_add_half
    y = overlap_add_half(oscillator_bank(cyc, ampl, phse, mask, nhop=nhop),
                         nhop, cyc.shape[-1])
    return y if x is None else x - y


# ---------------------------------------------------------------------------
# 2. fused-window harmonic projection (pallas_osc.harmonic_project_win_pallas)
# ---------------------------------------------------------------------------

def harmonic_project_win(x: torch.Tensor, cyc: torch.Tensor,
                         hw: torch.Tensor, max_k: int, lo: torch.Tensor,
                         hi: torch.Tensor, *, nhop: int, center: int,
                         window: str = "hanning",
                         kl: torch.Tensor | None = None):
    """Framing + fused window + projection of frames at centers n*nhop:
    x [Bx, nx] the signal, cyc [Bc, nx] its mod-1 cycle track (x row b
    reads cyc row b // (Bx // Bc)); hw, lo, hi, kl [Bx, N] per frame ->
    (re [Bx, N, K], im [Bx, N, K], wsum [Bx, N], xsum [Bx, N]).  Frame n
    is column w in [0, 2 center) at sample s = n nhop - center + w, with
    x zero and cyc edge-clamped outside [0, nx) and dc(w) = cyc[s] -
    cyc[n nhop]; re + j im = sum_w x win e^{-2 pi j (k+1) dc}, wsum =
    sum_w win and xsum = sum_w x win (the k = 0 row).  win is the
    cosine-series `window` centered at column `center` with halfwidth
    hw; only columns in [lo, hi) (which must cover its support)
    contribute.  Slots k >= kl are exact zeros (kl=None: all max_k slots
    live).  No [Bx N, 2 center] frame buffer is built on the card."""
    Bx, nx = x.shape
    N = hw.shape[-1]
    if kl is None:
        kl = torch.full((Bx, N), max_k, dtype=torch.int32, device=x.device)
    if not _on_cuda(x, cyc, hw, lo, hi, kl):
        return harmonic_project_win_ref(x, cyc, hw, max_k, lo, hi, nhop=nhop,
                                        center=center, window=window, kl=kl)
    Bc = cyc.shape[0]
    if cyc.shape != (Bc, nx) or Bx % Bc or (N - 1) * nhop >= nx \
            or any(v.shape != (Bx, N) for v in (hw, lo, hi, kl)):
        raise ValueError("harmonic_project_win: shape mismatch")
    coefs = tuple(float(c) for c in COSINE_SERIES[window]) + (0.0,) * 3
    x, cyc, hw = _f32(x), _f32(cyc), _f32(hw)
    lo, hi, kl = _i32(lo), _i32(hi), _i32(kl)
    dev = x.device
    re = torch.empty((Bx, N, max_k), dtype=FP, device=dev)
    im = torch.empty((Bx, N, max_k), dtype=FP, device=dev)
    ws = torch.empty((Bx, N), dtype=FP, device=dev)
    xs = torch.empty((Bx, N), dtype=FP, device=dev)
    ptrs = (t.data_ptr() for t in (x, cyc, hw, lo, hi, kl, re, im, ws, xs))
    _launch("harmonic_project_win", *ptrs, Bx, Bx // Bc, nx, N, max_k,
            int(nhop), int(center), *coefs[:4], len(COSINE_SERIES[window]),
            _stream(x))
    return re, im, ws, xs


def harmonic_project_win_ref(x, cyc, hw, max_k, lo, hi, *, nhop, center,
                             window="hanning", kl=None):
    """Plain version of harmonic_project_win: harmonics.win_frames'
    buffers through the jnp math of harmonics.py:171-188."""
    from .harmonics import win_frames
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


# ---------------------------------------------------------------------------
# 5. amplitude-track deconvolution (pallas_osc.deconv_full_pallas)
# ---------------------------------------------------------------------------

def deconv_full(ampl: torch.Tensor, phse: torch.Tensor, cyc_c: torch.Tensor,
                hw: torch.Tensor, eq_re: torch.Tensor, eq_im: torch.Tensor,
                D: int, nhop: int, stride: int):
    """Fused amplitude-track deconvolution of a batch of utterances:
    ampl/phse [B, N, K] (masked), cyc_c [B, N] (mod-1 cycle at the frame
    centers), hw [B, N] (window halfwidth), eq_re/eq_im [B, N, nq]
    (e^{2 pi j cyc} at the band-quadrature points of each frame's hop) ->
    the corrected complex harmonics (re, im) [B, N, K] in the absolute-
    phase domain.  Frames beyond either end of an utterance are zero."""
    if not _on_cuda(ampl, phse, cyc_c, hw, eq_re, eq_im):
        return deconv_full_ref(ampl, phse, cyc_c, hw, eq_re, eq_im, D, nhop,
                               stride)
    B, N, K = ampl.shape
    nq = eq_re.shape[-1]
    if phse.shape != (B, N, K) or cyc_c.shape != (B, N) or hw.shape != (B, N) \
            or eq_re.shape != (B, N, nq) or eq_im.shape != (B, N, nq):
        raise ValueError("deconv_full: shape mismatch")
    ampl, phse, cyc_c, hw = _f32(ampl), _f32(phse), _f32(cyc_c), _f32(hw)
    eq_re, eq_im = _f32(eq_re), _f32(eq_im)
    o_re = torch.empty((B, N, K), dtype=FP, device=ampl.device)
    o_im = torch.empty((B, N, K), dtype=FP, device=ampl.device)
    ptrs = (t.data_ptr()
            for t in (ampl, phse, cyc_c, hw, eq_re, eq_im, o_re, o_im))
    _launch("deconv_full", *ptrs, B, N, K, int(D), int(nhop), int(stride), nq, _stream(ampl))
    return o_re, o_im


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


def deconv_full_ref(ampl, phse, cyc_c, hw, eq_re, eq_im, D, nhop, stride):
    """Plain version of deconv_full (the jnp math of layer0.py:248-299)."""
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


# ---------------------------------------------------------------------------
# 4. noise-band OLA + envelope modulation (pallas_osc.noise_mod_ola_pallas)
# ---------------------------------------------------------------------------

def noise_mod_ola(cyc: torch.Tensor, edc: torch.Tensor, ar: torch.Tensor,
                  ai: torch.Tensor, base: torch.Tensor,
                  segs: torch.Tensor) -> torch.Tensor:
    """Fused noise-band OLA + temporal-envelope modulation + band sum of a
    batch: cyc [B, N*nhop] mod-1 cycle track; edc/base [B, N, C]; ar/ai
    [B, N, C, Ke] (rotated, voicing-masked envelope coefficients);
    segs [B, C, N, 2*nhop] per-band WOLA noise segments -> y [B, N*nhop]
    = sum_c OLA(segs[:, c]) * max(env_c, 0) / max(base_c, 1e-8)."""
    if not _on_cuda(cyc, edc, ar, ai, base, segs):
        return noise_mod_ola_ref(cyc, edc, ar, ai, base, segs)
    B, N, C, Ke = ar.shape
    nhop = segs.shape[-1] // 2
    if cyc.shape != (B, N * nhop) or edc.shape != (B, N, C) \
            or base.shape != (B, N, C) or ai.shape != ar.shape \
            or segs.shape != (B, C, N, 2 * nhop):
        raise ValueError("noise_mod_ola: shape mismatch")
    cyc, edc, ar, ai = _f32(cyc), _f32(edc), _f32(ar), _f32(ai)
    base, segs = _f32(base), _f32(segs)
    y = torch.empty((B, N * nhop), dtype=FP, device=cyc.device)
    ptrs = (t.data_ptr() for t in (cyc, edc, ar, ai, base, segs, y))
    _launch("noise_mod_ola", *ptrs, B, N, nhop, C, Ke, _stream(cyc))
    return y


# ---------------------------------------------------------------------------
# 3. envelope render (pallas_osc.env_render_pallas)
# ---------------------------------------------------------------------------

def env_render(cyc: torch.Tensor, edc: torch.Tensor, ar: torch.Tensor,
               ai: torch.Tensor, base: torch.Tensor, nhop: int | None = None):
    """Per-channel temporal envelopes and their baselines of a batch: cyc
    [B, nx] mod-1 cycle track; edc/base [B, N, C]; ar/ai [B, N, C, Ke]
    (rotated, voicing-masked envelope coefficients) -> (env [B, C, nx]
    = max(lerp(edc) + sum_k lerp(ar) cos(2 pi k cyc) - lerp(ai) sin(...),
    0), base [B, C, nx] = max(lerp(base), 1e-8)); sample t of frame i
    lerps frames i and i + 1, the last frame holds constant.  nx = N*nhop
    unless nhop is given: then nx <= N*nhop (the render is cut)."""
    if not _on_cuda(cyc, edc, ar, ai, base):
        return env_render_ref(cyc, edc, ar, ai, base, nhop)
    B, N, C, Ke = ar.shape
    nx = cyc.shape[-1]
    nhop = nx // max(N, 1) if nhop is None else int(nhop)
    if cyc.shape != (B, nx) or not 0 < nx <= N * nhop \
            or edc.shape != (B, N, C) or base.shape != (B, N, C) \
            or ai.shape != ar.shape:
        raise ValueError("env_render: shape mismatch")
    cyc, edc, ar, ai, base = map(_f32, (cyc, edc, ar, ai, base))
    env = torch.empty((B, C, nx), dtype=FP, device=cyc.device)
    base_o = torch.empty_like(env)
    ptrs = (t.data_ptr() for t in (cyc, edc, ar, ai, base, env, base_o))
    _launch("env_render", *ptrs, B, N, nhop, nx, C, Ke, _stream(cyc))
    return env, base_o


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


def noise_mod_ola_ref(cyc, edc, ar, ai, base, segs):
    """Plain version of noise_mod_ola (layer0.py:1190-1195)."""
    from .harmonics import overlap_add_half
    nhop = segs.shape[-1] // 2
    nx = cyc.shape[-1]
    env, base_s = env_render_ref(cyc, edc, ar, ai, base, nhop)
    y = torch.zeros_like(cyc)
    for c in range(segs.shape[1]):
        band = overlap_add_half(segs[:, c], nhop, nx)
        y = y + band * (env[:, c] / base_s[:, c])
    return y


# ---------------------------------------------------------------------------
# 7./8. track denoiser, pass A and pass B (pallas_osc.denoise_stats_pallas,
#       pallas_osc.denoise_apply_pallas)
# ---------------------------------------------------------------------------

# frames per block of csrc/denoise_stats.cu (its kTile); the FIR halo
# h1 + 2 h2 must stay under it, as under the TPU kernel's frame block
_DENOISE_TILE = 64
_DENOISE_MAX_TAPS = 31
_DENOISE_MAX_K = 128


@functools.lru_cache(maxsize=64)
def _taps32_cached(taps: tuple) -> tuple:
    return tuple(float(t) for t in np.asarray(taps, dtype=np.float32))


def _taps32(taps) -> tuple:
    """FIR taps rounded to float32, as the kernels (and the Pallas kernel's
    Python-float constants) apply them; converted once per tap tuple."""
    return _taps32_cached(taps if isinstance(taps, tuple) else tuple(taps))


@functools.lru_cache(maxsize=64)
def _taps_host(taps32: tuple):
    """The float32 taps as a C array on the host, made once per tap tuple."""
    return (ctypes.c_float * len(taps32))(*taps32)


# ---------------------------------------------------------------------------
# 9. frame-axis FIR (pallas_osc.fir_frames_pallas)
# ---------------------------------------------------------------------------

_FIR_MAX_TAPS = 256


@functools.lru_cache(maxsize=64)
def _taps_on(taps32: tuple, device: torch.device) -> torch.Tensor:
    """The float32 taps as a tensor on `device`, made once per tap tuple."""
    return torch.tensor(taps32, dtype=FP, device=device)


def fir_frames(v, taps):
    """Zero-edged FIR along the frame axis (dim 1) of a batch: v [B, N, ...]
    real or complex (complex runs as its (re, im) pairs), or a pair of
    such tensors with the same leading [B, N]; taps an odd-length sequence
    applied as float32 constants -> out[:, i] = sum_j taps[j]
    v[:, i + j - len(taps) // 2] for each tensor, frames outside [0, N) of
    each utterance zero; a pair gives a pair, filtered in one launch."""
    t = _taps32(taps)
    if not 1 <= len(t) <= _FIR_MAX_TAPS:
        raise ValueError(f"fir_frames: {len(t)} taps (1..{_FIR_MAX_TAPS})")
    vs = (v,) if torch.is_tensor(v) else tuple(v)
    if not 1 <= len(vs) <= 2:
        raise ValueError(f"fir_frames: {len(vs)} tensors (one or a pair)")
    if not _on_cuda(*vs):
        return fir_frames_ref(v, t)
    B, N = vs[0].shape[:2]
    if any(u.shape[:2] != (B, N) for u in vs):
        raise ValueError("fir_frames: tensors of different [B, N]")
    # complex64 storage is its float32 (re, im) pairs: the kernel reads and
    # writes it as float columns, so no view or reshape is needed
    vs = tuple(u if u.dtype in (FP, CP) and u.is_contiguous()
               else u.to(CP if u.is_complex() else FP).contiguous()
               for u in vs)
    outs = tuple(torch.empty_like(u) for u in vs)
    taps_d = _taps_on(t, vs[0].device).data_ptr()
    stream = _stream(vs[0])
    cols = lambda u: u.numel() // max(B * N, 1) * (2 if u.is_complex() else 1)
    args = [a for u, o in zip(vs, outs) for a in (u.data_ptr(), o.data_ptr(),
                                                   cols(u))]
    args += [None, None, 0] * (2 - len(vs))
    _launch("fir_frames", *args, B, N, taps_d, len(t), stream)
    return outs[0] if torch.is_tensor(v) else outs


def fir_frames_ref(v, taps):
    """Plain version of fir_frames: the shift-and-add chain in tap order,
    in float32, on v or each tensor of the pair v."""
    if not torch.is_tensor(v):
        return tuple(fir_frames_ref(u, taps) for u in v)
    h = len(taps) // 2
    out = torch.zeros_like(v)
    for j, t in enumerate(_taps32(taps)):
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


def denoise_stats(a: torch.Tensor, p: torch.Tensor, cyc_c: torch.Tensor,
                  mask: torch.Tensor, voiced: torch.Tensor, taps1, taps2, *,
                  complex_input: bool = False):
    """Pass A of the track denoiser on a batch of utterances: a, p
    [B, N, K] = (ampl, phse), or the raw complex track (re, im) with
    complex_input=True; cyc_c [B, N] mod-1 cycle at the frame centers;
    mask [B, N, K]; voiced [B, N]; taps1 (slow-track FIR) and taps2 (probe
    FIR) odd-length sequences.  Returns (pp, cs2, r2, guard, cre, cim, csr,
    csi): the probe-band incoherent power, |c_s|^2, |c - c_s|^2, the voicing
    guard [B, N] (bool), the aligned track c and its slow part c_s, all
    [B, N, K].  Frames beyond either end of an utterance enter as zeros;
    their intermediates (c_s, r_inc = -c_s) reach the probe FIR of the
    last h2 frames, as in the Pallas kernel."""
    t1, t2 = _taps32(taps1), _taps32(taps2)
    if max(len(t1), len(t2)) > _DENOISE_MAX_TAPS \
            or len(t1) // 2 + 2 * (len(t2) // 2) >= _DENOISE_TILE:
        raise ValueError(f"denoise_stats: {len(t1)} + {len(t2)} taps: at "
                         f"most {_DENOISE_MAX_TAPS} each, their halo h1 + 2 "
                         f"h2 under the {_DENOISE_TILE}-frame tile")
    if not _on_cuda(a, p, cyc_c, mask, voiced):
        return denoise_stats_ref(a, p, cyc_c, mask, voiced, t1, t2,
                                 complex_input=complex_input)
    B, N, K = a.shape
    if p.shape != (B, N, K) or mask.shape != (B, N, K) \
            or cyc_c.shape != (B, N) or voiced.shape != (B, N):
        raise ValueError("denoise_stats: shape mismatch")
    if K > _DENOISE_MAX_K:
        raise ValueError(f"denoise_stats: K = {K} > {_DENOISE_MAX_K}")
    a, p, cyc_c, mask, voiced = map(_f32, (a, p, cyc_c, mask, voiced))
    dev = a.device
    # the five outputs that live through pass B as views of one allocation;
    # the two powers apart, so they free after the floor statistics
    pp, cre, cim, csr, csi = torch.empty((5, B, N, K), dtype=FP,
                                         device=dev).unbind(0)
    cs2, r2 = (torch.empty((B, N, K), dtype=FP, device=dev)
               for _ in range(2))
    gd = torch.empty((B, N), dtype=torch.bool, device=dev)
    ptrs = (t.data_ptr() for t in (a, p, cyc_c, mask, voiced, pp, cs2, r2,
                                   gd, cre, cim, csr, csi))
    _launch("denoise_stats", *ptrs, B, N, K,
            ctypes.addressof(_taps_host(t1)), len(t1),
            ctypes.addressof(_taps_host(t2)), len(t2), int(complex_input),
            _stream(a))
    return pp, cs2, r2, gd, cre, cim, csr, csi


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


def denoise_apply(cre: torch.Tensor, cim: torch.Tensor, csr: torch.Tensor,
                  csi: torch.Tensor, cyc_c: torch.Tensor, mask: torch.Tensor,
                  guard: torch.Tensor, v: torch.Tensor, wmul: torch.Tensor,
                  strength: float, *, emit_resid: bool = False):
    """Pass B of the track denoiser: pass A's aligned track (cre, cim) and
    slow track (csr, csi) [B, N, K], cyc_c [B, N], mask [B, N, K], guard
    [B, N], the per-utterance floor v and fit weights wmul [B, K] -> the
    gated, un-aligned complex harmonics (re, im) [B, N, K]: the coherent
    fit weighted by wmul, the Wiener gate g = clip(1 - strength v /
    |r_inc|^2, 0, 1) on the incoherent residual, the raw track where the
    guard fails.  emit_resid=True also returns where(guard, c_s + r_inc,
    0) as (full_r, full_i) and the un-align factors (ur, ui)."""
    if not _on_cuda(cre, cim, csr, csi, cyc_c, mask, guard, v, wmul):
        return denoise_apply_ref(cre, cim, csr, csi, cyc_c, mask, guard, v,
                                 wmul, strength, emit_resid=emit_resid)
    B, N, K = cre.shape
    if any(t.shape != (B, N, K) for t in (cim, csr, csi, mask)) \
            or cyc_c.shape != (B, N) or guard.shape != (B, N) \
            or v.shape != (B, K) or wmul.shape != (B, K):
        raise ValueError("denoise_apply: shape mismatch")
    ins = tuple(map(_f32, (v, wmul, cre, cim, csr, csi, cyc_c, mask, guard)))
    outs = tuple(torch.empty((B, N, K), dtype=FP, device=cre.device)
                 for _ in range(6 if emit_resid else 2))
    ptrs = [t.data_ptr() for t in ins + outs] + [None] * (6 - len(outs))
    _launch("denoise_apply", *ptrs, B, N, K, float(strength),
            int(emit_resid), _stream(cre))
    return outs


def denoise_apply_ref(cre, cim, csr, csi, cyc_c, mask, guard, v, wmul,
                      strength, *, emit_resid=False):
    """Plain version of denoise_apply (_denoise_apply_body and its two
    kernels, pallas_osc.py:1043-1139)."""
    g = (guard if guard.dtype == torch.bool else guard > 0.5)[..., None]
    rcr, rci, rir, rii = _coherent_fit(cre, cim, csr, csi,
                                       wmul[:, None, :] * mask)
    pw = rir * rir + rii * rii
    gain = torch.clamp(1.0 - strength * v[:, None, :] / (pw + 1e-20),
                       0.0, 1.0)
    outr = torch.where(g, csr + rcr + gain * rir, cre)
    outi = torch.where(g, csi + rci + gain * rii, cim)
    kh = torch.arange(1, cre.shape[-1] + 1, dtype=FP, device=cre.device)
    ua = 2.0 * math.pi * _phase_cycles(kh, cyc_c[..., None])
    ur, ui = torch.cos(ua), torch.sin(ua)
    out = (outr * ur - outi * ui, outr * ui + outi * ur)
    if not emit_resid:
        return out
    zero = torch.zeros_like(csr)
    return out + (torch.where(g, csr + rir, zero),
                  torch.where(g, csi + rii, zero), ur, ui)


# ---------------------------------------------------------------------------
# noise spectra keyed by frame (the port's counterpart of jax.random, which
# XLA draws with its own built-in kernel; no Pallas kernel)
# ---------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
# XLA's float32 erf_inv: M. Giles' polynomials in w = -log1p(-u^2) - 2.5
# (w < 5) and sqrt(w) - 3 (w >= 5), highest power first
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
                   device=None, *, bits: bool = False):
    """Plain version of noise_bins: threefry in int64 tensors masked to 32
    bits.  bits=True also returns the two [N, nbin] int32 bit tensors (the
    uint32 draws, wrapped) that the normals come from."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    i64 = dict(dtype=torch.int64, device=dev)
    frame = (frame_base + torch.arange(N, **i64)) & _U32
    zero = torch.zeros_like(frame)
    # fold_in(PRNGKey(seed), frame), then split: the key pair of each draw
    f0, f1 = _threefry(0, int(seed) & _U32, zero, frame)
    keys = [_threefry(f0, f1, zero, zero + j) for j in (0, 1)]
    col = torch.arange(nbin, **i64)[None, :]
    out, raw = [], []
    for k0, k1 in keys:
        b0, b1 = _threefry(k0[:, None], k1[:, None], torch.zeros_like(col),
                           col)
        raw.append(b0 ^ b1)
        out.append(_normal_from_bits(raw[-1]).expand(B, N, nbin))
    if bits:
        return tuple(out) + tuple(r.to(torch.int32) for r in raw)
    return tuple(out)


def noise_bins(seed: int, frame_base: int, B: int, N: int, nbin: int,
               device, *, bits: bool = False):
    """Standard-normal noise spectra of frames [frame_base, frame_base + N),
    drawn as the JAX package draws them (layer0._synth_noise): frame f's
    (re, im) bins are jax.random.normal(kr, (nbin,)) and normal(ki,
    (nbin,)) with kr, ki = split(fold_in(PRNGKey(seed), f)), threefry-2x32
    partitionable.  The bits are JAX's exactly; the normals within an ulp
    of its float32 erf_inv.  No batch row changes the draw, so (re, im) are
    one [N, nbin] draw each, expanded (not copied) to [B, N, nbin].
    device "cpu" runs noise_bins_ref; a CUDA device launches the kernel."""
    device = torch.device(device)
    if device.type == "cpu":
        return noise_bins_ref(seed, frame_base, B, N, nbin, device, bits=bits)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if N < 0 or nbin < 0 or not 0 <= frame_base <= _U32 - N:
        raise ValueError("noise_bins: bad frame range or bin count")
    out = [torch.empty((N, nbin), dtype=FP, device=device) for _ in range(2)]
    if bits:
        out += [torch.empty((N, nbin), dtype=torch.int32, device=device)
                for _ in range(2)]
    ptrs = [t.data_ptr() for t in out] + [None] * (4 - len(out))
    _launch("noise_bins", *ptrs, int(seed) & _U32, int(frame_base), N, nbin,
            torch.cuda.current_stream(device).cuda_stream)
    return tuple(t.expand(B, N, nbin) for t in out[:2]) + tuple(out[2:])


# ---------------------------------------------------------------------------
# 10. chirped projection of pre-windowed frames
#     (pallas_osc.harmonic_project_pallas)
# ---------------------------------------------------------------------------

def harmonic_project(dc: torch.Tensor, xw: torch.Tensor, max_k: int,
                     lo: torch.Tensor | None = None,
                     hi: torch.Tensor | None = None):
    """Projection of windowed frames onto the chirped harmonic basis: dc,
    xw [R, W]; lo, hi [R] (optional) each row's live columns [lo, hi),
    outside which xw must be zero -> (re [R, K], im [R, K]) with re + j im
    = sum_w xw e^{-2 pi j (k+1) dc}.  dc is any representative of the
    cycle offset."""
    R, W = dc.shape
    dev = dc.device
    if lo is None or hi is None:
        lo = torch.zeros((R,), dtype=torch.int32, device=dev)
        hi = torch.full((R,), W, dtype=torch.int32, device=dev)
    if not _on_cuda(dc, xw, lo, hi):
        return harmonic_project_ref(dc, xw, max_k, lo, hi)
    if xw.shape != (R, W) or lo.shape != (R,) or hi.shape != (R,):
        raise ValueError("harmonic_project: shape mismatch")
    dc, xw, lo, hi = _f32(dc), _f32(xw), _i32(lo), _i32(hi)
    re = torch.empty((R, max_k), dtype=FP, device=dev)
    im = torch.empty((R, max_k), dtype=FP, device=dev)
    ptrs = (t.data_ptr() for t in (dc, xw, lo, hi, re, im))
    _launch("harmonic_project", *ptrs, R, W, max_k, _stream(dc))
    return re, im


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
        re[s:s + step] = torch.einsum("nkw,nw->nk", torch.cos(arg),
                                      xw[s:s + step])
        im[s:s + step] = torch.einsum("nkw,nw->nk", -torch.sin(arg),
                                      xw[s:s + step])
    return re, im


# ---------------------------------------------------------------------------
# 6. unframed banded projection (pallas_osc.harmonic_project_mxu)
# ---------------------------------------------------------------------------

def harmonic_project_mxu(x: torch.Tensor, cyc: torch.Tensor, hw: torch.Tensor,
                         max_k: int, nhop: int, hh: int, *,
                         window: str = "hanning"):
    """Chirped projection at uniform centers f*nhop without frame buffers:
    x, cyc [B, nx] the signal and its absolute mod-1 cycle track (unframed);
    hw [B, N] the window halfwidths; hh the window reach in whole hops ->
    (re [B, N, K], im [B, N, K], wsum [B, N], xsum [B, N]) with
    re + j im = sum_n w_f(n) x(n) e^{-2 pi j (k+1) cyc(n)} (NOT relative to
    the frame center: the caller rotates by e^{+2 pi j (k+1) cyc_c}),
    wsum = sum_n w_f(n) and xsum = sum_n w_f(n) x(n).  w_f is the
    cosine-series `window` of halfwidth hw centred at f*nhop, cut at
    |n - f nhop| <= hh*nhop; x is zero outside each utterance."""
    if window not in COSINE_SERIES:
        raise ValueError(f"harmonic_project_mxu: {window!r} is not a "
                         "cosine-series window")
    if not _on_cuda(x, cyc, hw):
        return harmonic_project_mxu_ref(x, cyc, hw, max_k, nhop, hh,
                                        window=window)
    B, nx = x.shape
    N = hw.shape[-1]
    if cyc.shape != (B, nx) or hw.shape != (B, N):
        raise ValueError("harmonic_project_mxu: shape mismatch")
    coefs = tuple(float(c) for c in COSINE_SERIES[window]) + (0.0,) * 3
    x, cyc, hw = _f32(x), _f32(cyc), _f32(hw)
    dev = x.device
    re = torch.empty((B, N, max_k), dtype=FP, device=dev)
    im = torch.empty((B, N, max_k), dtype=FP, device=dev)
    ws = torch.empty((B, N), dtype=FP, device=dev)
    xs = torch.empty((B, N), dtype=FP, device=dev)
    ptrs = (t.data_ptr() for t in (x, cyc, hw, re, im, ws, xs))
    _launch("harmonic_project_mxu", *ptrs, B, nx, N, max_k, int(nhop),
            int(hh) * int(nhop), *coefs[:4], len(COSINE_SERIES[window]),
            _stream(x))
    return re, im, ws, xs


def harmonic_project_mxu_ref(x, cyc, hw, max_k, nhop, hh, *,
                             window="hanning"):
    """Plain version of harmonic_project_mxu: the modulated rows G = [1, x,
    x cos(2 pi k cyc), -x sin(2 pi k cyc)] over each frame chunk's span
    (x zero-padded, cyc edge-padded by hh*nhop per utterance), contracted
    with the chunk's window rows by torch.einsum in float32."""
    B, nx = x.shape
    N = hw.shape[-1]
    P = hh * nhop
    dev = x.device
    xp = torch.nn.functional.pad(x.to(FP), (P, P))
    cp = torch.cat([cyc[:, :1].expand(B, P), cyc, cyc[:, -1:].expand(B, P)],
                   dim=-1).to(FP)
    kh = torch.arange(1, max_k + 1, dtype=FP, device=dev)
    out = torch.empty((B, N, 2 * max_k + 2), dtype=FP, device=dev)
    FC = max(1, min(N, _REF_ELEMS // (B * (2 * max_k + 2) * (nhop + 2 * P))))
    for f0 in range(0, N, FC):
        f1 = min(N, f0 + FC)
        L = (f1 - 1 - f0) * nhop + 2 * P + 1
        s0 = f0 * nhop                        # padded index of the span start
        xs, cs = xp[:, s0:s0 + L], cp[:, s0:s0 + L]
        ang = 2.0 * math.pi * _phase_cycles(kh, cs[..., None])  # [B, L, K]
        G = torch.cat([torch.ones_like(xs)[..., None], xs[..., None],
                       xs[..., None] * torch.cos(ang),
                       -xs[..., None] * torch.sin(ang)], dim=-1)
        off = (torch.arange(L, device=dev)[None, :]
               - (torch.arange(f1 - f0, device=dev)[:, None] * nhop + P))
        w = window_centered(window, off.to(FP), hw[:, f0:f1, None])
        w = w * (off.abs() <= P)                   # [B, FC, L]
        out[:, f0:f1] = torch.einsum("bfs,bsc->bfc", w, G)
    K = max_k
    return (out[..., 2:2 + K].contiguous(), out[..., 2 + K:].contiguous(),
            out[..., 0].contiguous(), out[..., 1].contiguous())
