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
from fractions import Fraction

import numpy as np
import torch

from ..fp import CP, FP, FP64
from . import _build
from .windows import COSINE_SERIES, window_centered

LAUNCHES = {"osc_bank": 0, "harmonic_project_win": 0, "deconv_full": 0,
            "noise_mod_ola": 0, "noise_mod_ola_seg": 0, "denoise_stats": 0, "denoise_apply": 0,
            "denoise_finish": 0,
            "harmonic_project": 0, "harmonic_project_mxu": 0,
            "fir_frames": 0, "env_render": 0, "noise_bins": 0,
            "sample_cycles": 0, "refine_f0_dec": 0, "refine_f0_full": 0,
            "viterbi_scan": 0}

# frames per chunk of the plain versions: bounds their [frames, K, T]
# temporaries to ~64 MB at any input size
_REF_ELEMS = 1 << 24


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cuda(*ts: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU ones; raises otherwise, on a
    device mismatch, or under LLSM_FP64=1 on float64 input."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} "
                             f"vs {dev}")
    if FP64 and any(t.dtype in (torch.float64, torch.complex128) for t in ts):
        # on the CPU too: the plain versions are the kernels' float32 twins
        raise TypeError("the CUDA kernels are float32: under LLSM_FP64=1 "
                        "the plain branches run instead (use_pallas=False)")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _aligned(t: torch.Tensor, nbytes: int = 16) -> torch.Tensor:
    """t, or a copy of it where its data does not start on an nbytes
    boundary (a view with an offset): for kernels that load vectors."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


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

# harmonic_project_win.cu: the 16-frame tile (proj_win_kernel) stages its
# span, 15 nhop + 2 C samples of x and of cyc, in shared memory beside its
# 16 frame records, where two such blocks fit an SM; elsewhere
# proj_win_warp_kernel, a warp a frame and two a block, stages its frame's
# live columns through two buffers of Q columns (x and cyc: 16 Q bytes a
# warp): 1792 where the harmonics' rotations make a column long (the most
# that leaves room for the four blocks an SM its registers allow: a chunk
# boundary costs a column's setup), 512 at K <= 8, where a short walk
# would wait on a long first chunk
_PROJ_TILE = 16
_PROJ_STATIC = 16 * 16
_PROJ_WARP_WARPS = 2
_PROJ_CHUNK = 1792
_PROJ_CHUNK_FEW = 512


@functools.lru_cache(maxsize=64)
def _proj_win_geometry(nhop: int, C: int, K: int) -> tuple:
    """harmonic_project_win's launch at hop nhop, center column C and K
    harmonics -> (F frames a block, Q columns a chunk, dynamic shared
    bytes): the 16-frame tile (F 16, Q 0) where its span's 8 (15 nhop + 2
    C) bytes beside the frame records leave room for two blocks an SM
    (_two_an_sm); elsewhere the warp kernel (F 0), its chunks of Q =
    _PROJ_CHUNK columns (_PROJ_CHUNK_FEW at K <= 8), 16 Q bytes a warp."""
    smem = 8 * ((_PROJ_TILE - 1) * nhop + 2 * C)
    if _two_an_sm(smem + _PROJ_STATIC):
        return _PROJ_TILE, 0, smem
    Q = _PROJ_CHUNK_FEW if K <= 8 else _PROJ_CHUNK
    return 0, Q, 16 * _PROJ_WARP_WARPS * Q


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
    live).  No [Bx N, 2 center] frame buffer is built on the card: a tile
    of 16 frames staged in shared memory, or a warp a frame staging its
    live columns in chunks (_proj_win_geometry), any nhop and center."""
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
    F, Q, _ = _proj_win_geometry(int(nhop), int(center), int(max_k))
    _launch("harmonic_project_win", *ptrs, Bx, Bx // Bc, nx, N, max_k,
            int(nhop), int(center), *coefs[:4], len(COSINE_SERIES[window]),
            F, Q, _stream(x))
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

_SMEM_MAX = 227 * 1024       # the H100's shared memory a block, opted in


def _deconv_smem(D: int, K: int, nq: int) -> int:
    """deconv_full.cu's first kernel's shared memory a block: the 2 D + 1
    float4 taps of its 64 frames, 64 + 2 D halo rows of max(K, nq) float2,
    and a float a halo row and a quadrature point."""
    FH = 64 + 2 * D
    return 64 * (2 * D + 1) * 16 + FH * max(K, nq) * 8 + (FH + nq) * 4


# deconv_full.cu's wide path: the output kernel's frame tiles (8 warps of
# KF frames) tried in order, its widest chunk of columns (32 lanes of two),
# the narrowest chunk taken before a smaller frame tile, and the bytes a
# block that leave room for two blocks an SM (the H100's 228 KiB an SM, 1
# KiB of each block's reserved)
_DECONV_TILES = (64, 32, 16, 8)
_DECONV_MAX_KC = 64
_DECONV_MIN_KC = 16
_SMEM_TWO = 228 * 1024 // 2 - 1024


def _deconv_wide_smem(FT: int, D: int, KC: int) -> int:
    """deconv_full.cu's wide output kernel's shared memory a block: the
    taps [FT, 2 D + 1] float4 of its FT frames, its chunk of KC columns
    with a halo column each side [FH, KC + 4] float2 (FH = FT + 2 D), and
    a float a halo row."""
    FH = FT + 2 * D
    return FT * (2 * D + 1) * 16 + FH * (KC + 4) * 8 + FH * 4


def _deconv_taps_tile(D: int, nq: int):
    """deconv_full.cu's tap build (the wide path's first launch) -> (TT
    frames a block, stage, shared bytes): the first tile of _DECONV_TILES
    whose unscaled taps [TT, 2 D + 1] float4 and crossfade [nq] float fit
    a block, with the quadrature field [TT + 2 D, nq + 1] float2 staged
    beside them (stage 1) where it fits too, else computed by the tap
    build; None where no tile fits."""
    nb = 2 * D + 1
    for TT in _DECONV_TILES:
        fixed = TT * nb * 16 + nq * 4
        field = (TT + 2 * D) * (nq + 1) * 8
        if fixed + field <= _SMEM_MAX:
            return TT, 1, fixed + field
        if fixed <= _SMEM_MAX:
            return TT, 0, fixed
    return None


def _deconv_geometry(D: int, K: int, nq: int):
    """deconv_full.cu's launch for a band of D frames, K harmonics and nq
    quadrature points -> (FT frames a block, KC columns a chunk, chunks,
    shared bytes, TT frames a tap-build block, stage), which the wrapper
    passes to the C entry.  The first kernel (FT = 64, KC = 0, one chunk;
    TT = stage = 0) where its block fits the H100's shared memory
    (_deconv_smem); else the wide path: the taps built into device memory
    (_deconv_taps_tile), then the output kernel at the first frame tile of
    _DECONV_TILES whose block with a chunk of at least min(K, 16) columns
    fits in _SMEM_TWO bytes (two blocks an SM), else in the block's whole
    shared memory; KC the widest even chunk that fits, at most 64, then
    evened out over the chunks (K = 600: 10 chunks of 60, K = 200 at D =
    26: 4 of 50).  None where nothing fits (a band far past D = 128)."""
    smem = _deconv_smem(D, K, nq)
    if smem <= _SMEM_MAX:
        return 64, 0, 1, smem, 0, 0
    tt = _deconv_taps_tile(D, nq)
    if tt is None:
        return None
    for budget in (_SMEM_TWO, _SMEM_MAX):
        for FT in _DECONV_TILES:
            FH = FT + 2 * D
            room = (budget - _deconv_wide_smem(FT, D, 0)) // (8 * FH)
            kc = min(_DECONV_MAX_KC, K + K % 2, room // 2 * 2)
            if kc < max(2, min(K, _DECONV_MIN_KC)):
                continue
            n = -(-K // kc)
            KC = -(-K // n)
            KC += KC % 2
            return FT, KC, n, _deconv_wide_smem(FT, D, KC), *tt[:2]
    return None


def deconv_full(ampl: torch.Tensor, phse: torch.Tensor, cyc: torch.Tensor,
                hw: torch.Tensor, mask: torch.Tensor, D: int, nhop: int,
                stride: int, *, return_complex: bool = True):
    """Fused amplitude-track deconvolution of a batch of utterances:
    ampl/phse [B, N, K] (masked), cyc [B, N*nhop] the mod-1 cycle track,
    hw [B, N] (window halfwidth), mask [B, N, K] -> the corrected complex
    harmonics in the absolute-phase domain, times the mask: (re, im), or
    with return_complex=False (|c|, angle c) [B, N, K].  The kernel reads
    the cycle track at each frame's center and at the stride-quadrature
    points of its hop pair (edge-clamped, as frame_hops(mode="edge")).
    Frames beyond either end of an utterance are zero.  Any K and any D up
    to 128 (the JAX branch's band) run on the card: past the first
    kernel's shared memory the wide path chunks K (_deconv_geometry): its
    taps go through a device scratch [B, N rounded up to 64, 2 D + 1]
    float4, allocated here."""
    if not _on_cuda(ampl, phse, cyc, hw, mask):
        return deconv_full_ref(ampl, phse, cyc, hw, mask, D, nhop, stride,
                               return_complex=return_complex)
    B, N, K = ampl.shape
    if phse.shape != (B, N, K) or mask.shape != (B, N, K) \
            or cyc.shape != (B, N * nhop) or hw.shape != (B, N):
        raise ValueError("deconv_full: shape mismatch")
    if not (D >= 0 and 0 < stride <= 2 * nhop):
        raise ValueError(f"deconv_full: D = {D}, stride {stride}")
    geo = _deconv_geometry(D, K, 2 * nhop // stride)
    if geo is None:
        raise ValueError(f"deconv_full: D = {D}: no frame tile's taps and "
                         "chunk of columns fit a block's shared memory "
                         f"({_SMEM_MAX} B)")
    ampl, phse, cyc, hw, mask = map(_f32, (ampl, phse, cyc, hw, mask))
    o_a = torch.empty((B, N, K), dtype=FP, device=ampl.device)
    o_b = torch.empty((B, N, K), dtype=FP, device=ampl.device)
    taps = None if not geo[1] else torch.empty(
        (B, -(-N // 64) * 64, 2 * D + 1, 4), dtype=FP, device=ampl.device)
    ptrs = [t.data_ptr() for t in (ampl, phse, cyc, hw, mask, o_a, o_b)]
    _launch("deconv_full", *ptrs, None if taps is None else taps.data_ptr(),
            B, N, K, int(D), int(nhop), int(stride), int(not return_complex),
            *(int(g) for g in geo[:2] + geo[4:]), _stream(ampl))
    return o_a, o_b


def deconv_full_ref(ampl, phse, cyc, hw, mask, D, nhop, stride, *,
                    return_complex=True):
    """Plain version of deconv_full: the quadrature field e^{2 pi j cyc}
    from frame_hops(mode="edge") and the centre cycles sliced from the
    track, the banded step (_deconv_step), then the mask and, for the
    polar track, sqrt / atan2 (the JAX caller, layer0.py:229-246)."""
    from .harmonics import frame_hops
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


# ---------------------------------------------------------------------------
# 4. noise-band OLA + envelope modulation (pallas_osc.noise_mod_ola_pallas)
# ---------------------------------------------------------------------------

# noise_mod_ola.cu's first kernel: nhop <= 256, C <= 8, Ke <= 8, 16 frames a
# block; past it the wide kernel, 16 frames a block of up to 256 threads,
# where that block leaves room for two an SM; elsewhere the long kernel, 16
# frames a block of 128 threads, 4 columns each, with chunks of the first
# of _NOISE_CHUNKS slots whose block leaves room for two an SM (64 where
# none does and one fits)
_NOISE_MAX_C = 8
_NOISE_MAX_KE = 8
_NOISE_MAX_HOP = 256
_NOISE_WIDE_THREADS = 256
_NOISE_CHUNKS = (64, 48, 32, 16)
_NOISE_LONG_THREADS = 128
_NOISE_LONG_COLS = 4
_SM_SMEM = 233472            # the H100's shared memory an SM (228 KB)
_BLOCK_RESERVED = 1024       # what the card keeps of it for each block


def _two_an_sm(nbytes: int) -> bool:
    """Whether two blocks of nbytes shared bytes fit an SM."""
    return 2 * (nbytes + _BLOCK_RESERVED) <= _SM_SMEM


@functools.lru_cache(maxsize=64)
def _noise_geometry(nhop: int, C: int, Ke: int, bands: tuple) -> tuple:
    """noise_mod_ola.cu's launch -> (F, the frames a block, 0 for the first
    kernel; L, the staged slots a frame; shared bytes; threads a block, 0
    for the first kernel; the long kernel's slots a chunk, 0 for the
    others).  L sums each band's slots, from its first even bin, an even
    count (band_ranges' [lo, hi) each).  The first kernel (16 frames)
    where nhop <= 256, C <= 8 and Ke <= 8: the staged spectra [16, L] and
    (E, O) [16, C, nhop] float2, the three [2 nhop] tables, the
    coefficients [16, 2 C (Ke + 1)] floats and the slots' bins [L] ints.
    Else the wide kernel (16 frames) where its block leaves room for two an
    SM: a thread a sample pair of every frame (threads: the pairs rounded
    up to a warp, at most 256, each thread looping past them), the spectra
    [L / 2, 17] float4 (slot pairs, a pad frame), the tables, the y
    accumulators [15, 2, threads], the coefficients, the slots' bins and
    the band table [5, C] ints.  Elsewhere the long kernel (16 frames, a
    block 128 threads of 4 columns, the tables and staged spectra in device
    memory) with chunks of LC slots, the first of _NOISE_CHUNKS whose block
    leaves room for two an SM (64 where none does): two chunk buffers [LC /
    2, 17] float4, e^{2 pi j cyc} [15, 4, 128] float2, the accumulators
    [15, 4, 128], the coefficients and the band table; None where its block
    overflows (the coefficients past ~C (Ke + 1) 950)."""
    L = sum((hi - (lo & ~1) + 1) & ~1 if hi > lo else 0
            for lo, hi in zip(bands[::2], bands[1::2]))
    if nhop <= _NOISE_MAX_HOP and C <= _NOISE_MAX_C and Ke <= _NOISE_MAX_KE:
        return (0, L, 8 * 16 * L + 8 * 16 * C * nhop + 12 * 2 * nhop
                + 4 * 16 * 2 * C * (Ke + 1) + 4 * L, 0, 0)
    threads = min(_NOISE_WIDE_THREADS, -(-((nhop + 1) // 2) // 32) * 32)
    wide = (8 * 17 * L + 12 * 2 * nhop + 4 * 15 * 2 * threads
            + 4 * 16 * 2 * C * (Ke + 1) + 4 * (L + 5 * C))
    if _two_an_sm(wide):
        return 16, L, wide, threads, 0

    def long_bytes(LC):
        return (16 * LC * 17
                + 12 * 15 * _NOISE_LONG_COLS * _NOISE_LONG_THREADS
                + 4 * 16 * 2 * C * (Ke + 1) + 4 * 5 * C)
    LC = next((n for n in _NOISE_CHUNKS if _two_an_sm(long_bytes(n))),
              _NOISE_CHUNKS[0])
    if long_bytes(LC) > _SMEM_MAX:
        return None
    return 16, L, long_bytes(LC), _NOISE_LONG_THREADS, LC


def _noise_long_floats(B: int, N: int, nhop: int, L: int) -> int:
    """The long kernel's scratch in floats: the tables [3, 2 nhop], then
    (16-byte aligned) the staged spectra [B, N, L / 2] float4."""
    return -(-6 * nhop // 4) * 4 + B * N * (L // 2) * 4


@functools.lru_cache(maxsize=32)
def _bands_on(bands: tuple, device: torch.device) -> torch.Tensor:
    """The band ranges as int32 on `device`, made once per tuple."""
    return torch.tensor(bands, dtype=torch.int32, device=device)


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


def noise_mod_ola(cyc: torch.Tensor, edc: torch.Tensor, ar: torch.Tensor,
                  ai: torch.Tensor, base: torch.Tensor, re: torch.Tensor,
                  im: torch.Tensor, gain: torch.Tensor,
                  bands: tuple) -> torch.Tensor:
    """The noise part of a batch from its spectra: cyc [B, N*nhop] mod-1
    cycle track; edc/base [B, N, C]; ar/ai [B, N, C, Ke] (rotated,
    voicing-masked envelope coefficients); re, im [B, N, nbin] the
    standard-normal spectra (one draw expanded to the batch, or a draw a
    row), gain [B, N, nbin] the shaping gain, nbin = nhop + 1; bands each
    band's bins [lo, hi) as 2 C ints (band_ranges) -> y [B, N*nhop] = sum_c OLA(seg_c) max(env_c, 0) /
    max(base_c, 1e-8), seg_c each frame's windowed inverse real DFT of its
    band's bins of (re scale, im scale') x gain (DC and Nyquist real).  One
    launch on the card (two where the long kernel runs: its staging of the
    pre-scaled spectra first; any nhop, and any C and Ke whose frames'
    coefficients fit in shared memory: _noise_geometry); no [B, C, N, 2
    nhop] segment buffer and, past the first kernel, no (E, O) buffer.
    Where the long kernel's staged spectra exceed the card's free memory,
    ValueError."""
    bands = tuple(int(v) for v in bands)
    if not _on_cuda(cyc, edc, ar, ai, base, re, im, gain):
        return noise_mod_ola_ref(cyc, edc, ar, ai, base, re, im, gain, bands)
    B, N, C, Ke = ar.shape
    nbin = gain.shape[-1]
    nhop = nbin - 1
    if cyc.shape != (B, N * nhop) or edc.shape != (B, N, C) \
            or base.shape != (B, N, C) or ai.shape != ar.shape \
            or gain.shape != (B, N, nbin) or re.shape != gain.shape \
            or im.shape != gain.shape or len(bands) != 2 * C:
        raise ValueError("noise_mod_ola: shape mismatch")
    if not all(0 <= lo <= hi <= nbin for lo, hi in zip(bands[::2],
                                                        bands[1::2])):
        raise ValueError(f"noise_mod_ola: band ranges {bands} outside "
                         f"0..{nbin}")
    geo = _noise_geometry(nhop, C, Ke, bands) if nhop >= 1 and C >= 1 \
        else None
    if geo is None:
        raise ValueError(f"noise_mod_ola: nhop {nhop}, C {C}, Ke {Ke}: the "
                         "envelope coefficients of 16 frames overflow "
                         "shared memory")
    # one draw for the whole batch keeps its [N, nbin] storage: batch
    # stride 0; otherwise a draw a row
    if B > 1 and re.stride(0) == 0 and im.stride(0) == 0:
        spec, bstride = (_f32(re[0]), _f32(im[0])), 0
    else:
        spec, bstride = (_f32(re), _f32(im)), N * nbin
    cyc, edc, ar, ai, base, gain = map(_f32, (cyc, edc, ar, ai, base, gain))
    y = torch.empty((B, N * nhop), dtype=FP, device=cyc.device)
    ranges = (ctypes.c_int * (2 * C))(*bands)       # read at the launch
    ranges_d = _bands_on(bands, cyc.device).data_ptr() if geo[0] else None
    # the long kernel's scratch, written by its first launch
    tab = None
    if geo[4]:
        n = _noise_long_floats(B, N, nhop, geo[1])
        try:
            tab = torch.empty((n,), dtype=FP, device=cyc.device)
        except torch.cuda.OutOfMemoryError:
            raise ValueError(
                f"noise_mod_ola: the staged spectra [{B}, {N}, "
                f"{geo[1] // 2}] float4 and tables ({4 * n} bytes) exceed "
                "the card's free memory: split the batch") from None
    _launch("noise_mod_ola", cyc.data_ptr(), edc.data_ptr(), ar.data_ptr(),
            ai.data_ptr(), base.data_ptr(), spec[0].data_ptr(),
            spec[1].data_ptr(), bstride, gain.data_ptr(),
            ctypes.addressof(ranges), ranges_d, y.data_ptr(), B, N, nhop, C,
            Ke, geo[0], geo[3], geo[4], None if tab is None else
            tab.data_ptr(), _stream(cyc))
    return y


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
    return (torch.einsum("znb,cbt->zcnt", shaped_spec.real, cos_c)
            - torch.einsum("znb,cbt->zcnt", shaped_spec.imag, sin_c))


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


def noise_mod_ola_seg(cyc: torch.Tensor, edc: torch.Tensor, ar: torch.Tensor,
                      ai: torch.Tensor, base: torch.Tensor,
                      segs: torch.Tensor) -> torch.Tensor:
    """The noise part of a batch from given windowed band segments (the
    noise_idft="fft" path): cyc [B, N*nhop]; edc/base [B, N, C]; ar/ai
    [B, N, C, Ke] as noise_mod_ola takes them; segs [B, C, N, 2 nhop] ->
    y [B, N*nhop] = sum_c OLA(segs[:, c]) max(env_c, 0) / max(base_c,
    1e-8).  One launch on the card."""
    if not _on_cuda(cyc, edc, ar, ai, base, segs):
        return noise_mod_ola_seg_ref(cyc, edc, ar, ai, base, segs)
    B, N, C, Ke = ar.shape
    T = segs.shape[-1]
    nhop = T // 2
    if cyc.shape != (B, N * nhop) or edc.shape != (B, N, C) \
            or base.shape != (B, N, C) or ai.shape != ar.shape \
            or segs.shape != (B, C, N, T) or T != 2 * nhop:
        raise ValueError("noise_mod_ola_seg: shape mismatch")
    if C < 1 or 4 * 16 * 2 * C * (Ke + 1) > _SMEM_MAX:
        raise ValueError(f"noise_mod_ola_seg: C {C}, Ke {Ke}: the "
                         "coefficients of 16 frames overflow shared memory")
    cyc, edc, ar, ai, base, segs = map(_f32, (cyc, edc, ar, ai, base, segs))
    # 16-byte loads of the cycle track and the segments where nhop % 4 == 0
    cyc, segs = _aligned(cyc), _aligned(segs)
    y = torch.empty((B, N * nhop), dtype=FP, device=cyc.device)
    ptrs = (t.data_ptr() for t in (cyc, edc, ar, ai, base, segs, y))
    _launch("noise_mod_ola_seg", *ptrs, B, N, nhop, C, Ke, _stream(cyc))
    return y


def noise_mod_ola_seg_ref(cyc, edc, ar, ai, base, segs):
    """Plain version of noise_mod_ola_seg: each band's OLA times its
    envelope over its baseline (layer0.py:1190-1195), the envelopes by
    env_render_ref."""
    from .harmonics import overlap_add_half
    nhop = segs.shape[-1] // 2
    env, base_s = env_render_ref(cyc, edc, ar, ai, base, nhop)
    y = torch.zeros_like(cyc)
    for c in range(segs.shape[1]):
        band_y = overlap_add_half(segs[:, c], nhop, cyc.shape[-1])
        y = y + band_y * (env[:, c] / base_s[:, c])
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
    unless nhop is given: then nx <= N*nhop (the render is cut).  Ke <= 8
    takes env_render.cu's first kernel (one rotation ladder a sample for
    every channel), more its wide kernel (the ladder once a sample for
    every 4 or 8 channels, a rotation at a time; runs of 4 samples a
    thread; tiles of 64, 32 or 16 frames), every output the bits of the
    wide kernel it replaced."""
    if not _on_cuda(cyc, edc, ar, ai, base):
        return env_render_ref(cyc, edc, ar, ai, base, nhop)
    B, N, C, Ke = ar.shape
    nx = cyc.shape[-1]
    nhop = nx // max(N, 1) if nhop is None else int(nhop)
    if cyc.shape != (B, nx) or not 0 < nx <= N * nhop \
            or edc.shape != (B, N, C) or base.shape != (B, N, C) \
            or ai.shape != ar.shape:
        raise ValueError("env_render: shape mismatch")
    if Ke < 1 or 4 * 2 * 33 * C * (Ke + 1) > _SMEM_MAX:
        raise ValueError(f"env_render: C {C}, Ke {Ke}: at least one "
                         "envelope harmonic, and 33 frames' coefficients "
                         "in shared memory")
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


# ---------------------------------------------------------------------------
# 7./8. track denoiser, pass A and pass B (pallas_osc.denoise_stats_pallas,
#       pallas_osc.denoise_apply_pallas)
# ---------------------------------------------------------------------------

# frames per block of csrc/denoise_stats.cu (its kTile); its first kernel
# takes K <= 128 and at most 31 taps each with h1 + 2 h2 under the tile,
# the wide path the rest in chunks of at most 128 columns
_DENOISE_TILE = 64
_DENOISE_MAX_TAPS = 31
_DENOISE_MAX_K = 128


@functools.lru_cache(maxsize=64)
def _denoise_frame_block(N: int) -> int:
    """The Pallas denoiser's frame block at N frames (pallas_osc.py:
    1176-1179): FRAME_BLOCK = 128, or where that does not divide N the
    largest multiple of 8 in [64, min(512, N)] that does.  Its FIR halo h1
    + 2 h2 must stay under the block; denoise_stats takes what it takes."""
    if N % 128:
        for cand in range(min(512, N) // 8 * 8, 63, -8):
            if N % cand == 0:
                return cand
    return 128


@functools.lru_cache(maxsize=64)
def _denoise_geometry(K: int, n1: int, n2: int) -> tuple:
    """denoise_stats.cu's launch for K columns and n1 + n2 taps -> (KC, the
    wide path's chunk of columns, and cw, the columns its launches walk at
    a time, which the wrapper passes to the C entry, both 0 for the first
    kernel; shared bytes a block of its first launch, or the first
    kernel's; of its second, 0 for the first kernel).  The first kernel:
    K <= 128, n1 and n2 <= 31, h1 +
    2 h2 < 64; its two float2 tracks of the tile and halo, [RA + R, K],
    with RA = 64 + 2 (h1 + h2) and R = 64 + 2 h2, then vo [RA] and the
    taps.  Else the wide path, in chunks of KC columns: the fit's sums add
    a frame's columns chunk by chunk, so KC is part of the result's bits,
    and it stays the chunk of the one-block kernel the path replaced: the
    widest multiple of 16 up to min(128, K rounded up to 16) whose tracks
    [RA + R, KC] float2 fit beside [R, 11] sums and fit, vo and the taps;
    None where not even KC = 16 fits.  Each launch walks a chunk cw
    columns at a time, 64 or, where a halo fills shared memory, 32 or 16:
    its first stages [64 + 2 h1, cw] float2, vo [64 + 2 h1] and taps1;
    its second r_inc [R, cw] float2, the fit [R, 4] and taps2."""
    h1, h2 = n1 // 2, n2 // 2
    RA, R = _DENOISE_TILE + 2 * (h1 + h2), _DENOISE_TILE + 2 * h2
    if K <= _DENOISE_MAX_K and max(n1, n2) <= _DENOISE_MAX_TAPS \
            and h1 + 2 * h2 < _DENOISE_TILE:
        return 0, 0, 8 * (RA + R) * K + 4 * (RA + n1 + n2), 0
    rest = 4 * (11 * R + RA + n1 + n2)
    SR = _DENOISE_TILE + 2 * h1
    for kc in range(min(128, -(-K // 16) * 16), 0, -16):
        if 8 * (RA + R) * kc + rest <= _SMEM_MAX:
            break
    else:
        return None
    for cw in (64, 32, 16):
        smem = (8 * SR * cw + 4 * (SR + n1), 8 * R * cw + 4 * (4 * R + n2))
        if max(smem) <= _SMEM_MAX:
            return (kc, cw, *smem)
    return None


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
    last h2 frames, as in the Pallas kernel.  Any K; taps whose halo h1 +
    2 h2 stays under the Pallas kernel's frame block at N frames
    (_denoise_frame_block), on the card and the CPU alike."""
    t1, t2 = _taps32(taps1), _taps32(taps2)
    B, N, K = a.shape
    block = _denoise_frame_block(N)
    if len(t1) // 2 + 2 * (len(t2) // 2) >= block:
        raise ValueError(f"denoise_stats: {len(t1)} + {len(t2)} taps: their "
                         f"halo h1 + 2 h2 must stay under the {block}-frame "
                         f"block of the Pallas kernel at N = {N}")
    if not _on_cuda(a, p, cyc_c, mask, voiced):
        return denoise_stats_ref(a, p, cyc_c, mask, voiced, t1, t2,
                                 complex_input=complex_input)
    if p.shape != (B, N, K) or mask.shape != (B, N, K) \
            or cyc_c.shape != (B, N) or voiced.shape != (B, N):
        raise ValueError("denoise_stats: shape mismatch")
    kc, cw = _denoise_geometry(K, len(t1), len(t2))[:2]
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
    taps_d = (_taps_on(t1, dev).data_ptr(), _taps_on(t2, dev).data_ptr()) \
        if kc else (None, None)
    # the wide path's scratch: each frame's partial fit sums a chunk, and
    # the slow track of the h2 frames beyond each end of an utterance
    part = edge = None
    if kc:
        part = torch.empty((B, N, -(-K // kc), 7), dtype=FP, device=dev)
        edge = torch.empty((B, 2 * (len(t2) // 2), K, 2), dtype=FP,
                           device=dev)
    _launch("denoise_stats", *ptrs, B, N, K,
            ctypes.addressof(_taps_host(t1)), len(t1),
            ctypes.addressof(_taps_host(t2)), len(t2), *taps_d, kc, cw,
            *(None if t is None or not t.numel() else t.data_ptr()
              for t in (part, edge)), int(complex_input), _stream(a))
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


_APPLY_BLOCKS_SM = 16         # the wide denoise_apply's blocks an SM at most


@functools.lru_cache(maxsize=64)
def _apply_geometry(K: int, rows: int, sms: int = 132) -> tuple:
    """denoise_apply.cu's launch of B N = rows rows of K slots -> (warps a
    block, 0 for the first kernel (K <= 128); blocks; row pairs a warp, a
    contiguous run; stage, 1 where each pair is staged in shared memory;
    shared bytes a block).  The wide kernel (K > 128): a warp two rows at a
    time (half a warp a row), a block one warp, its buffer the 5 planes'
    two rows (row_floats(K): K + 3 floats rounded up to 16 modulo 32) and
    each row's utterance's v and wmul (odd16(K) floats each); as many
    blocks as the SMs hold at once, at most 16 an SM (shared memory), each
    an even share of the pairs.  Past a block's shared memory (K > ~4100)
    no staging, four warps a block."""
    if K <= 128:
        return (0, 0, 0, 0, 0)
    odd16 = lambda n: (n + 15) // 32 * 32 + 16
    nbytes = 4 * (2 * 5 * odd16(K + 3) + 4 * odd16(K))
    stage = int(nbytes <= _SMEM_MAX)
    W, nbytes = (1, nbytes) if stage else (4, 0)
    per_sm = min(_APPLY_BLOCKS_SM, _SM_SMEM // (nbytes + _BLOCK_RESERVED))
    pairs = (rows + 1) // 2
    blocks = max(1, min(-(-pairs // W), sms * per_sm))
    per = -(-pairs // (blocks * W))
    return (W, -(-pairs // (W * per)), per, stage, nbytes)


def denoise_apply(cre: torch.Tensor, cim: torch.Tensor, csr: torch.Tensor,
                  csi: torch.Tensor, cyc_c: torch.Tensor, mask: torch.Tensor,
                  guard: torch.Tensor, v: torch.Tensor, wmul: torch.Tensor,
                  strength: float, *, spectral: bool = False):
    """Pass B of the track denoiser: pass A's aligned track (cre, cim) and
    slow track (csr, csi) [B, N, K], cyc_c [B, N], mask [B, N, K], guard
    [B, N], the per-utterance floor v and fit weights wmul [B, K].  The
    gated aligned track a is the coherent fit weighted by wmul plus the
    Wiener gate g = clip(1 - strength v / |r_inc|^2, 0, 1) on the
    incoherent residual, the raw track where the guard fails.  Returns
    (ampl, phse) [B, N, K] of a e^{+2 pi j (k+1) cyc_c}, masked (the time
    gate alone), or with spectral=True the complex64 pair (a, full), full =
    where(guard, c_s + r_inc, 0), both in the aligned domain: the spectral
    gate reads full, and denoise_finish adds its delta to a."""
    if not _on_cuda(cre, cim, csr, csi, cyc_c, mask, guard, v, wmul):
        return denoise_apply_ref(cre, cim, csr, csi, cyc_c, mask, guard, v,
                                 wmul, strength, spectral=spectral)
    B, N, K = cre.shape
    if any(t.shape != (B, N, K) for t in (cim, csr, csi, mask)) \
            or cyc_c.shape != (B, N) or guard.shape != (B, N) \
            or v.shape != (B, K) or wmul.shape != (B, K):
        raise ValueError("denoise_apply: shape mismatch")
    # float4 loads of every [B, N, K] and [B, K] plane
    ins = tuple(_aligned(_f32(t)) for t in (v, wmul, cre, cim, csr, csi,
                                             cyc_c, mask))
    gd = (guard if guard.dtype == torch.bool else guard > 0.5).contiguous()
    kind = CP if spectral else FP
    outs = tuple(torch.empty((B, N, K), dtype=kind, device=cre.device)
                 for _ in range(2))
    ptrs = [t.data_ptr() for t in ins + (gd,) + outs]
    W, blocks, per, stage, _ = _apply_geometry(K, B * N, _sm_count(cre.device))
    _launch("denoise_apply", *ptrs, B, N, K, float(strength),
            int(not spectral), W, blocks, per, stage, _stream(cre))
    return outs


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


def denoise_finish(a: torch.Tensor, delta: torch.Tensor, cyc_c: torch.Tensor,
                   mask: torch.Tensor):
    """The second launch of pass B: denoise_apply(spectral=True)'s aligned
    track a and the spectral gate's delta [B, N, K] complex64, cyc_c
    [B, N], mask [B, N, K] -> (ampl, phse) [B, N, K] of (a + delta)
    e^{+2 pi j (k+1) cyc_c}, masked (the JAX host's combine, layer0.py:
    699-702)."""
    if not _on_cuda(a, delta, cyc_c, mask):
        return denoise_finish_ref(a, delta, cyc_c, mask)
    B, N, K = a.shape
    if delta.shape != (B, N, K) or mask.shape != (B, N, K) \
            or cyc_c.shape != (B, N):
        raise ValueError("denoise_finish: shape mismatch")
    # float4 loads of the complex planes, float2 of the mask
    a, delta = (_aligned(t.to(CP).contiguous()) for t in (a, delta))
    cyc_c, mask = _f32(cyc_c), _aligned(_f32(mask), 8)
    ampl, phse = (torch.empty((B, N, K), dtype=FP, device=a.device)
                  for _ in range(2))
    _launch("denoise_finish", *(t.data_ptr() for t in (a, delta, cyc_c, mask,
                                                        ampl, phse)),
            B, N, K, _stream(a))
    return ampl, phse


def denoise_finish_ref(a, delta, cyc_c, mask):
    """Plain version of denoise_finish."""
    kh = torch.arange(1, a.shape[-1] + 1, dtype=FP, device=a.device)
    ua = 2.0 * math.pi * _phase_cycles(kh, cyc_c[..., None])
    z = (a + delta) * torch.polar(torch.ones_like(ua), ua)
    return torch.abs(z) * mask, torch.angle(z) * mask


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
                   device=None, *, bits: bool = False,
                   dtype: torch.dtype = torch.float32):
    """Plain version of noise_bins: threefry in int64 tensors masked to 32
    bits.  bits=True also returns the two [N, nbin] int32 bit tensors (the
    uint32 draws, wrapped) that the normals come from.  dtype=float64 draws
    what jax.random.normal(k, (nbin,), float64) draws under x64 (the JAX
    package's LLSM_FP64=1 noise), bit for bit: 64 bits a normal, XLA's
    float64 erf_inv, on `device` as every other draw; on a CUDA device
    within a few ulps (_log_c)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    wide = dtype == torch.float64
    if wide and bits:
        raise ValueError("noise_bins_ref: bits=True draws float32")
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
        if wide:
            out.append(_normal64_from_bits(b0, b1).expand(B, N, nbin))
            continue
        raw.append(b0 ^ b1)
        out.append(_normal_from_bits(raw[-1]).expand(B, N, nbin))
    if bits:
        return tuple(out) + tuple(r.to(torch.int32) for r in raw)
    return tuple(out)


# XLA's float64 erf_inv (M. Giles' double-precision polynomials): in
# w - 3.125 (w < 6.25), sqrt(w) - 3.25 (w < 16), sqrt(w) - 5, highest power
# first; and its log1p's small-argument rational (Cephes), |x| < sqrt(2)-1
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19,
     1.2858480715256400167e-18, 1.115787767802518096e-17,
     -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14,
     -8.1519341976054721522e-14, 2.6335093153082322977e-12,
     -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09,
     -2.9070369957882005086e-08, 4.2347877827932403518e-07,
     -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512,
     -0.0060336708714301490533, 0.24015818242558961693,
     1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08,
     -2.7517406297064545428e-07, 1.8239629214389227755e-08,
     1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05,
     -4.7318229009055733981e-05, 6.8284851459573175448e-05,
     2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313,
     0.0024914420961078508066, -0.0037512085075692412107,
     0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10,
     1.5076572693500548083e-09, -3.7894654401267369937e-09,
     7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08,
     2.2900482228026654717e-07, -9.9298272942317002539e-07,
     4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347,
     -0.00013871931833623122026, 1.0103004648645343977,
     4.8499064014085844221))
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


# ln 2 as three doubles; 1/n! (n = 0..10) as double-doubles
_LN2 = (0.6931471805599453, 2.3190468138462996e-17, 5.707708438416212e-34)
_INV_FACT = tuple((float(f), float(f - Fraction(float(f))))
                  for f in (Fraction(1, math.factorial(n)) for n in range(11)))


def _two_sum(a, b):
    """a + b = s + e exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """a * b = p + e exactly (Dekker's split; float64 tensors)."""
    p = a * b

    def split(v):
        t = 134217729.0 * v                   # 2^27 + 1
        hi = t - (t - v)
        return hi, v - hi
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _fma(a, b, c):
    """a * b + c with one rounding, as XLA's CPU code contracts it."""
    p, pe = _two_prod(a, b)
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + pe)


def _dd_add(ah, al, bh, bl):
    s, e = _two_sum(ah, bh)
    e = e + (al + bl)
    h = s + e
    return h, e - (h - s)


def _dd_mul(ah, al, bh, bl):
    p, e = _two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    h = p + e
    return h, e - (h - p)


def _exp_dd(h, l):
    """exp(h + l) as a double-double, to ~2^-96 relative: h + l less
    k ln 2 (exact in its leading part), over 2^8, a Taylor sum to degree
    10, squared eight times, times 2^k."""
    k = torch.round(h / _LN2[0])
    p, pe = _two_prod(k, _LN2[0])
    th, tl = _two_sum(h - p, -pe)                 # h - p is exact
    q, qe = _two_prod(k, _LN2[1])
    th, tl = _dd_add(th, tl, -q, -qe)
    th, tl = _dd_add(th, tl, l, -k * _LN2[2])
    th, tl = th / 256.0, tl / 256.0
    eh, el = (torch.full_like(th, c) for c in _INV_FACT[-1])
    for ch, cl in reversed(_INV_FACT[:-1]):
        eh, el = _dd_add(*_dd_mul(eh, el, th, tl), ch, cl)
    for _ in range(8):
        eh, el = _dd_mul(eh, el, eh, el)
    scale = ((k.to(torch.int64) + 1023) << 52).view(torch.float64)
    return eh * scale, el * scale


def _log_rn(y):
    """Correctly rounded log of positive y, on y's device: torch.log is
    within an ulp on the CPU and the card alike; of it and its two
    neighbours, keep the one the midpoints, tested against exp in
    double-double, select."""
    r = torch.log(y)
    dn = torch.nextafter(r, torch.full_like(r, -math.inf))
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    eh, el = _exp_dd(torch.stack((r, r)),
                     torch.stack(((dn - r) * 0.5, (up - r) * 0.5)))
    below = (y - eh[0]) < el[0]          # log y < the midpoint of dn, r
    above = (y - eh[1]) > el[1]          # log y > the midpoint of r, up
    return torch.where(below, dn, torch.where(above, up, r))


def _log_c(y):
    """The C library's log, which XLA's CPU code calls: libm itself on
    host tensors; elsewhere the correctly rounded log, which libm's
    (< 0.52 ulp) misses by an ulp at ~3e-4 of arguments."""
    if y.device.type == "cpu":
        return torch.from_numpy(np.frompyfunc(math.log, 1, 1)(
            y.numpy()).astype(np.float64))
    return _log_rn(y)


def _sqrt_rn(w):
    """Correctly rounded sqrt (PyTorch's vectorized CPU sqrt is not)."""
    r = torch.sqrt(w)
    cands = (torch.nextafter(r, torch.zeros_like(r)), r,
             torch.nextafter(r, torch.full_like(r, math.inf)))
    err = [((w - p) - e).abs() for p, e in (_two_prod(c, c) for c in cands)]
    out = torch.where(err[0] < err[1], cands[0], r)
    return torch.where((err[2] < err[1]) & (err[2] < err[0]), cands[2], out)


def _log1p_xla(x):
    """XLA's float64 log1p: the Cephes rational for |x| < sqrt(2) - 1,
    else the C library's log(1 + x)."""
    def horner(cs):
        p = torch.full_like(x, cs[0])
        for c in cs[1:]:
            p = _fma(p, x, torch.full_like(x, c))
        return p
    x2 = x * x
    small = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    small = x + _fma(torch.full_like(x, -0.5), x2, small)
    large = _log_c(x + 1.0)
    return torch.where(x.abs() < 0.41421356237309504880, small, large)


def _normal64_from_bits(b0: torch.Tensor, b1: torch.Tensor) -> torch.Tensor:
    """jax.random.normal's float64 step from two 32-bit words (the high
    and low halves of its 64 bits): u in (-1, 1) from the top 52 bits, then
    sqrt(2) erf_inv(u), each product-and-add one rounding (fused)."""
    bits = (b0 << 32) | b1
    f = (((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000).view(
        torch.float64) - 1.0
    lo = float(np.nextafter(-1.0, 0.0))
    u = torch.clamp(f * 2.0 + lo, min=lo)      # (1 - lo) rounds to 2
    w = -_log1p_xla(u * (-u))
    lt6, lt16 = w < 6.25, w < 16.0
    w = torch.where(lt6, w - 3.125,
                    _sqrt_rn(w) - torch.where(lt16, 3.25, 5.0).to(w.dtype))
    c625, c16, chi = _ERFINV64

    def coef(i):
        c = torch.full_like(w, c625[i])
        if i < len(c16):
            c = torch.where(lt6, c, c16[i])
        if i < len(chi):
            c = torch.where(lt16, c, chi[i])
        return c
    p = coef(0)
    for i in range(1, len(c625)):
        q = _fma(p, w, coef(i))
        p = q if i < len(chi) else torch.where(
            lt16 if i < len(c16) else lt6, q, p)
    return math.sqrt(2.0) * (p * u)


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
    if FP64:
        raise TypeError("noise_bins draws float32: under LLSM_FP64=1 the "
                        "draw is noise_bins_ref(dtype=torch.float64)")
    if device.type == "cpu":
        return noise_bins_ref(seed, frame_base, B, N, nbin, device, bits=bits)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    # frame_base is JAX's int32 frame index: a negative base (the first
    # shard of a frame-sharded render draws frames -2, -1) wraps to uint32,
    # as the twin's mask and the kernel's uint32 sum do
    if N < 0 or nbin < 0 or not -(1 << 31) <= frame_base < (1 << 31):
        raise ValueError("noise_bins: bad frame range or bin count")
    out = [torch.empty((N, nbin), dtype=FP, device=device) for _ in range(2)]
    if bits:
        out += [torch.empty((N, nbin), dtype=torch.int32, device=device)
                for _ in range(2)]
    ptrs = [t.data_ptr() for t in out] + [None] * (4 - len(out))
    _launch("noise_bins", *ptrs, int(seed) & _U32, int(frame_base) & _U32,
            N, nbin, torch.cuda.current_stream(device).cuda_stream)
    return tuple(t.expand(B, N, nbin) for t in out[:2]) + tuple(out[2:])


# ---------------------------------------------------------------------------
# 10. chirped projection of pre-windowed frames
#     (pallas_osc.harmonic_project_pallas)
# ---------------------------------------------------------------------------

# harmonic_project.cu's row kernel (K > 8) stages a row's live columns,
# xw and the reduced offset (8 bytes a column), in shared memory: up to
# _PROJECT_SPAN columns a block, which leaves room for four blocks an SM
# and holds the live span of every frame at 96 kHz whose F0 is 70 Hz or
# more (2 ceil(2 fs / F0) + 1 = 5487 columns); a longer span streams through
# two chunk buffers of half as many.  Beside them, the block sums of a pass
# (4 warps x 80 floats at five groups).  A pass walks the columns for five
# groups of 8 harmonics (128 registers: four blocks an SM) on rows of more
# than _PROJECT_SHORT columns, and for two (64 registers, eight blocks an
# SM) on shorter rows, where a block's few columns a thread leave its
# fixed costs to hide
_PROJECT_SPAN = 6144
_PROJECT_STATIC = 4 * 4 * 80
_PROJECT_SHORT = 2048


def _project_geometry(W: int, K: int) -> tuple:
    """harmonic_project's launch for rows of W columns and K harmonics ->
    (S staged columns a block, dynamic shared bytes, G groups of 8
    harmonics a pass): no shared memory at K <= 8 (a warp a row from
    device memory); else S = min(W, _PROJECT_SPAN): a row whose live span
    [lo, hi) fits is staged once, a longer one (only where W > S) in
    chunks of S / 2 columns; G 5 past _PROJECT_SHORT columns, else 2."""
    if K <= 8:
        return 0, 0, 0
    S = min(W, _PROJECT_SPAN)
    return S, 8 * S, 5 if W > _PROJECT_SHORT else 2


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
    S, _, G = _project_geometry(W, max_k)
    _launch("harmonic_project", *ptrs, R, W, max_k, S, G, _stream(dc))
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
    x, cyc [B, nx] the signal and its mod-1 cycle track (unframed, nx >=
    N nhop); hw [B, N] the window halfwidths; hh the window reach in whole
    hops -> (re [B, N, K], im [B, N, K], wsum [B, N], xsum [B, N]) with
    re + j im = sum_n w_f(n) x(n) e^{-2 pi j (k+1) (cyc(n) - cyc(f nhop))}
    (at the frame centre, as harmonic_project_win returns it), wsum =
    sum_n w_f(n) and xsum = sum_n w_f(n) x(n).  w_f is the cosine-series
    `window` of halfwidth hw centred at f*nhop, cut at |n - f nhop| <=
    hh*nhop; x is zero outside each utterance."""
    if window not in COSINE_SERIES:
        raise ValueError(f"harmonic_project_mxu: {window!r} is not a "
                         "cosine-series window")
    if not _on_cuda(x, cyc, hw):
        return harmonic_project_mxu_ref(x, cyc, hw, max_k, nhop, hh,
                                        window=window)
    B, nx = x.shape
    N = hw.shape[-1]
    if cyc.shape != (B, nx) or hw.shape != (B, N) or N * nhop > nx:
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
            int(hh) * int(nhop), *coefs[:4], _stream(x))
    return re, im, ws, xs


def harmonic_project_mxu_ref(x, cyc, hw, max_k, nhop, hh, *,
                             window="hanning"):
    """Plain version of harmonic_project_mxu: the modulated rows G = [1, x,
    x cos(2 pi k cyc), -x sin(2 pi k cyc)] over each frame chunk's span
    (x zero-padded, cyc edge-padded by hh*nhop per utterance), contracted
    with the chunk's window rows by torch.einsum in float32, then rotated
    by e^{+2 pi j k cyc(f nhop)} to the centres (the JAX package's
    harmonic_analysis, harmonics.py:206-210)."""
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
    re, im = out[..., 2:2 + K], out[..., 2 + K:]
    ang = 2.0 * math.pi * _phase_cycles(kh, cyc[..., :N * nhop:nhop, None])
    cr, sr = torch.cos(ang), torch.sin(ang)
    return (re * cr - im * sr, re * sr + im * cr, out[..., 0].contiguous(),
            out[..., 1].contiguous())


# ---------------------------------------------------------------------------
# cycle track (libllsm2_tpu/ops/harmonics.py: sample_cycles, an XLA scan;
# no Pallas kernel)
# ---------------------------------------------------------------------------

# sample_cycles.cu: past hop 512 its long-hop kernel, at most 128 lanes a
# hop, each a run of up to 16 samples; past 2048 its hop kernel, a block of
# 256 lanes a hop, one launch after its prep


def sample_cycles(f0: torch.Tensor, nhop: int, fs: float, nx: int,
                  base: torch.Tensor | None = None,
                  start: int = 0) -> torch.Tensor:
    """Fundamental phase in cycles mod 1 at every sample: f0 [..., N] ->
    [..., nx], nx a multiple of nhop (see sample_cycles_ref for the
    arithmetic, base and start).  On the card every sum runs in an order
    set by its row alone, so a row's track does not depend on the rest of
    its batch."""
    if nx % nhop:
        raise ValueError("sample_cycles: nx must be a multiple of nhop")
    if not _on_cuda(f0):
        return sample_cycles_ref(f0, nhop, fs, nx, base, start)
    N = f0.shape[-1]
    if N < 2:
        raise ValueError(f"sample_cycles: {N} frames (at least 2)")
    # few tensor operations: a lone call's host time is most of its time
    f = f0 if f0.dtype == FP and f0.is_contiguous() else _f32(f0)
    B = f.numel() // N
    # one allocation: the track, then (8-byte aligned) the kernel's tile
    # sums as int64, which the C entry zeroes (the call's memset), and past
    # hop 512 the fraction table, which it writes (past 2048 the words are
    # a hop's each)
    n = B * nx + (B * nx) % 2
    buf = torch.empty(n + 2 * _cycle_words(B, int(nhop), int(nx)),
                      dtype=FP, device=f.device)
    ptr = buf.data_ptr()
    if base is not None:
        base = base.to(f.device, torch.float64).reshape(B).contiguous()
    _launch("sample_cycles", f.data_ptr(), ptr, ptr + 4 * n,
            None if base is None else base.data_ptr(), int(start), B, N,
            int(nhop), int(nx), float(fs), _stream(f))
    return buf[:B * nx].view(f0.shape[:-1] + (nx,))


@functools.lru_cache(maxsize=64)
def _cycle_words(B: int, nhop: int, nx: int) -> int:
    """The scratch words (8 bytes) the cycle-track kernel needs for this
    shape: its tile words (past hop 2048 a word a hop of each row) and,
    past hop 512, its fraction table."""
    return _build.library().llsm_sample_cycles_words(B, nhop, nx)


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


def cycle_totals(f0: torch.Tensor, nhop: int, fs: float, nx: int,
                 start: int = 0) -> torch.Tensor:
    """Each hop's cycles mod 1 as sample_cycles sums them: f0 [..., N] ->
    [..., nx / nhop] float64, the float32 steps (cycle_steps) summed in
    float64 (exact on analysis tracks, whatever the order), rounded to
    float32, reduced mod 1.  Their float64 sums are exact too: the base a
    frame shard gives sample_cycles."""
    d = cycle_steps(f0, nhop, fs, nx, start).to(torch.float64)
    w = torch.sum(d.reshape(d.shape[:-1] + (-1, nhop)), dim=-1).to(FP)
    return torch.remainder(w, 1.0).to(torch.float64)


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


# ---------------------------------------------------------------------------
# decimated F0 refinement (libllsm2_tpu/ops/harmonics.py:372-468, jnp that
# XLA fuses; no Pallas kernel)
# ---------------------------------------------------------------------------

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


# (frames, lanes a frame) of a refine block, preferred first: a thread a
# frame where the batch fills the card, else 16 lanes a frame (a frame's
# sums are 16 partials added in one order either way)
_REFINE_BLOCKS = ((128, 1), (8, 16), (4, 16), (2, 16))
_REFINE_SMEM_MAX = 232448        # the H100's shared memory a block may use


def _refine_geometry(B: int, N: int, D: int, ntaps: int, dm: dict,
                     sms: int = 132) -> dict:
    """refine_f0.cu's launch: F frames of one row a block, G lanes a frame
    (the first of _REFINE_BLOCKS that gives two blocks to each of the
    card's `sms` SMs, else the last), T = F G threads, which stage the S =
    (F - 1) nhop_d + Wf decimated samples their windows read (G = 1:
    staged sample i at (i mod nhop_d) P + i // nhop_d, so a warp's frames
    read one column on consecutive words; G = 16: in a row, words = S),
    their FIR fed x in chunks of Q = 2T outputs, chunk sample i at (i mod
    D) PQ + i // D (PQ = 32 / D mod 32: a warp's staging writes on
    distinct banks), two chunks in flight; smem: the block's shared bytes
    (taps, two chunks, staged samples, the column table).  D = 1 (the
    full-rate kernel, dm from _refine_full_dims): no FIR, the S samples of
    x in a row (words = S, P = Q = PQ = 0), smem those alone; a thread a
    frame only at an odd hop, where a warp's frames reading one column at
    a stride of nhop words fall on 32 banks (an even hop takes the 16-lane
    blocks, whose lanes read consecutive words).  A block whose shared
    bytes overflow the card's is passed over (44.1 kHz at a 10 ms hop: 128
    frames of hop 441 and their 4961-sample windows), so the smaller
    blocks take those shapes."""
    blocks = _REFINE_BLOCKS
    if D == 1 and dm["nhop_d"] % 2 == 0:
        blocks = tuple(b for b in blocks if b[1] > 1)
    nd, Wf = dm["nhop_d"], dm["Wf"]

    def block(F, G):
        T = F * G
        S = (F - 1) * nd + Wf
        if D == 1:
            return dict(F=F, G=G, T=T, S=S, P=0, words=S, Q=0, PQ=0,
                        smem=4 * S, grid=(-(-N // F), B))
        P = -(-S // nd) if G == 1 else 0
        words = nd * P if G == 1 else S
        Q = 2 * T
        PQ = Q + -(-ntaps // D) - 1
        PQ += (32 // D - PQ) % 32
        smem = 4 * (-(-ntaps // 4) * 4 + 2 * D * PQ + words + Wf)
        return dict(F=F, G=G, T=T, S=S, P=P, words=words, Q=Q, PQ=PQ,
                    smem=smem, grid=(-(-N // F), B))
    geos = [block(F, G) for F, G in blocks]
    fits = [g for g in geos if g["smem"] <= _REFINE_SMEM_MAX] or geos[-1:]
    return next((g for g in fits if B * -(-N // g["F"]) >= 2 * sms),
                fits[-1])


@functools.lru_cache(maxsize=8)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def refine_f0_dec(x: torch.Tensor, f0: torch.Tensor, taps, *, D: int,
                  g: int, nhop: int, fs: float, halfwin_max: int,
                  rel_winsize: float, window: str, iters: int,
                  max_rel_dev: float, pass_hz: float, bounds=None):
    """The decimated F0 refine: x [B, nx] lowpassed by the FIR `taps` (a
    sequence of float64 host values, applied as float32, group delay g;
    harmonics.refine_decimation makes it) and decimated
    by D, then `iters` iterations of the two phase probes of each frame
    and the fundamental-presence gate -> f0 [B, N] (refine_f0_dec_ref says
    the arithmetic).  bounds (lo, hi): the samples of x within the signal;
    the FIR's output outside them is zero.  On the card one launch sums
    every frame in an order of its own (F frames of a row a block, a thread
    or 16 lanes a frame: _refine_geometry), so a row's F0 is the same
    alone, in any batch and in a frame shard's block."""
    kw = dict(D=D, g=g, nhop=nhop, fs=fs, halfwin_max=halfwin_max,
              rel_winsize=rel_winsize, window=window, iters=iters,
              max_rel_dev=max_rel_dev, pass_hz=pass_hz, bounds=bounds)
    if window != "mltsine" and window not in COSINE_SERIES:
        raise ValueError(f"refine_f0_dec: unknown window {window!r}")
    if not _on_cuda(x, f0):
        return refine_f0_dec_ref(x, f0, taps, **kw)
    x, f0 = _f32(x), _f32(f0)
    out = torch.empty_like(f0)
    _launch("refine_f0_dec", *_refine_launch_args(x, f0, taps, out, **kw))
    return out


def _refine_launch_args(x, f0, taps, out, *, D, g, nhop, fs, halfwin_max,
                        rel_winsize, window, iters, max_rel_dev, pass_hz,
                        bounds=None) -> tuple:
    """llsm_refine_f0_dec's arguments for refine_f0_dec on the card's
    contiguous float32 x [B, nx] and f0 [B, N], writing out [B, N]."""
    B, nx = x.shape
    N = f0.shape[-1]
    if f0.shape != (B, N) or D not in (2, 4, 8) or nx % D or nhop % D:
        raise ValueError("refine_f0_dec: shape mismatch (x [B, nx], f0 "
                         "[B, N], D of 2, 4 or 8 dividing nx and nhop)")
    t = _taps32(taps)
    dm = _refine_dims(nx, D, nhop, fs, halfwin_max)
    geo = _refine_geometry(B, N, D, len(t), dm, _sm_count(x.device))
    if geo["smem"] > _REFINE_SMEM_MAX:
        raise ValueError(f"refine_f0_dec: {geo['smem']} bytes of shared "
                         "memory a block (Wf or the taps too long)")
    lo, hi = (0, nx) if bounds is None else (int(bounds[0]), int(bounds[1]))
    return (x.data_ptr(), f0.data_ptr(), _taps_on(t, x.device).data_ptr(),
            out.data_ptr(), B, nx, N, int(D), int(g), len(t), dm["nhop_d"],
            dm["C"], dm["Wf"], dm["delta_d"], int(iters), float(dm["H_d"]),
            dm["fs_d"], dm["dt_d"], 2.0 * math.pi * dm["dt_d"],
            rel_winsize * dm["fs_d"], 1 - max_rel_dev, 1 + max_rel_dev,
            float(pass_hz), lo, hi, *_window_coefs(window), geo["F"],
            geo["G"], geo["P"], geo["PQ"], _stream(x))


def _window_coefs(window: str) -> tuple:
    """The refine kernels' window arguments: its four cosine-series
    coefficients (zero past its own) and their count, 0 for mltsine."""
    if window == "mltsine":
        return (0.0,) * 4 + (0,)
    c = tuple(float(v) for v in COSINE_SERIES[window])
    return (c + (0.0,) * 3)[:4] + (len(c),)


def refine_f0_dec_ref(x, f0, taps, *, D, g, nhop, fs, halfwin_max,
                      rel_winsize, window, iters, max_rel_dev, pass_hz,
                      bounds=None):
    """Plain version of refine_f0_dec (the JAX package's jnp,
    harmonics.py:399-468): the polyphase FIR as Qh products of the [B,
    nxd + Qh, D] sample blocks with the taps' rows, the frames of
    harmonics.frame_hops, and each probe as PyTorch sums over the frame's
    Wf samples.  On the CPU refine_f0 calls it a row at a time."""
    from .harmonics import frame_hops
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
        xd = xd + Bm[:, q:q + nxd, :] @ hq[q]
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


# ---------------------------------------------------------------------------
# full-rate F0 refinement (libllsm2_tpu/ops/harmonics.py:494-543: its five
# harmonic_project_pallas K = 1 probes, pallas_osc.py:1388)
# ---------------------------------------------------------------------------

def _refine_full_dims(nhop: int, fs: float, H: int) -> dict:
    """The full-rate refine's sizes (harmonics.py:494-502): the probes'
    offset delta and spacing dt in seconds, a frame's half span C = H +
    delta and width Wf = 2 C + 1 (the samples its two probes read), in
    _refine_geometry's names (nhop_d = nhop)."""
    delta = max(H // 8, 2)
    C = H + delta
    return dict(nhop_d=nhop, delta=delta, dt=2.0 * delta / fs, C=C,
                Wf=2 * C + 1)


def refine_f0_full(x: torch.Tensor, f0: torch.Tensor, *, nhop: int,
                   fs: float, halfwin_max: int, rel_winsize: float,
                   window: str, iters: int, max_rel_dev: float):
    """The full-rate F0 refine: `iters` iterations of the two phase probes
    at each frame centre -+ delta on x itself, then the fundamental-
    presence gate, a probe at 2 f0 -> f0 [B, N] (refine_f0_full_ref says
    the arithmetic).  On the card one launch of refine_f0.cu's full-rate
    kernel: F frames of a row a block (_refine_geometry at D = 1), a thread
    or 16 lanes a frame, each sum in an order of its frame's alone, so a
    row's F0 is the same alone and in any batch; no [B, N, W] tensor."""
    kw = dict(nhop=nhop, fs=fs, halfwin_max=halfwin_max,
              rel_winsize=rel_winsize, window=window, iters=iters,
              max_rel_dev=max_rel_dev)
    if window != "mltsine" and window not in COSINE_SERIES:
        raise ValueError(f"refine_f0_full: unknown window {window!r}")
    if not _on_cuda(x, f0):
        return refine_f0_full_ref(x, f0, **kw)
    x, f0 = _f32(x), _f32(f0)
    out = torch.empty_like(f0)
    _launch("refine_f0_full", *_refine_full_launch_args(x, f0, out, **kw))
    return out


def _refine_full_launch_args(x, f0, out, *, nhop, fs, halfwin_max,
                             rel_winsize, window, iters,
                             max_rel_dev) -> tuple:
    """llsm_refine_f0_full's arguments for refine_f0_full on the card's
    contiguous float32 x [B, nx] and f0 [B, N], writing out [B, N]."""
    B, nx = x.shape
    N = f0.shape[-1]
    if f0.shape != (B, N) or nhop < 1 or halfwin_max < 0:
        raise ValueError("refine_f0_full: shape mismatch (x [B, nx], f0 "
                         "[B, N], nhop >= 1)")
    dm = _refine_full_dims(nhop, fs, halfwin_max)
    geo = _refine_geometry(B, N, 1, 0, dm, _sm_count(x.device))
    if geo["smem"] > _REFINE_SMEM_MAX:
        raise ValueError(f"refine_f0_full: {geo['smem']} bytes of shared "
                         "memory a block (the hop or halfwin_max too long)")
    return (x.data_ptr(), f0.data_ptr(), out.data_ptr(), B, nx, N, int(nhop),
            int(halfwin_max), dm["delta"], int(iters), float(fs), dm["dt"],
            2.0 * math.pi * dm["dt"], rel_winsize * fs, 1 - max_rel_dev,
            1 + max_rel_dev, *_window_coefs(window), geo["F"], geo["G"],
            _stream(x))


def refine_f0_full_ref(x, f0, *, nhop, fs, halfwin_max, rel_winsize, window,
                       iters, max_rel_dev):
    """Plain version of refine_f0_full (the JAX package's Pallas branch,
    harmonics.py:494-543): each probe gathers left-aligned frames (window
    centred at ceil(halfwidth)) of x zero-padded, windows them and projects
    them onto the fundamental with harmonic_project_ref at K = 1; the
    presence gate is a fifth probe at 2 f0.  x [B, nx], f0 [B, N] -> [B,
    N].  On the CPU harmonics.refine_f0 calls it a row at a time."""
    B, N = f0.shape
    H = halfwin_max
    voiced = f0 > 0.0
    xp = _refine_full_pad(x, H)
    dm = _refine_full_dims(nhop, fs, H)
    delta, dt = dm["delta"], dm["dt"]
    centers = torch.arange(N, device=x.device) * nhop

    def probe(cts, f0s, halfwidth):
        dc, xw, lo, hi = _refine_full_frames(xp, cts, f0s, halfwidth, H=H,
                                             fs=fs, window=window)
        re, im = harmonic_project_ref(dc, xw, 1, lo, hi)
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


def _refine_full_pad(x, H: int):
    """x [B, nx] zero-padded for refine_f0_full_ref's gathers: 3 H + 1
    samples before it and 3 H + 2 after."""
    W = 2 * H + 1
    return torch.nn.functional.pad(x.to(FP), (H + W, H + W + 1))


def _refine_full_frames(xp, cts, f0s, halfwidth, *, H: int, fs: float,
                        window: str):
    """One full-rate probe's harmonic_project operands (harmonics.py:
    500-513): frames of the padded xp (_refine_full_pad) at centres cts [N]
    (or [B, N]) + noff, left-aligned (the window centred at column ceil(hw),
    so the basis phase reference shifts by H - hw a frame; the update only
    uses ph_p - ph_m at equal halfwidth, so it cancels) -> (dc, xw [B N,
    2 H + 1], lo, hi [B N]), each frame's live columns [0, 2 ceil(hw) +
    1)."""
    B, N = f0s.shape
    W = 2 * H + 1
    col = torch.arange(W, device=xp.device)
    hw_int = torch.ceil(halfwidth).to(torch.int64)              # [B, N]
    noff = (col - hw_int[..., None]).to(FP)                     # [B, N, W]
    idx = (cts + W + H - hw_int)[..., None] + col
    frames = torch.gather(xp, 1, idx.reshape(B, -1)).reshape(B, N, W)
    xw = frames * window_centered(window, noff, halfwidth[..., None])
    dc = _phase_cycles(noff, (f0s / fs)[..., None])
    return (dc.reshape(B * N, W), xw.reshape(B * N, W),
            torch.zeros_like(hw_int).reshape(-1), (2 * hw_int + 1).reshape(-1))


# ---------------------------------------------------------------------------
# Viterbi scan (libllsm2_tpu/ops/f0.py:203-222 and models/layer1.py:161-172:
# a lax.scan forward and a reverse lax.scan backtrace; no Pallas kernel)
# ---------------------------------------------------------------------------

# viterbi.cu's slots of the warps' maxima a step (kMaxWarps) and rows of
# its observations' ring (kRing)
_VITERBI_WARPS = 32
_VITERBI_RING = 16
# viterbi.cu's source states a lane with lt in registers: 52 = 4 ceil(97 /
# 8) fits the F0 tracker's 97 states at 2 lanes (104 slots, not 128)
_VITERBI_CHUNKS = (4, 8, 16, 32, 52, 64)


# the most states viterbi_scan takes (the one-block-a-row kernel that ran
# past 2048 states until the stream kernel replaced it filled shared memory
# with two score rows there; kept: the stream kernel's uint16 backpointers
# and 16 dest warps a block would go further)
_VITERBI_MAX_STATES = 29024
# viterbi_grid_kernel (lt mode 4, 256 < S <= 2048): destination states a
# block (kGridJ), source states a group (kGridG), rows a warp (kGridRows),
# row warps a block tried; its ceil(S / 16) <= 128 slices need one block
# an SM
_VITERBI_GRID_J = 16
_VITERBI_GRID_G = 8
_VITERBI_GRID_ROWS = 8
_VITERBI_GRID_WARPS = (1, 2, 4)
_VITERBI_GRID_MAX_STATES = 2048


def _viterbi_geometry(N: int, S: int) -> tuple:
    """viterbi.cu's launch for N frames of S states -> (P lanes a state, C
    source states a lane, threads, lt mode, backpointers in shared memory,
    shared bytes, bytes a backpointer).  Up to S = 128: P = 2 (the fastest
    of the P tried on the H100 at both paths' shapes, PERF.md §6) and C the
    least of _VITERBI_CHUNKS with 2 C >= S, lt's column slice in registers
    (lt mode 0); past it P = 4, C = 64, lt in shared memory where its S^2
    floats fit (mode 1), else in device memory (2).  The shared bytes: the
    two score rows [2, P C], the maxima [2, 32] and the observations' ring
    [16, S] always, then lt in mode 1, then the (N - 1) S byte backpointers
    where they fit beside them.  Past 256 states P = 1, C = S rounded up
    to 8 (the source states a thread takes, in groups of 8), the
    backpointers uint16 in device memory, and threads and bytes None: the
    cooperative grid's, to 2048 states viterbi_grid_kernel's (mode 4,
    _viterbi_grid: lt's column slice in shared memory for the whole
    launch), past it viterbi_stream_kernel's (mode 5, _viterbi_stream:
    lt's columns and the scores streamed through shared memory in chunks
    of source states every step)."""
    if S > 256:
        C = -(-S // _VITERBI_GRID_G) * _VITERBI_GRID_G
        mode = 4 if S <= _VITERBI_GRID_MAX_STATES else 5
        return 1, C, None, mode, False, None, 2
    if S <= 128:
        P, lt_mode = 2, 0
        C = next(c for c in _VITERBI_CHUNKS if 2 * c >= S)
    else:
        P, C, lt_mode = 4, 64, None
    smem = 4 * (2 * P * C + 2 * _VITERBI_WARPS + _VITERBI_RING * S)
    if lt_mode is None:
        lt_mode = 1 if smem + 4 * S * S <= _SMEM_MAX else 2
    smem += 4 * S * S if lt_mode == 1 else 0
    bp_smem = smem + (N - 1) * S <= _SMEM_MAX
    return (P, C, (P * S + 31) // 32 * 32, lt_mode, bp_smem,
            smem + ((N - 1) * S if bp_smem else 0), 1)


def _viterbi_grid(B: int, S: int, sms: int = 132) -> tuple:
    """viterbi_grid_kernel's cooperative grid for B rows of S states (lt
    mode 4) on a card of `sms` SMs -> (warps a block, row warps, destination
    slices, row blocks, shared bytes).  A block owns 16 destination states
    (ceil(S / 16) slices) and takes row groups of 8 rows a row warp; the
    slices x row blocks blocks are at most one an SM, so a block whose
    slice has more row groups than row blocks walks them in turn.  Row
    warps: the fewest of 1, 2 and 4 that make the fewest such passes a
    step and whose lt slice and rows ([16 + 8 row warps, C + 4] floats)
    fit shared memory; the block's other warps split the source states
    into P parts (8 warps a block, 16 at 4 row warps: the fastest of 1-16
    warps at 257 / 385 / 512 / 1025 states, 1 and 64 rows, on the H100;
    P halved until the parts' maxima [P, 8 row warps, 16] (value, index)
    fit beside the rows)."""
    C = -(-S // _VITERBI_GRID_G) * _VITERBI_GRID_G
    slices = -(-S // _VITERBI_GRID_J)
    if slices > sms:
        raise ValueError(f"viterbi_scan: {S} states need {slices} blocks, "
                         f"more than the card's {sms} SMs")
    best = None
    for wr in _VITERBI_GRID_WARPS:
        rows = _VITERBI_GRID_ROWS * wr
        smem = 4 * (_VITERBI_GRID_J + rows) * (C + 4)
        if smem > _SMEM_MAX:
            break
        groups = -(-B // rows)
        row_blocks = min(groups, sms // slices)
        passes = -(-groups // row_blocks)
        if best is None or passes < best[0]:
            best = (passes, wr, row_blocks, smem)
    _, wr, row_blocks, smem = best
    rows = _VITERBI_GRID_ROWS * wr
    parts = max(8, 4 * wr) // wr
    while parts > 1 and smem + 8 * parts * rows * _VITERBI_GRID_J > _SMEM_MAX:
        parts //= 2
    if parts > 1:
        smem += 8 * parts * rows * _VITERBI_GRID_J
    return wr * parts, wr, slices, row_blocks, smem


# viterbi_stream_kernel (lt mode 5, S > 2048): destination states a dest
# warp, the most warps a block
_VITERBI_STREAM_J = 32
_VITERBI_STREAM_WARPS = 16


def _viterbi_stream(B: int, S: int, sms: int = 132) -> tuple:
    """viterbi_stream_kernel's cooperative grid for B rows of S states (lt
    mode 5) on a card of `sms` SMs -> (warps a block, dest warps, row
    warps, rows a thread, destination slices, row blocks, source states a
    chunk, shared bytes).  A block owns a slice of 32 x dest warps
    destination states, the fewest dest warps whose ceil(S / (32 dest
    warps)) slices are at most the card's SMs; a thread takes 4
    neighbouring destinations of 4 rows (1 at up to 4 rows: a warp 16 or 4
    rows); row warps: the fewest of 1, 2 and 4 that make the fewest passes
    over the row groups a step, as _viterbi_grid; the block's other warps,
    up to 16 in all, split each chunk's groups of 8 source states into P
    parts (a power of 2).  A chunk holds 4 groups a part, at least 256
    states; it is halved, then P, until its two buffers (lt's [chunk, 32
    dest warps] and the rows' scores [rows, chunk + 4]) and the parts'
    maxima [P, rows, 32 dest warps] (value, first group), which reuse the
    buffers, fit shared memory.  The slices x row blocks blocks are at most
    one an SM."""
    dw = -(-(-(-S // _VITERBI_STREAM_J)) // sms)
    if dw > _VITERBI_STREAM_WARPS:
        raise ValueError(f"viterbi_scan: {S} states need more than "
                         f"{_VITERBI_STREAM_WARPS} dest warps a block on "
                         f"{sms} SMs")
    J = _VITERBI_STREAM_J * dw
    slices = -(-S // J)
    ra = 1 if B <= 4 else 4
    best = None
    for rw in (1, 2, 4):
        if dw * rw > _VITERBI_STREAM_WARPS:
            break
        groups = -(-B // (4 * ra * rw))
        row_blocks = min(groups, sms // slices)
        passes = -(-groups // row_blocks)
        if best is None or passes < best[0]:
            best = (passes, rw, row_blocks)
    _, rw, row_blocks = best
    rows = 4 * ra * rw
    parts = 1
    while dw * rw * parts * 2 <= _VITERBI_STREAM_WARPS:
        parts *= 2

    def nbytes(parts, kc):
        return max(8 * (kc * J + rows * (kc + 4)), 8 * parts * rows * J)

    kc = max(256, 32 * parts)
    while nbytes(parts, kc) > _SMEM_MAX:
        if kc > 8 * parts:
            kc //= 2
        else:
            parts //= 2
    return (dw * rw * parts, dw, rw, ra, slices, row_blocks, kc,
            nbytes(parts, kc))


def _viterbi_scratch(B: int, N: int, S: int, device):
    """viterbi.cu's scratch: None where _viterbi_geometry keeps the
    backpointers in shared memory, else [B, N - 1, S] uint8 (uint16 past
    256 states); in lt modes 4 and 5 (bp, work), work the int32 words of
    the cooperative kernels' raw scores [2, B, C], row maxima [3, B] and
    barrier counter."""
    geo = _viterbi_geometry(N, S)
    if geo[4]:
        return None
    kind = torch.uint8 if geo[6] == 1 else torch.int16
    bp = torch.empty((B, N - 1, S), dtype=kind, device=device)
    if geo[3] < 4:
        return bp
    return bp, torch.empty(2 * B * geo[1] + 3 * B + 1, dtype=torch.int32,
                           device=device)


def _viterbi_launch_args(obs, lt, renorm: bool, path, final, bp):
    """viterbi.cu's C call on contiguous float32 obs [B, N, S] and lt, into
    path [B, N], final [B, S] and bp (_viterbi_scratch)."""
    B, N, S = obs.shape
    P, C, _, lt_mode, bp_smem, _, bp_bytes = _viterbi_geometry(N, S)
    work, warps, row_warps, rows, dest_warps, rows_a, chunk = (None, 0, 0,
                                                               0, 0, 0, 0)
    if lt_mode == 4:
        bp, work = bp
        warps, row_warps, _, rows, _ = _viterbi_grid(B, S,
                                                     _sm_count(obs.device))
    elif lt_mode == 5:
        bp, work = bp
        (warps, dest_warps, row_warps, rows_a, _, rows, chunk,
         _) = _viterbi_stream(B, S, _sm_count(obs.device))
    ptr = lambda t: None if t is None else t.data_ptr()
    return (obs.data_ptr(), lt.data_ptr(), path.data_ptr(), final.data_ptr(),
            ptr(bp), ptr(work), B, N, S, int(bool(renorm)), P, C, lt_mode,
            int(bp_smem), bp_bytes, warps, row_warps, rows, dest_warps,
            rows_a, chunk, _stream(obs))


def viterbi_scan(obs: torch.Tensor, lt: torch.Tensor, renorm: bool, *,
                 scores: bool = False):
    """The most likely state path [B, N] (int64) of each row of per-frame
    log scores obs [B, N, S] under log transitions lt [S, S] (from row, to
    column): score_0 = obs[:, 0], score_t[j] = max_i (score_{t-1}[i] +
    lt[i, j]) + obs[:, t, j], with renorm each score_t (score_0 too) less
    its row maximum; ties go to the first maximum at every step and at the
    end.  With scores, (path, the last step's scores [B, S]).  On the card
    one launch of viterbi.cu (S <= _VITERBI_MAX_STATES; _viterbi_geometry's
    lanes a state; past 256 states one cooperative launch over the card's
    SMs: _viterbi_grid to 2048 states, _viterbi_stream past it), the
    backtrace in the kernel; its scores and path are the plain version's
    bit for bit (NaN inputs aside).  A cooperative grid the card refuses
    raises."""
    if not _on_cuda(obs, lt):
        return viterbi_scan_ref(obs, lt, renorm, scores=scores)
    B, N, S = obs.shape
    if tuple(lt.shape) != (S, S) or N < 1 \
            or not 1 <= S <= _VITERBI_MAX_STATES:
        raise ValueError(f"viterbi_scan: obs {tuple(obs.shape)}, lt "
                         f"{tuple(lt.shape)} (S <= {_VITERBI_MAX_STATES} "
                         "states, N >= 1)")
    obs, lt = _f32(obs), _f32(lt)
    path = torch.empty((B, N), dtype=torch.int64, device=obs.device)
    final = torch.empty((B, S), dtype=torch.float32, device=obs.device)
    bp = _viterbi_scratch(B, N, S, obs.device)
    _launch("viterbi_scan",
            *_viterbi_launch_args(obs, lt, renorm, path, final, bp))
    return (path, final) if scores else path


def viterbi_scan_ref(obs: torch.Tensor, lt: torch.Tensor, renorm: bool, *,
                     scores: bool = False):
    """Plain version of viterbi_scan, in obs's dtype on its device: a loop
    over frames of torch.max over the candidates score + lt (the JAX
    scans' operations, in their order), then a gather loop back along the
    decisions."""
    B, N, S = obs.shape
    if N < 1:
        raise ValueError("viterbi_scan: no frames")

    def renormed(s):
        return s - torch.amax(s, dim=-1, keepdim=True) if renorm else s

    score = renormed(obs[:, 0])
    back = torch.empty((N - 1, B, S), dtype=torch.int64, device=obs.device)
    best = torch.empty((B, S), dtype=torch.result_type(obs, lt),
                       device=obs.device)
    for t in range(1, N):
        torch.max(score[:, :, None] + lt, dim=1, out=(best, back[t - 1]))
        score = renormed(best + obs[:, t])
    path = torch.empty((B, N), dtype=torch.int64, device=obs.device)
    g = torch.argmax(score, dim=-1)
    path[:, N - 1] = g
    for t in range(N - 2, -1, -1):
        g = torch.gather(back[t], 1, g[:, None])[:, 0]
        path[:, t] = g
    return (path, score) if scores else path
