"""Frame-axis ("sequence") parallelism for single very long utterances
(counterpart of libllsm2_tpu/parallel/seqparallel.py).

Every rank of the mesh's frame axis runs the SAME analysis or synthesis,
on the card's kernels, on its contiguous block of frames extended by halo
frames; the halos are the neighbours' edge rows, which ride ppermute
(h rows each way).  The design splits by data rate, as the JAX package's:

  * SAMPLE-RATE stages (F0 refinement, the harmonic projection, the
    deconvolution, the residual render, band envelopes, warped PSD) run
    shard-local on the halo-extended block: a rank's work is N/S frames
    plus O(halo).
  * FRAME-RATE track stages: the track denoiser, whose noise statistics
    and frame-axis transforms are global by definition, runs on the
    all_gather-ed tracks ([N, K] floats, ~160x smaller than the signal)
    redundantly on every rank.
  * The fundamental cycle track needs a global prefix sum: each shard
    integrates its own block (harmonics.sample_cycles, the kernel) from a
    base, the exclusive prefix of the shards' totals (one all_gather of S
    float64 scalars).

SPMD: every rank calls analyze_frame_sharded / synthesize_frame_sharded
with the same arguments and gets the whole result (the frame-rate fields
all-gathered, the output signal gathered), as the JAX call returns the
global arrays to its caller.

Exactness: every stage equals the one-process pipeline except the
band-envelope filterbank's FFT masks, which are global (each shard
computes them on its halo-extended block: a truncation error that decays
into the halo), the envelope decimation, chosen from the block's FFT
size, and float reassociation where a library orders a sum by its
operand's shape.  Two repairs over the JAX package keep it so: the cycle
track's block offsets are exact float64 sums (_shard_cycles), and the F0
refinement's decimating FIR does not ring into the zero halo past the
signal (refine_f0's bounds), so the edge rows keep the one-process F0.
"""
from __future__ import annotations

import torch

from ..config import AnalysisOptions, SynthesisOptions
from ..container import Chunk, index_batch
from ..fp import FP
from ..models import layer0
from ..ops import harmonics, kernels
from .mesh import FRAME_AXIS, Mesh, all_gather, ppermute


# ---------------------------------------------------------------------------
# halo plumbing
# ---------------------------------------------------------------------------

def _halo(mesh: Mesh, blk: torch.Tensor, h: int) -> torch.Tensor:
    """(left, blk, right) along axis 0: left = the previous shard's last h
    rows, right = the next shard's first h rows, zeros at the global edges
    (the zero padding the one-process pipeline applies beyond the signal):
    two ppermutes, h rows each way."""
    if h == 0:
        return blk
    if h > blk.shape[0]:
        raise ValueError(f"halo of {h} rows over a block of {blk.shape[0]}")
    n = mesh.shape[FRAME_AXIS]
    left = ppermute(blk[-h:], mesh, FRAME_AXIS,
                    [(j, j + 1) for j in range(n - 1)])
    right = ppermute(blk[:h], mesh, FRAME_AXIS,
                     [(j + 1, j) for j in range(n - 1)])
    return torch.cat([left, blk, right])


def _slice_rows(v: torch.Tensor, i0: int, size: int, h: int) -> torch.Tensor:
    """Rows [i0 - h, i0 - h + size) of a global [N, ...] tensor, zero rows
    beyond its edges."""
    lo, hi = i0 - h, i0 - h + size
    part = v[max(lo, 0):min(hi, v.shape[0])]
    pad = lambda k: v.new_zeros((k,) + v.shape[1:])
    return torch.cat([pad(max(-lo, 0)), part, pad(max(hi - v.shape[0], 0))])


def _shard_cycles(mesh: Mesh, f0_ext: torch.Tensor, nhop: int, fs: float,
                  hb: int, nl: int) -> torch.Tensor:
    """Globally consistent mod-1 cycle track of the halo-extended block.

    sample_cycles (the kernel) integrates the block from a base: the
    cycles before the block's first sample, i.e. the exclusive prefix of
    the shards' core totals (one all_gather of S float64 scalars) less
    the left halo's hops.  The hop totals and their float64 sums are exact
    (kernels.cycle_totals), and the block takes the whole track's sample
    positions (start), so its core samples are the one-process track's
    bit for bit (the JAX package sums the mod-1 offsets in float32, ~1e-7
    cycles off: at harmonic 80 that moved the complex tracks by ~4e-5 on
    the CPU).  At the global edges the one-process pipeline (i)
    holds F0 constant over the LAST frame (its lerp's last segment ends
    there: F0 exactly, where a lerp into an edge-replicated halo rounds)
    and (ii) edge-replicates the track beyond the signal; the last block
    therefore stops at the signal's end, and both are reproduced bit for
    bit."""
    n, i = mesh.shape[FRAME_AXIS], mesh.index(FRAME_AXIS)
    last = i == n - 1
    n_ext = f0_ext.shape[0]
    n_cyc = hb + nl if last else n_ext
    core_s = hb * nhop
    f0_cyc = f0_ext[:n_cyc]
    start = i * nl - hb                 # the block's first frame, globally
    tot = kernels.cycle_totals(f0_cyc, nhop, fs, n_cyc * nhop, start)
    tots = all_gather(torch.sum(tot[hb:hb + nl])[None], mesh, FRAME_AXIS)
    base = torch.remainder(torch.sum(tots[:i]) - torch.sum(tot[:hb]), 1.0)
    cyc = harmonics.sample_cycles(f0_cyc[None], nhop, fs, n_cyc * nhop,
                                  base=base[None], start=start)[0]
    if i == 0:
        cyc[:core_s] = cyc[core_s].clone()
    if last:
        cyc = torch.cat([cyc, cyc[-1:].expand((n_ext - n_cyc) * nhop)])
    return cyc


def _shard_of(mesh: Mesh, v: torch.Tensor, nl: int) -> torch.Tensor:
    i = mesh.index(FRAME_AXIS)
    return v[i * nl:(i + 1) * nl]


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def _halos(opt: AnalysisOptions, nl: int):
    """The halo sizes (frames) of the JAX package's derivation: ha covers F0
    refinement (window + probe + decimation FIR) plus the refine smoothing;
    he the envelope filterbank's overlap-save; hr the back half's needs
    beyond the core; hb exact projection + deconvolution of the core (and
    it contains hr).  One-hop halos must fit in one neighbour shard."""
    conf = opt.conf
    hh = -(-conf.halfwin_max // conf.nhop)
    sm = max(opt.f0_refine_smooth, 1)
    ha = hh + 2 + (sm + 1) // 2
    he = 8
    hr = hh + he + 2
    hb = max((2 * hh + 2) * max(1, opt.hm_passes), hr)
    if max(ha, hb) >= nl:
        raise ValueError(
            f"frame-sharded analysis needs > {max(ha, hb)} frames per "
            f"shard (halo) -- got {nl}; use fewer devices or more frames")
    return ha, hr, hb, sm


def _analyze_local(opt: AnalysisOptions, mesh: Mesh, n_frm: int,
                   x_blk: torch.Tensor, f0_blk: torch.Tensor):
    """One rank's analysis of its block (x_blk [nl nhop], f0_blk [nl]),
    layer0._analyze stage by stage -> (f0 [N], ampl, phse, mask [N, K]
    gathered; psd, edc, eenv_a, eenv_p of this shard's core rows)."""
    conf = opt.conf
    nhop = conf.nhop
    nl = f0_blk.shape[0]
    ha, hr, hb, sm = _halos(opt, nl)
    one = lambda t: t[None]

    # --- stage A: F0 refinement (sample-rate, halo-local) ---
    f0 = f0_blk
    if opt.f0_refine:
        x_a = _halo(mesh, x_blk, ha * nhop)
        f0_a = _halo(mesh, f0_blk, ha)
        # the halos past the signal's edges: the refine's decimating FIR
        # must not ring into them (the one-process FIR output ends there)
        n, i = mesh.shape[FRAME_AXIS], mesh.index(FRAME_AXIS)
        bounds = (ha * nhop if i == 0 else 0,
                  (ha + nl) * nhop if i == n - 1 else x_a.shape[0])
        f0_ref = harmonics.refine_f0(
            one(x_a), one(f0_a), nhop=nhop, fs=conf.fs,
            halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
            f0_ceil=conf.f0_ceil, use_pallas=opt.use_pallas,
            bounds=bounds)[0]
        if sm > 1:
            voiced_m = (f0_a > 0).to(FP)
            num = layer0._moving_sum((f0_ref - f0_a) * voiced_m, sm)
            den = torch.clamp(layer0._moving_sum(voiced_m, sm), min=1.0)
            f0_ref = torch.where(voiced_m > 0, f0_a + num / den,
                                 torch.zeros_like(f0_a))
        f0 = f0_ref[ha:ha + nl]

    # --- stage B: harmonic tracks (sample-rate, halo-local) ---
    x_b = _halo(mesh, x_blk, hb * nhop)
    f0_b = _halo(mesh, f0, hb)
    cyc_b = _shard_cycles(mesh, f0_b, nhop, conf.fs, hb, nl)
    project = lambda x: harmonics.harmonic_analysis(
        one(x), one(f0_b), one(cyc_b), nhop=nhop, fs=conf.fs,
        max_k=conf.maxnhar, halfwin_max=conf.halfwin_max,
        rel_winsize=conf.rel_winsize, fnyq=conf.fnyq,
        use_pallas=opt.use_pallas, frame_chunk=opt.frame_chunk,
        mxu=opt.hm_kernel == "matmul")
    ampl, phse, mask = project(x_b)
    # the one-process pipeline's numeric route: the complex handoff to the
    # denoiser, the polar deconvolution, or the Gauss-Seidel passes
    cplx = layer0._complex_handoff(opt)
    if opt.hm_correction == "deconv" and opt.hm_passes <= 1:
        ampl, phse = layer0._deconv_correction(
            opt, one(f0_b), one(cyc_b), ampl, phse, mask,
            return_complex=cplx)
    for _ in range(max(opt.hm_passes - 1, 0)):
        da, dp, _ = project(layer0._residual(
            opt.use_pallas, one(cyc_b), ampl, phse, mask, nhop,
            one(x_b))[0])
        z = torch.polar(ampl, phse) + torch.polar(da, dp)
        ampl, phse = torch.abs(z) * mask, torch.angle(z) * mask

    # --- frame-rate track stages: gather, compute on every rank ---
    core = slice(hb, hb + nl)
    gather = lambda v: all_gather(v, mesh, FRAME_AXIS)
    a_g, p_g, m_g = (gather(v[0, core]) for v in (ampl, phse, mask))
    f0_g = gather(f0)
    cycc_g = gather(cyc_b[::nhop][core])
    if opt.track_denoise and opt.track_lowpass_hz <= 0.0:
        # with the complex handoff (a_g, p_g) hold the gathered (re, im)
        a, p = layer0._track_denoise(
            conf, one(f0_g), one(cycc_g), one(a_g), one(p_g), one(m_g),
            opt.track_denoise_hz, opt.track_denoise_strength,
            spectral=opt.track_denoise_spectral,
            a_spec=opt.track_spectral_strength,
            spec_decimate=opt.track_spectral_decimate,
            c_complex=(one(a_g), one(p_g)) if cplx else None,
            use_pallas=opt.use_pallas)
        a_g, p_g = a[0], p[0]
    if opt.track_lowpass_hz > 0.0:
        a, p = layer0._track_lowpass(conf, one(f0_g), one(cycc_g), one(a_g),
                                     one(p_g), one(m_g), opt.track_lowpass_hz,
                                     use_pallas=opt.use_pallas)
        a_g, p_g = a[0], p[0]

    # --- back half (sample-rate, halo-local): residual -> noise model ---
    i0 = mesh.index(FRAME_AXIS) * nl
    n_sl = nl + 2 * hr
    a_s, p_s, m_s, f0_s = (_slice_rows(v, i0, n_sl, hr)
                           for v in (a_g, p_g, m_g, f0_g))
    off = (hb - hr) * nhop
    nx_s = n_sl * nhop
    cyc_s = cyc_b[off:off + nx_s]
    residual = layer0._residual(opt.use_pallas, one(cyc_s), one(a_s),
                                one(p_s), one(m_s), nhop,
                                one(x_b[off:off + nx_s]))
    # the one-process residual exists only on [0, nx): zero the halo beyond
    # the global edges so the edge shards' PSD windows and envelope
    # filterbank see the same zeros
    gpos = torch.arange(nx_s, device=residual.device) + (i0 - hr) * nhop
    residual = torch.where((gpos < 0) | (gpos >= n_frm * nhop),
                           torch.zeros_like(residual), residual)
    D = layer0._env_decimation(conf, opt.env_decimate, nx_s)
    envs = layer0._band_envelopes(residual, conf, D)       # [1, C, nx_s/D]
    Cn, Ke = conf.nchannel, conf.maxnhar_e
    ea, ep, _, edc = harmonics.harmonic_analysis(
        envs.reshape(Cn, -1), one(f0_s).expand(Cn, -1), one(cyc_s[::D]),
        nhop=nhop // D, fs=conf.fs / D, max_k=Ke,
        halfwin_max=-(-conf.halfwin_max // D), rel_winsize=conf.rel_winsize,
        fnyq=min(conf.fnyq, 0.4 * conf.fs / D), with_dc=True,
        use_pallas=opt.use_pallas, frame_chunk=opt.frame_chunk)
    cs = slice(hr, hr + nl)
    edc = torch.clamp(edc, min=0.0).T[cs]                  # [nl, C]
    eenv_a = ea.transpose(0, 1)[cs]                        # [nl, C, Ke]
    eenv_p = ep.transpose(0, 1)[cs]
    psd = layer0._warped_psd(residual, n_sl, conf)[0, cs]
    return f0_g, a_g, p_g, m_g, psd, edc, eenv_a, eenv_p


def analyze_frame_sharded(opt: AnalysisOptions, x, f0, mesh: Mesh) -> Chunk:
    """Analysis of one utterance x [nx], f0 [N] (numpy or tensors, the same
    on every rank) with its frames partitioned over the mesh's frame axis:
    each rank analyzes its block of N / S frames plus halos on mesh.device
    and returns the whole chunk (no batch axis).  Requires
    N % S == 0, enough frames a shard to cover the halos, and
    hm_method="czt"."""
    if opt.hm_method != "czt":
        # the pp framing takes its window spans from the GLOBAL cycle
        # track, so its halo is data-dependent (unbounded at low F0)
        raise ValueError(
            "frame-sharded analysis supports hm_method='czt' only; "
            f"got {opt.hm_method!r} (pp framing needs data-dependent "
            "halos -- run it single-device)")
    layer0._check_analysis(opt)
    n_sh = mesh.shape[FRAME_AXIS]
    dev = mesh.device
    f0 = torch.as_tensor(f0).to(dev, FP)
    n_frm = f0.shape[0]
    if n_frm % n_sh:
        raise ValueError(f"{n_frm} frames do not split over {n_sh} shards")
    nl = n_frm // n_sh
    _halos(opt, nl)
    nhop = opt.conf.nhop
    nx = n_frm * nhop
    x = torch.as_tensor(x).to(dev, FP)[:nx]
    x = torch.nn.functional.pad(x, (0, nx - x.shape[0]))
    f0r, ampl, phse, mask, psd, edc, ea, ep = _analyze_local(
        opt, mesh, n_frm, _shard_of(mesh, x, nl * nhop),
        _shard_of(mesh, f0, nl))
    gather = lambda v: all_gather(v.contiguous(), mesh, FRAME_AXIS)
    return Chunk(f0=f0r, ampl=ampl, phse=phse, hm_mask=mask, psd=gather(psd),
                 edc=gather(edc), eenv_a=gather(ea), eenv_p=gather(ep),
                 conf=opt.conf)


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------

def _synth_local(opt: SynthesisOptions, mesh: Mesh, blk: Chunk):
    """One rank's synthesis of its block of frames: the oscillator bank and
    the WOLA noise shaper on the block extended by a 2-frame halo; each
    frame's noise spectrum is keyed by its GLOBAL index (_synth_noise's
    frame_base, -2 on the first shard), so the sharded render draws what
    the one-process render draws -> (y, y_sin, y_nos) of the core."""
    conf = blk.conf
    fs = opt.fs
    nhop = int(round(conf.thop * fs))
    nl = blk.f0.shape[0]
    hs = 2
    n_sh, idx = mesh.shape[FRAME_AXIS], mesh.index(FRAME_AXIS)
    last = idx == n_sh - 1

    def ext(v, edge_replicate_last=False):
        v_e = _halo(mesh, v, hs)
        if edge_replicate_last and last:
            # the lerp holds the LAST frame constant over its hop: rows
            # past the global end replicate the last real row
            v_e = v_e.clone()
            v_e[hs + nl:] = v_e[hs + nl - 1]
        return v_e

    f0_e = ext(blk.f0, True)
    n_ext = f0_e.shape[0]
    nx_e = n_ext * nhop
    cyc_e = _shard_cycles(mesh, f0_e, nhop, fs, hs, nl)
    K = blk.ampl.shape[-1]
    kharm = torch.arange(1, K + 1, dtype=FP, device=f0_e.device)
    f0s = torch.where(f0_e > 0, f0_e, torch.full_like(f0_e, 100.0))
    a_e, p_e = ext(blk.ampl), ext(blk.phse)
    m_e = ext(blk.hm_mask) * (kharm * f0s[:, None] < 0.5 * fs)
    if opt.use_pallas:
        y_sin = kernels.osc_bank(cyc_e[None], a_e[None], p_e[None],
                                 m_e[None], nhop)[0]
    else:
        y_sin = harmonics.overlap_add_half(harmonics.oscillator_bank(
            cyc_e[None], a_e[None], p_e[None], m_e[None], nhop=nhop), nhop,
            nx_e)[0]
    # noise: PSD rows beyond the global end stay ZERO (no band segments),
    # the envelope rows are edge-replicated.  eenv_p is CENTRE-referenced
    # and _env_coefs rotates it by -2 pi k cyc at each row's centre, so the
    # fake rows' phases are pre-advanced by the centre-cycle delta and the
    # ROTATED coefficients replicate the last real row
    eenv_p_e = ext(blk.eenv_p)
    if last:
        Ke = eenv_p_e.shape[-1]
        ke = torch.arange(1, Ke + 1, dtype=FP, device=f0_e.device)
        cyc_c = cyc_e[::nhop]
        dphi = cyc_c - cyc_c[hs + nl - 1]
        fill = (eenv_p_e[hs + nl - 1][None]
                + 2.0 * torch.pi * ke * dphi[:, None, None])
        eenv_p_e = torch.cat([eenv_p_e[:hs + nl], fill[hs + nl:]])
    chunk_e = Chunk(f0=f0_e, ampl=a_e, phse=p_e, hm_mask=m_e,
                    psd=ext(blk.psd), edc=ext(blk.edc, True),
                    eenv_a=ext(blk.eenv_a, True), eenv_p=eenv_p_e, conf=conf)
    y_nos = layer0._synth_noise(index_batch(chunk_e, None), cyc_e[None],
                                nhop, fs, opt.noise_seed,
                                frame_base=idx * nl - hs,
                                use_pallas=opt.use_pallas,
                                idft=opt.noise_idft)[0]
    core = slice(hs * nhop, (hs + nl) * nhop)
    return y_sin[core] + y_nos[core], y_sin[core], y_nos[core]


def synthesize_frame_sharded(sopt: SynthesisOptions, chunk: Chunk,
                             mesh: Mesh) -> layer0.SynthResult:
    """Synthesis of one chunk (no batch axis, the same on every rank) with
    its frames partitioned over the mesh's frame axis (2-frame halos;
    per-frame keyed noise spectra make the render shard-count-invariant)
    -> the whole SynthResult on every rank, on mesh.device."""
    n_sh = mesh.shape[FRAME_AXIS]
    n_frm = chunk.nfrm
    if n_frm % n_sh:
        raise ValueError(f"{n_frm} frames do not split over {n_sh} shards")
    nl = n_frm // n_sh
    if nl <= 2:
        raise ValueError("frame-sharded synthesis needs > 2 frames per "
                         "shard (halo)")
    conf = chunk.conf
    if abs(conf.thop * sopt.fs - round(conf.thop * sopt.fs)) >= 1e-6:
        raise ValueError("frame-sharded synthesis needs an integral hop at "
                         "the output rate")
    dev = mesh.device
    blk = chunk.map(lambda v: _shard_of(mesh, v.to(dev, FP), nl))
    y, y_sin, y_nos = (all_gather(v, mesh, FRAME_AXIS)
                       for v in _synth_local(sopt, mesh, blk))
    return layer0.SynthResult(y=y, y_sin=y_sin, y_nos=y_nos, fs=sopt.fs)
