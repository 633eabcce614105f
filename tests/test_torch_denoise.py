"""The port's harmonic-track denoiser against the JAX package's Pallas
branch (interpret mode on the CPU), on identical numpy inputs: the plain
twins of the two denoiser kernels against denoise_stats_pallas /
denoise_apply_pallas, the floor statistics, the spectral gate (D = 1 and
D = 4), the whole _track_denoise and _track_lowpass on the hard fixture of
test_pallas.py, and batch independence of every per-utterance statistic.
test_torch_cuda.py holds each kernel against its twin on a CUDA card."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libllsm2_tpu import create_aoptions
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.ops import harmonics as jhm
from libllsm2_tpu.ops import pallas_osc
from libllsm2_tpu.utils import testsig

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.ops import _build, kernels
from libllsm2_tpu_torch.models import layer0 as tl0
from test_torch_cuda import (STATS_NAMES, TAPS1, TAPS2, T, _apply_inputs,
                             _stats_inputs)

torch.set_num_threads(1)

J = lambda a: jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("complex_input", [True, False])
@pytest.mark.parametrize("N", [160, 1024, 150])
def test_denoise_stats_plain_matches_pallas(N, complex_input):
    """N = 160 is one halo-free block of the Pallas kernel, N = 1024 eight
    (interior halos and both edge masks), N = 150 the zero-padded path.
    The first and last 8 frames of pp are where the kernel's zero-input
    edge rows (c_s tail, r_inc = -c_s) reach the probe FIR."""
    a, p, cyc_c, mask, voiced = _stats_inputs(N, 24, N, complex_input)
    ref = [np.asarray(v) for v in pallas_osc.denoise_stats_pallas(
        J(a), J(p), J(cyc_c), J(mask), J(voiced), TAPS1, TAPS2,
        complex_input=complex_input)]
    got = [v[0].numpy() for v in kernels.denoise_stats(
        *(T(v)[None] for v in (a, p, cyc_c, mask, voiced)), TAPS1, TAPS2,
        complex_input=complex_input)]
    for name, g, r in zip(STATS_NAMES, got, ref):
        if name == "guard":
            np.testing.assert_array_equal(g, r)
        else:   # float32 sums over k in another order: ~1e-7 relative
            np.testing.assert_allclose(g, r, atol=2e-5, rtol=1e-4,
                                       err_msg=name)
    for rows in (slice(0, 8), slice(N - 8, N)):
        np.testing.assert_allclose(got[0][rows], ref[0][rows], atol=2e-5,
                                   rtol=1e-4)
    assert ref[0][-8:].any() and not ref[3][-8:].any()


def _apply_against_pallas(spectral, B, Nf, K, seed):
    """The port's pass B (denoise_apply, and with spectral denoise_finish on
    a random gate delta, zero on unguarded rows as the gate's) against
    denoise_apply_pallas and the JAX host's combine, rotation and polar
    form (layer0.py:680-681 and 699-702), utterance by utterance."""
    args = _apply_inputs(B, Nf, K, seed)
    cyc_c, mask, guard = args[4], args[5], args[6]
    rng = np.random.default_rng(seed + 100)
    delta = (0.1 * (rng.standard_normal((B, Nf, K))
                    + 1j * rng.standard_normal((B, Nf, K)))
             * guard[..., None]).astype(np.complex64)
    if spectral:
        a, full = kernels.denoise_apply(*map(T, args), 8.0, spectral=True)
        assert a.dtype == full.dtype == torch.complex64
        ampl, phse = kernels.denoise_finish(a, T(delta), T(cyc_c), T(mask))
    else:
        ampl, phse = kernels.denoise_apply(*map(T, args), 8.0)
    for b in range(B):
        ref = pallas_osc.denoise_apply_pallas(*(J(x[b]) for x in args), 8.0,
                                              emit_resid=spectral)
        re, im = ref[0], ref[1]
        if spectral:
            ur, ui = ref[4], ref[5]
            d = J(delta[b])
            re = re + d.real * ur - d.imag * ui
            im = im + d.real * ui + d.imag * ur
            np.testing.assert_allclose(
                full[b].numpy(), np.asarray(ref[2]) + 1j * np.asarray(ref[3]),
                atol=2e-5, rtol=1e-5)
        a_j = np.asarray(jnp.sqrt(re * re + im * im)) * mask[b]
        p_j = np.asarray(jnp.arctan2(im, re)) * mask[b]
        np.testing.assert_allclose(ampl[b].numpy(), a_j, atol=2e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            ampl[b].numpy() * np.exp(1j * phse[b].numpy()),
            a_j * np.exp(1j * p_j), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("spectral", [False, True])
def test_denoise_apply_plain_matches_pallas(spectral):
    """Two utterances with their own floors v and fit weights wmul; both
    modes (the time gate alone: (ampl, phse) from the one launch; the
    spectral mode: the aligned track and full, then the finish)."""
    _apply_against_pallas(spectral, 2, 300, 24, 7)


@pytest.mark.parametrize("spectral", [False, True])
def test_denoise_apply_plain_matches_pallas_odd_k(spectral):
    """K = 81 (not a multiple of the kernel's float4 slots), one utterance
    of 37 frames."""
    _apply_against_pallas(spectral, 1, 37, 81, 5)


@pytest.fixture(scope="module")
def hard():
    """The hard fixture of test_pallas.py (female, seed 3, breath noise
    0.05, 20% unvoiced tail, f0_floor 65) and its clean twin, analyzed by
    the JAX package with the denoiser off, plus the JAX Pallas branch's
    denoiser intermediates on the noisy one."""
    opt = dataclasses.replace(create_aoptions(f0_floor=65.0),
                              track_denoise=False)
    rows = {}
    for name, nl in (("noisy", 0.05), ("clean", 0.0)):
        x, f0, _ = testsig.synth_hard_utterance(
            duration=0.8, register="female", seed=3, noise_level=nl,
            unvoiced_tail_frac=0.2)
        ch = jl0.analyze(opt, x, f0)
        nhop, N = opt.conf.nhop, ch.nfrm
        cyc = jhm.sample_cycles(jnp.asarray(ch.f0), nhop, opt.conf.fs,
                                N * nhop)
        rows[name] = dict(f0=np.asarray(ch.f0), ampl=np.asarray(ch.ampl),
                          phse=np.asarray(ch.phse),
                          mask=np.asarray(ch.hm_mask),
                          cyc=np.asarray(cyc),
                          cyc_c=np.asarray(cyc)[::nhop][:N])
    n = rows["noisy"]
    m = jnp.asarray(n["mask"], jnp.float32)
    voiced = (jnp.asarray(n["f0"]) > 0).astype(jnp.float32)[:, None]
    pp, cs2, r2, gd, cre, cim, csr, csi = pallas_osc.denoise_stats_pallas(
        J(n["ampl"]), J(n["phse"]), J(n["cyc_c"]), m, voiced, TAPS1, TAPS2)
    ok = gd[:, None] & (m > 0)
    stats_in = (pp, cs2 * m, r2, J(n["ampl"]) ** 2 * m, ok)
    v, wmul = jl0._denoise_floor_stats(*stats_in)
    outs = pallas_osc.denoise_apply_pallas(cre, cim, csr, csi,
                                           J(n["cyc_c"]), m, gd, v, wmul,
                                           8.0, emit_resid=True)
    gate_in = dict(c_s=np.asarray(csr + 1j * csi),
                   full=np.asarray(outs[2] + 1j * outs[3]),
                   pp=np.asarray(pp), guard=np.asarray(gd)[:, None],
                   v=np.asarray(v), mask=n["mask"])
    return dict(conf=opt.conf, rows=rows, gate_in=gate_in,
                stats_in=[np.asarray(s) for s in stats_in],
                v=np.asarray(v), wmul=np.asarray(wmul))


def test_denoise_floor_stats_matches(hard):
    got = tl0._denoise_floor_stats(*(T(s)[None] for s in hard["stats_in"]))
    assert (hard["v"] > 0).sum() >= 3      # the floor is live on this input
    np.testing.assert_allclose(got[0][0].numpy(), hard["v"], rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(got[1][0].numpy(), hard["wmul"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("D", [1, 4])
def test_spectral_gate_matches(hard, D):
    g = hard["gate_in"]
    c_s = g["c_s"]
    # the gate must engage, or the comparison proves nothing
    gd = g["guard"] & (g["mask"] > 0)
    p_bar = np.where(gd, np.abs(c_s) ** 2, 0).sum(0) / np.maximum(gd.sum(0), 1)
    engaged = (g["v"] > 10 ** -1.5 * p_bar) & g["mask"].any(0)
    assert engaged.sum() >= 3 and (g["v"] > 0).any()
    conf = hard["conf"]
    ref = np.asarray(jl0._spectral_gate(
        J(c_s), J(g["full"]), J(g["pp"]), J(g["guard"]), J(g["v"]),
        J(g["mask"]), conf.thop, 15.0, 3.0, decimate=D))
    got = tl0._spectral_gate(
        *(T(g[k])[None] for k in ("c_s", "full", "pp", "guard", "v", "mask")),
        conf.thop, 15.0, 3.0, decimate=D)[0].numpy()
    scale = np.abs(c_s).max()
    assert np.abs(ref).max() > 1e-3 * scale   # the gate moved the track
    np.testing.assert_allclose(got, ref, atol=1e-5 * scale)


def _denoise_args(r, c_complex):
    if c_complex:
        cr = (r["ampl"] * np.cos(r["phse"])).astype(np.float32)
        ci = (r["ampl"] * np.sin(r["phse"])).astype(np.float32)
        return None, None, (cr, ci)
    return r["ampl"], r["phse"], None


def _port_denoise(conf, rows, spectral, c_complex):
    """The port's _track_denoise on a batch of fixture rows."""
    st = lambda k: torch.tensor(np.stack([r[k] for r in rows]))
    a, p, cc = zip(*(_denoise_args(r, c_complex) for r in rows))
    cc = None if cc[0] is None else tuple(
        torch.tensor(np.stack(v)) for v in zip(*cc))
    return tl0._track_denoise(
        conf, st("f0"), st("cyc_c"), None if a[0] is None else st("ampl"),
        None if p[0] is None else st("phse"), st("mask"), 15.0, 8.0,
        spectral=spectral, spec_decimate=4, c_complex=cc)


@pytest.mark.parametrize("c_complex", [True, False])
@pytest.mark.parametrize("spectral", [True, False])
def test_track_denoise_matches_pallas_branch(hard, spectral, c_complex):
    """Both run the same float32 formulas on the CPU and agree to ~1.2e-6 x
    scale (no threshold flips on this fixture), so the tolerance is 1e-5 x
    scale, tighter than test_pallas.py:460-466's 2e-3 / 3e-3 x scale
    between the Pallas and jnp branches."""
    r, conf = hard["rows"]["noisy"], hard["conf"]
    nhop = conf.nhop
    N = len(r["f0"])
    a, p, cc = _denoise_args(r, c_complex)
    a_j, p_j = map(np.asarray, jl0._track_denoise(
        conf, J(r["f0"]), J(r["cyc"]), jnp.arange(N, dtype=jnp.int32) * nhop,
        None if a is None else J(a), None if p is None else J(p),
        J(r["mask"]), 15.0, 8.0, use_pallas=True, spectral=spectral,
        a_spec=3.0, spec_decimate=4,
        c_complex=None if cc is None else tuple(map(J, cc))))
    a_t, p_t = (v[0].numpy() for v in _port_denoise(conf, [r], spectral,
                                                     c_complex))
    scale = np.abs(a_j).max()
    assert np.abs(a_j - r["ampl"]).max() > 5e-3 * scale   # it denoised
    np.testing.assert_allclose(a_t, a_j, atol=1e-5 * scale)
    np.testing.assert_allclose(a_t * np.exp(1j * p_t), a_j * np.exp(1j * p_j),
                               atol=1e-5 * scale)


def test_track_denoise_batch_rows_are_independent(hard):
    """A noisy and a clean utterance in one batch give each row's own
    single-row result: no statistic reduces across the batch."""
    conf = hard["conf"]
    rows = [hard["rows"]["noisy"], hard["rows"]["clean"]]
    a2, p2 = _port_denoise(conf, rows, True, True)
    for b, r in enumerate(rows):
        a1, p1 = _port_denoise(conf, [r], True, True)
        np.testing.assert_allclose(a2[b].numpy(), a1[0].numpy(), atol=1e-6)
        np.testing.assert_allclose(
            (a2[b] * torch.exp(1j * p2[b])).numpy(),
            (a1[0] * torch.exp(1j * p1[0])).numpy(), atol=1e-6)


def test_track_lowpass_matches(hard):
    r, conf = hard["rows"]["noisy"], hard["conf"]
    N = len(r["f0"])
    a_j, p_j = map(np.asarray, jl0._track_lowpass(
        conf, J(r["f0"]), J(r["cyc"]),
        jnp.arange(N, dtype=jnp.int32) * conf.nhop, J(r["ampl"]),
        J(r["phse"]), J(r["mask"]), 30.0))
    a_t, p_t = (v[0].numpy() for v in tl0._track_lowpass(
        conf, *(T(r[k])[None] for k in ("f0", "cyc_c", "ampl", "phse",
                                        "mask")), 30.0))
    scale = np.abs(a_j).max()
    np.testing.assert_allclose(a_t, a_j, atol=1e-5 * scale)
    np.testing.assert_allclose(a_t * np.exp(1j * p_t), a_j * np.exp(1j * p_j),
                               atol=1e-5 * scale)


def test_complex_handoff_predicate():
    opt = tpkg.create_aoptions(use_pallas=True)
    assert tl0._complex_handoff(opt)
    for change in (dict(track_denoise=False), dict(track_lowpass_hz=30.0),
                   dict(hm_passes=2), dict(hm_correction="none"),
                   dict(hm_method="pp")):
        assert not tl0._complex_handoff(dataclasses.replace(opt, **change))


def test_denoise_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def no_build():
        raise AssertionError("CPU call reached the CUDA build")
    monkeypatch.setattr(_build, "library", no_build)
    kernels.reset_launches()
    a, p, cyc_c, mask, voiced = (T(v)[None] for v in
                                 _stats_inputs(64, 8, 1, True))
    kernels.denoise_stats(a, p, cyc_c, mask, voiced, TAPS1, TAPS2,
                          complex_input=True)
    a, full = kernels.denoise_apply(*map(T, _apply_inputs(1, 64, 8, 2)), 8.0,
                                    spectral=True)
    kernels.denoise_finish(a, full, cyc_c, mask)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    # a 2 ms hop's 33 + 17 taps: the Pallas kernel takes them (h1 + 2 h2 =
    # 32 under its 64-frame block at N = 64), and so does the port, with
    # the JAX package's results
    t33, t17 = tuple(tl0._hann_taps(33)), tuple(tl0._hann_taps(17))
    inputs = _stats_inputs(64, 8, 1, True)
    ref = pallas_osc.denoise_stats_pallas(*map(J, inputs), t33, t17,
                                          complex_input=True)
    got = kernels.denoise_stats(*(T(v)[None] for v in inputs), t33, t17,
                                complex_input=True)
    for name, g, r in zip(STATS_NAMES, got, ref):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(r), atol=2e-5,
                                   rtol=1e-4, err_msg=name)
    # past the Pallas kernel's own limit (h1 + 2 h2 = 16 + 48 = 64, its
    # block at N = 64) both refuse
    t49 = tuple(tl0._hann_taps(49))
    with pytest.raises(AssertionError, match="halo"):
        pallas_osc.denoise_stats_pallas(*map(J, inputs), t33, t49,
                                        complex_input=True)
    with pytest.raises(ValueError, match="64-frame block"):
        kernels.denoise_stats(a, p, cyc_c, mask, voiced, t33, t49)
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
