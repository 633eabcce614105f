"""The decimated and the full-rate F0 refine's kernel wrappers and plain
twins (kernels.refine_f0_dec / refine_f0_dec_ref, refine_f0_full /
refine_f0_full_ref) against the JAX package, their launch geometry, and
the last public names of the port (warp, the mesh layouts, the
subpackage namespaces) against the JAX package's (CPU, float32)."""
import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libllsm2_tpu import config as jconfig
from libllsm2_tpu.ops import harmonics as jhm
from libllsm2_tpu.ops import warp as jwarp
from libllsm2_tpu.utils import testsig as jtestsig

from libllsm2_tpu_torch import config as tconfig
from libllsm2_tpu_torch.ops import harmonics as thm
from libllsm2_tpu_torch.ops import kernels
from libllsm2_tpu_torch.ops import warp as twarp
from libllsm2_tpu_torch.utils import testsig as ttestsig

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a, np.float32))
ROOT = Path(__file__).resolve().parent.parent


def _dec_kw(conf, nx):
    """refine_f0_dec's arguments for conf's refine of nx samples."""
    D, taps, g, pass_hz = thm.refine_decimation(conf.nhop, nx, conf.fs,
                                                conf.f0_ceil)
    assert D > 1
    return taps, dict(D=D, g=g, nhop=conf.nhop, fs=conf.fs,
                      halfwin_max=conf.halfwin_max,
                      rel_winsize=conf.rel_winsize, window="hanning",
                      iters=2, max_rel_dev=0.05, pass_hz=pass_hz)


def _rows(conf, tail, duration=0.4):
    rows = [jtestsig.make_test_utterance(duration=duration, seed=s,
                                         noise_level=nl,
                                         unvoiced_tail_frac=tail)
            for s, nl in ((0, 0.0), (3, 0.05))]
    nfrm = len(rows[0][1])
    x = np.stack([r[0][:nfrm * conf.nhop] for r in rows]).astype(np.float32)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    return x, f0


@pytest.mark.parametrize("tail", [0.0, 0.3])
def test_refine_f0_dec_ref_matches_jax_decimated(tail):
    """The twin, called directly on test_torch_ops.py's decimated-refine
    fixtures, is the JAX package's decimated branch within rtol 1e-4;
    unvoiced frames stay 0."""
    conf = jconfig.ChunkConf(f0_floor=90.0)
    x, f0 = _rows(conf, tail)
    taps, kw = _dec_kw(conf, x.shape[1])
    centers = jnp.arange(f0.shape[1], dtype=jnp.int32) * conf.nhop
    for b in range(2):
        got = kernels.refine_f0_dec_ref(T(x[b:b + 1]), T(f0[b:b + 1]), taps,
                                        **kw)[0].numpy()
        ref = np.asarray(jhm.refine_f0(
            jnp.asarray(x[b]), jnp.asarray(f0[b]), centers, fs=conf.fs,
            halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
            f0_ceil=conf.f0_ceil, use_pallas=True, nhop=conf.nhop))
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        assert np.all(got[f0[b] == 0] == 0)


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_refine_f0_dec_ref_block_with_bounds_equals_whole_row(where):
    """A frame shard's hop-aligned block of a 1.5 s bench row (f0_floor
    70), with 10 frames of halo on each side (zeros past the signal's
    edges, fenced off by bounds), refines its core frames to the whole
    row's F0 through the twin on the CPU within 1e-6 relative: the CPU's
    sums of a shorter row and its SLEEF / libm tails move a frame or two
    by an ulp (1.2e-7).  On the card the kernel gives the bits
    (tests/test_torch_cuda.py)."""
    conf = tconfig.create_aoptions(f0_floor=70.0).conf
    nhop = conf.nhop
    (x, f0, _), = ttestsig.make_test_utterances([(1, 0.05)], duration=1.5)
    N = len(f0)
    x = np.pad(x, (0, max(N * nhop - len(x), 0)))[:N * nhop]
    taps, kw = _dec_kw(conf, N * nhop)
    whole = kernels.refine_f0_dec_ref(T(x[None]), T(f0[None]), taps, **kw)[0]
    h = 10
    a, b = {"first": (0, 60), "middle": (60, 120), "last": (120, N)}[where]
    lo_f, hi_f = a - h, b + h
    pad_l, pad_r = max(-lo_f, 0), max(hi_f - N, 0)
    xb = np.pad(x[max(lo_f, 0) * nhop:min(hi_f, N) * nhop],
                (pad_l * nhop, pad_r * nhop))
    fb = np.pad(f0[max(lo_f, 0):min(hi_f, N)], (pad_l, pad_r))
    bounds = (pad_l * nhop, len(xb) - pad_r * nhop)
    _, kw_b = _dec_kw(conf, len(xb))
    block = kernels.refine_f0_dec_ref(T(xb[None]), T(fb[None]), taps,
                                      bounds=bounds, **kw_b)[0]
    np.testing.assert_allclose(block[h:h + b - a].numpy(),
                               whole[a:b].numpy(), rtol=1e-6, atol=0)
    assert torch.equal(block[h:h + b - a] == 0, whole[a:b] == 0)


def test_refine_f0_dec_cpu_runs_the_twin_and_launches_nothing(monkeypatch):
    """CPU tensors reach the plain twin, whatever the batch: no library is
    built and no launch counted; refine_f0 on the CPU calls the twin once
    a row; a window the kernel lacks is refused on every device."""
    conf = jconfig.ChunkConf(f0_floor=90.0)
    x, f0 = _rows(conf, 0.0)
    taps, kw = _dec_kw(conf, x.shape[1])

    def no_build():
        raise AssertionError("the CPU path built the kernel library")
    monkeypatch.setattr(kernels._build, "library", no_build)
    calls = []
    twin = kernels.refine_f0_dec_ref
    monkeypatch.setattr(kernels, "refine_f0_dec_ref",
                        lambda *a, **k: calls.append(a[0].shape) or
                        twin(*a, **k))
    before = dict(kernels.LAUNCHES)
    got = kernels.refine_f0_dec(T(x), T(f0), taps, **kw)
    assert torch.equal(got, twin(T(x), T(f0), taps, **kw))
    thm.refine_f0(T(x), T(f0), nhop=conf.nhop, fs=conf.fs,
                  halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
                  f0_ceil=conf.f0_ceil)
    assert kernels.LAUNCHES == before
    assert calls == [(2, x.shape[1]), (1, x.shape[1]), (1, x.shape[1])]
    with pytest.raises(ValueError, match="window"):
        kernels.refine_f0_dec(T(x), T(f0), taps, **dict(kw, window="kaiser"))


def _full_rows(window_f0=True):
    """Two 0.4 s rows at 11 kHz (hop 55: the full-rate branch), the second
    noisy with its last 30% unvoiced; with window_f0, row 0's F0 set to
    62 Hz on frames 5-11 (hw clamped to H = 315) and 590 Hz on frames
    20-25 (near f0_ceil), and its first and last 3 frames voiced."""
    conf = jconfig.ChunkConf(fs=11000.0, fnyq=5500.0, f0_floor=70.0)
    rows = [jtestsig.make_test_utterance(duration=0.4, fs=conf.fs, seed=s,
                                         noise_level=nl,
                                         unvoiced_tail_frac=tail)
            for s, nl, tail in ((0, 0.0, 0.0), (3, 0.05, 0.3))]
    nfrm = len(rows[0][1])
    x = np.stack([r[0][:nfrm * conf.nhop] for r in rows]).astype(np.float32)
    f0 = np.stack([r[1] for r in rows]).astype(np.float32)
    if window_f0:
        f0[0, 5:12] = 62.0
        f0[0, 20:26] = 590.0
        f0[0, :3] = 130.0
        f0[0, -3:] = 140.0
    return conf, x, f0


def _full_kw(conf, window="hanning"):
    return dict(nhop=conf.nhop, fs=conf.fs, halfwin_max=conf.halfwin_max,
                rel_winsize=conf.rel_winsize, window=window, iters=2,
                max_rel_dev=0.05)


@pytest.mark.parametrize("window", ["hanning", "blackman_harris", "mltsine"])
def test_refine_f0_full_ref_matches_jax_full_rate(window):
    """The full-rate twin, called directly, against the JAX package's
    full-rate branch (harmonic_project_pallas at K = 1 in interpret mode)
    at fs 11000 (hop 55, odd: no decimation), with unvoiced frames, F0 at
    the floor (hw = H) and near f0_ceil, voiced frames at both edges, and
    a cosine-series window or mltsine: rtol 1e-4 (test_torch_ops.py's
    refine tolerance; the twin's float32 sums in PyTorch's order against
    the Pallas kernel's); unvoiced frames stay 0."""
    conf, x, f0 = _full_rows()
    assert thm.refine_decimation(conf.nhop, x.shape[1], conf.fs,
                                 conf.f0_ceil)[0] == 1
    kw = _full_kw(conf, window)
    centers = jnp.arange(f0.shape[1], dtype=jnp.int32) * conf.nhop
    assert conf.halfwin_max == 315
    for b in range(2):
        got = kernels.refine_f0_full_ref(T(x[b:b + 1]), T(f0[b:b + 1]),
                                         **kw)[0].numpy()
        ref = np.asarray(jhm.refine_f0(
            jnp.asarray(x[b]), jnp.asarray(f0[b]), centers, fs=conf.fs,
            halfwin_max=conf.halfwin_max, rel_winsize=conf.rel_winsize,
            window=window, f0_ceil=conf.f0_ceil, use_pallas=True,
            nhop=conf.nhop))
        np.testing.assert_allclose(got, ref, rtol=1e-4)
        assert np.all(got[f0[b] == 0] == 0)
        assert np.all(got[f0[b] > 0] > 0)


def test_refine_f0_full_cpu_runs_the_twin_and_launches_nothing(monkeypatch):
    """CPU tensors reach the full-rate twin: no library is built and no
    launch counted; refine_f0 on the CPU at 11 kHz takes the full-rate
    branch and calls the twin once a row; a window the kernel lacks is
    refused on every device."""
    conf, x, f0 = _full_rows(window_f0=False)
    kw = _full_kw(conf)

    def no_build():
        raise AssertionError("the CPU path built the kernel library")
    monkeypatch.setattr(kernels._build, "library", no_build)
    calls = []
    twin = kernels.refine_f0_full_ref
    monkeypatch.setattr(kernels, "refine_f0_full_ref",
                        lambda *a, **k: calls.append(a[0].shape) or
                        twin(*a, **k))
    before = dict(kernels.LAUNCHES)
    got = kernels.refine_f0_full(T(x), T(f0), **kw)
    assert torch.equal(got, twin(T(x), T(f0), **kw))
    out = thm.refine_f0(T(x), T(f0), nhop=conf.nhop, fs=conf.fs,
                        halfwin_max=conf.halfwin_max,
                        rel_winsize=conf.rel_winsize, f0_ceil=conf.f0_ceil)
    # a row a call against one call of both rows: the CPU's vector tails
    # (SLEEF or libm) differ by an ulp (harmonics.refine_f0 says why)
    torch.testing.assert_close(out, got, rtol=1e-6, atol=0)
    assert kernels.LAUNCHES == before
    assert calls == [(2, x.shape[1]), (1, x.shape[1]), (1, x.shape[1])]
    with pytest.raises(ValueError, match="window"):
        kernels.refine_f0_full(T(x), T(f0), **dict(kw, window="kaiser"))


def _check_full_geometry(B, N, nhop, H, sms=132):
    """kernels._refine_geometry at D = 1 for B rows of N frames at hop
    nhop and halfwin_max H: a listed block of whole warps, a thread a frame
    only at an odd hop and where the batch gives two blocks an SM, each
    block's S = (F - 1) nhop + 2 (H + delta) + 1 staged samples covering
    both probes' reach around each of its frames, and smem = 4 S bytes
    within the card's 227 KB -> the geometry."""
    dm = kernels._refine_full_dims(nhop, 11000.0, H)
    delta, C, Wf = dm["delta"], dm["C"], dm["Wf"]
    assert delta == max(H // 8, 2) and C == H + delta and Wf == 2 * C + 1
    geo = kernels._refine_geometry(B, N, 1, 0, dm, sms)
    F, G, T, S = (geo[k] for k in ("F", "G", "T", "S"))
    assert (F, G) in kernels._REFINE_BLOCKS and T == F * G
    assert T % 32 == 0 and T <= 128
    assert geo["grid"] == (-(-N // F), B)
    assert (G == 1) == (nhop % 2 == 1 and B * -(-N // 128) >= 2 * sms)
    assert S == (F - 1) * nhop + Wf and geo["words"] == S
    assert geo["smem"] == 4 * S <= 227 * 1024
    for n0 in range(0, N, F):
        m0 = n0 * nhop - C                 # the block's staged sample 0
        n = np.arange(n0, min(n0 + F, N))
        assert (n * nhop - delta - H >= m0).all()
        assert (n * nhop + delta + H < m0 + S).all()
    return geo


@pytest.mark.parametrize("B,N,nhop,H,want", [
    (128, 1600, 55, 315, (128, 1, 30776)),     # phase 7: S = 127 55 + 709
    (2, 1600, 55, 315, (8, 16, 4376)),         # phase 3's 2 rows
    (1, 200, 55, 315, (2, 16, 3056)),          # phase 8: a 1 s file
    (1, 160, 55, 315, (2, 16, 3056)),          # a RTAnalyzer block
    (128, 1600, 56, 315, (8, 16, 4404)),       # an even hop: 16 lanes
    (64, 1563, 45, 550, (128, 1, 27808))])     # 9 kHz at f0_floor 40
def test_refine_full_geometry_and_shared_memory(B, N, nhop, H, want):
    """The D = 1 geometry and its shared bytes, counted by hand: (F, G,
    smem) for the 11 kHz bench batch (a thread a frame), 2 rows, a 1 s
    file and a RTAnalyzer block (16 lanes a frame), an even hop (16 lanes
    a frame at any batch) and a longer window; the wrapper's launch
    arguments carry F and G."""
    geo = _check_full_geometry(B, N, nhop, H)
    assert (geo["F"], geo["G"], geo["smem"]) == want


def test_kernel_ops_counts_the_full_rate_refine():
    """chip_smoke.kernel_ops for refine_f0_full on a hand-counted case:
    hanning (one cosine term: a column 4 + 22 + 3 + 20 = 49 operations),
    fs 1000, rel_winsize 4, H 30, F0 (0, 100, 200) Hz: hw 20 and 10, so
    41 + 21 = 62 columns, each 2 iterations x (49 + 8) and the gate's 49 +
    4: 62 x 167 operations; the unvoiced frame none."""
    import chip_smoke
    x = torch.zeros(1, 300)
    f0 = torch.tensor([[0.0, 100.0, 200.0]])
    kw = dict(nhop=100, fs=1000.0, halfwin_max=30, rel_winsize=4.0,
              window="hanning", iters=2, max_rel_dev=0.05)
    assert chip_smoke.kernel_ops(torch, "refine_f0_full", (x, f0),
                                 kw) == 62 * 167
    f0 = torch.tensor([[10.0, 100.0, 0.0]])        # hw 200 clamps to H 30
    assert chip_smoke.kernel_ops(torch, "refine_f0_full", (x, f0),
                                 kw) == (61 + 41) * 167


# the rates and floors the library takes (thop 0.005): (fs, f0_floor)
REFINE_CONFS = [(16000.0, 70.0), (16000.0, 40.0), (11025.0, 40.0),
                (22050.0, 40.0), (44100.0, 40.0), (48000.0, 40.0)]


def _refine_conf(fs, f0_floor, N=1600):
    """-> (conf, D, ntaps, _refine_dims) of conf's refine of N frames."""
    conf = tconfig.ChunkConf(fs=fs, f0_floor=f0_floor, thop=0.005)
    nx = N * conf.nhop
    D, taps, g, _ = thm.refine_decimation(conf.nhop, nx, conf.fs,
                                          conf.f0_ceil)
    if D == 1:
        return conf, D, 0, None
    return conf, D, len(taps), kernels._refine_dims(nx, D, conf.nhop,
                                                    conf.fs,
                                                    conf.halfwin_max)


@pytest.mark.parametrize("fs,f0_floor", REFINE_CONFS)
def test_refine_probes_stay_inside_the_frame(fs, f0_floor):
    """Every conf the library accepts: where the refine decimates (D > 1)
    no probe column falls left of the frame (C - delta >= H_d) and at most
    the +delta probe's last column, where the window weighs 0, past its
    right end (C + delta + H_d <= Wf); 11025 Hz (hop 55) is not decimated
    and takes the full-rate path."""
    conf, D, ntaps, dm = _refine_conf(fs, f0_floor)
    if fs == 11025.0:
        assert D == 1 and conf.nhop == 55
        return
    assert D in (2, 4, 8) and ntaps % 2 == 1
    assert dm["C"] - dm["delta_d"] >= dm["H_d"]
    assert dm["C"] + dm["delta_d"] + dm["H_d"] <= dm["Wf"]
    assert dm["Wf"] == 2 * dm["C"] and dm["C"] % dm["nhop_d"] == 0


@pytest.mark.parametrize("fs,f0_floor", REFINE_CONFS)
def test_refine_geometry_covers_every_frame(fs, f0_floor):
    """kernels._refine_geometry for the same confs, at a RTAnalyzer block
    (B = 1, N = 160), a ragged batch (2 x 1563) and the bench batch (128 x
    1600; a thread a frame there, 16 lanes a frame at the two small
    shapes): each block's staged decimated samples cover its frames'
    windows, the staged table and the x chunk's rows hold every slot once
    (and the column table points each frame's column at its sample), the
    C entry's checks hold, and the block's shared bytes stay <= 227 KB;
    at 11025 Hz (hop 55, no decimation) the full-rate kernel's geometry
    (_check_full_geometry)."""
    for B, N in ((1, 160), (2, 1563), (128, 1600)):
        conf, D, ntaps, dm = _refine_conf(fs, f0_floor, N)
        if fs == 11025.0:                 # the full-rate kernel's geometry
            assert D == 1
            _check_full_geometry(B, N, conf.nhop, conf.halfwin_max)
            continue
        geo = kernels._refine_geometry(B, N, D, ntaps, dm)
        F, G, T, S, P, Q, PQ = (geo[k] for k in ("F", "G", "T", "S", "P",
                                                   "Q", "PQ"))
        nd, Wf, C = dm["nhop_d"], dm["Wf"], dm["C"]
        assert (F, G) in kernels._REFINE_BLOCKS and T == F * G
        assert T % 32 == 0 and T <= 128 and Q == 2 * T
        assert geo["grid"] == (-(-N // F), B)
        assert (G == 1) == (B == 128)         # a thread a frame at the bench
        assert geo["smem"] <= 227 * 1024
        assert PQ >= Q + -(-ntaps // D) - 1 and PQ % 32 == (32 // D) % 32
        for n0 in range(0, N, F):
            m0 = n0 * nd - C
            n = np.arange(n0, min(n0 + F, N))
            assert (n * nd - C >= m0).all()
            assert (n * nd - C + Wf <= m0 + S).all()
        # the staged table (the kernel's slot()) and frame f's column c,
        # fr[col[c]] with fr = xs + f (G = 1) or xs + f nhop_d (G = 16)
        i, c, f = np.arange(S), np.arange(Wf), np.arange(F)[:, None]
        if G == 1:
            slot, col, fr = (i % nd) * P + i // nd, (c % nd) * P + c // nd, f
        else:
            slot, col, fr = i, c, f * nd
        assert len(np.unique(slot)) == S and slot.max() < geo["words"]
        assert (fr + col == slot[f * nd + c]).all()
        i = np.arange((Q - 1) * D + ntaps)
        xslot = (i % D) * PQ + i // D
        assert len(np.unique(xslot)) == len(i) and xslot.max() < D * PQ
        o, t = np.arange(Q)[:, None], np.arange(ntaps)
        assert ((t % D) * PQ + o + t // D == xslot[o * D + t]).all()


@pytest.mark.parametrize("warp_const", [766.0, 15000.0])
def test_unwarp_frequency_and_warped_bin_centers(warp_const):
    """unwarp_frequency inverts warp_frequency (tests/test_ops.py's
    round-trip oracle) and matches the JAX package's; warped_bin_centers
    matches its, lies in [0, fnyq] and warps to uniform centres."""
    f = np.linspace(0.0, 8000.0, 100).astype(np.float32)
    back = twarp.unwarp_frequency(twarp.warp_frequency(f, warp_const),
                                  warp_const).numpy()
    np.testing.assert_allclose(back, f, rtol=1e-5, atol=1e-2)
    fw = np.linspace(0.0, 3000.0, 57).astype(np.float32)
    np.testing.assert_allclose(
        twarp.unwarp_frequency(fw, warp_const).numpy(),
        np.asarray(jwarp.unwarp_frequency(jnp.asarray(fw), warp_const)),
        rtol=2e-6)
    for npsd, fnyq in ((32, 6000.0), (64, 8000.0)):
        got = twarp.warped_bin_centers(npsd, fnyq, warp_const).numpy()
        ref = np.asarray(jwarp.warped_bin_centers(npsd, fnyq, warp_const))
        np.testing.assert_allclose(got, ref, rtol=2e-6)
        assert got.dtype == np.float32 and 0 < got[0] < got[-1] < fnyq
        step = np.diff(twarp.warp_frequency(got, warp_const).numpy())
        np.testing.assert_allclose(step, step.mean(), rtol=1e-4)


def _layout(spec):
    """A JAX PartitionSpec as the port's {dim: axis} layout."""
    return {d: a for d, a in enumerate(spec) if a is not None}


def _param_spec(sharding):
    """A JAX NamedSharding of a stacked parameter as the port's (dim, axis)
    or None."""
    spec = tuple(sharding.spec)
    assert len(spec) <= 1
    return (0, spec[0]) if spec and spec[0] is not None else None


def test_mesh_layouts_match_jax():
    """batch_sharding, batch_frame_sharding and replicated split what the
    JAX package's NamedShardings split; shard_rows / shard_batch read
    batch_sharding and local_block any layout."""
    from jax.sharding import Mesh as JMesh

    from libllsm2_tpu.parallel import mesh as jmesh
    from libllsm2_tpu_torch.parallel import mesh as tmesh
    jm = JMesh(np.array(jax.devices()[:1]).reshape(1, 1),
               (jmesh.BATCH_AXIS, jmesh.FRAME_AXIS))
    m = tmesh.make_mesh(1, device="cpu")
    for name in ("batch_sharding", "batch_frame_sharding", "replicated"):
        assert getattr(tmesh, name)(m) == _layout(
            getattr(jmesh, name)(jm).spec), name
    v = np.arange(24.0).reshape(4, 6)
    assert torch.equal(tmesh.shard_rows(v, m), torch.as_tensor(v))
    assert torch.equal(tmesh.shard_batch({"v": v}, m)["v"], torch.as_tensor(v))
    assert np.array_equal(tmesh.local_block(v, m, {0: "batch", 1: "frame"}),
                          v)


def test_pp_ep_param_shardings_match_jax():
    """pp_param_shardings and ep_param_shardings give the JAX package's
    trees, each leaf's split ((dim, axis) or None) that of its
    NamedSharding, as tp_param_specs is held to its PartitionSpecs."""
    from jax.sharding import Mesh as JMesh

    from libllsm2_tpu.parallel import expert as jexpert
    from libllsm2_tpu.parallel import pipeline as jpipeline
    from libllsm2_tpu_torch.parallel import expert as texpert
    from libllsm2_tpu_torch.parallel import pipeline as tpipeline
    dev = np.array(jax.devices()[:1])
    cases = [
        (tpipeline.pp_param_shardings(None),
         jpipeline.pp_param_shardings(JMesh(dev, ("pipe",)))),
        (texpert.ep_param_shardings(texpert.MoEConfig(dims=8), None),
         jexpert.ep_param_shardings(jexpert.MoEConfig(dims=8),
                                    JMesh(dev, ("expert",))))]
    for got, ref in cases:
        assert got.keys() == ref.keys()
        for group, leaves in ref.items():
            if isinstance(leaves, dict):
                assert got[group] == {k: _param_spec(v)
                                      for k, v in leaves.items()}, group
            else:
                assert got[group] == _param_spec(leaves), group


def test_pp_ep_sharding_reads_the_layouts():
    """shard_params_pp / shard_params_ep on a one-rank mesh keep every
    parameter (the layouts' only split axis has one rank)."""
    from libllsm2_tpu_torch.parallel import expert as texpert
    from libllsm2_tpu_torch.parallel import mesh as tmesh
    from libllsm2_tpu_torch.parallel import pipeline as tpipeline
    gen = lambda s: torch.Generator().manual_seed(s)
    trunk = tpipeline.init_trunk_params(tpipeline.TrunkConfig(dims=8),
                                        gen(0), device="cpu")
    moe_cfg = texpert.MoEConfig(dims=8)
    moe = texpert.init_moe_params(moe_cfg, gen(1), device="cpu")
    staged = tpipeline.shard_params_pp(trunk, tmesh.make_pipe_mesh(
        1, device="cpu"))
    local = texpert.shard_params_ep(moe_cfg, moe, tmesh.make_expert_mesh(
        1, device="cpu"))
    for whole, part in ((trunk, staged), (moe, local)):
        ref = whole.state_dict()
        for k, v in part.state_dict().items():
            assert torch.equal(v, ref[k]), k


def _top_names(path, defs_only):
    """Top-level public names of a module's source: its defs, classes and
    assignments, and unless defs_only its imports too."""
    out = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                out |= {e.id for e in ast.walk(t) if isinstance(e, ast.Name)}
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
        elif not defs_only and isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return {s for s in out if not s.startswith("_")}


def test_every_public_name_has_a_counterpart():
    """Each JAX module has a port module defining or importing its
    top-level public defs, classes and constants, and each subpackage's
    __init__ all the names the JAX package's imports, but pallas_osc
    (its kernels are csrc/, ops.kernels in the namespace), utils/cache
    (XLA's compile cache: the port's build cache is ops/_build.py) and
    utils/profiling's ThroughputMeter and MetricsLog (nothing read them:
    the port's benchmark times and records its runs)."""
    jroot, troot = ROOT / "libllsm2_tpu", ROOT / "libllsm2_tpu_torch"
    missing = {}
    for p in sorted(jroot.rglob("*.py")):
        rel = p.relative_to(jroot)
        q = troot / rel
        if str(rel) in ("ops/pallas_osc.py", "utils/cache.py"):
            assert not q.exists()
            continue
        assert q.exists(), rel
        want = _top_names(p, p.name != "__init__.py") - {
            "pallas_osc", "cache", "ThroughputMeter", "MetricsLog"}
        lack = want - _top_names(q, False)
        if lack:
            missing[str(rel)] = sorted(lack)
    assert not missing, missing


def test_subpackage_namespaces():
    """models exports abs_refine and its submodules as the JAX package's;
    ops and utils import theirs, kernels in place of pallas_osc."""
    import libllsm2_tpu_torch.models as tmodels
    import libllsm2_tpu_torch.ops as tops
    import libllsm2_tpu_torch.utils as tutils
    from libllsm2_tpu_torch.models import abs as tabs
    assert tmodels.abs_refine is tabs.abs_refine
    for mod, names in ((tmodels, ("abs", "coder", "edits", "layer0",
                                  "layer1", "pbp")),
                       (tops, ("f0", "filters", "harmonics", "interp",
                               "kernels", "lf", "resample", "spectral",
                               "stft", "warp", "windows")),
                       (tutils, ("audio", "dataio", "metrics", "plotting",
                                 "profiling", "serialize", "testsig"))):
        for name in names:
            assert getattr(mod, name).__name__ == f"{mod.__name__}.{name}"
    assert not hasattr(tops, "pallas_osc") and not hasattr(tutils, "cache")


@pytest.mark.parametrize("B,nhop,H,D,want", [
    # 44.1 kHz at a 10 ms hop, f0_floor 40: the full-rate kernel's 128
    # frames would stage 127 441 + 4961 samples, 243872 bytes
    (128, 441, 2205, 1, (8, 16, 4 * (7 * 441 + 4961))),
    (128, 441, 1260, 1, (8, 16, 4 * (7 * 441 + 2 * (1260 + 157) + 1))),
    # 44.1 kHz at 20 ms (hop 882, decimated by 2): 128 frames overflow too
    (128, 882, 2205, 2, (8, 16, None)),
    (128, 55, 315, 1, (128, 1, 30776))])     # phase 7's, as before
def test_refine_geometry_passes_over_blocks_past_shared_memory(B, nhop, H,
                                                               D, want):
    """kernels._refine_geometry takes the first block that gives two
    blocks an SM among those whose shared bytes fit the card's 232448
    (hop 441 at 44.1 kHz: 8 frames of 16 lanes, not 128 of one), so the
    wrappers take the shape; shapes whose first choice fits keep it."""
    N, fs = 800, 100.0 * nhop
    if D == 1:
        dm = kernels._refine_full_dims(nhop, fs, H)
        ntaps = 0
    else:
        dm = kernels._refine_dims(N * nhop, D, nhop, fs, H)
        ntaps = 127
    geo = kernels._refine_geometry(B, N, D, ntaps, dm)
    assert (geo["F"], geo["G"]) == want[:2]
    assert geo["smem"] <= kernels._REFINE_SMEM_MAX
    if want[2] is not None:
        assert geo["smem"] == want[2]
    if want[:2] != (128, 1):     # the 128-frame block's samples alone
        assert 4 * (127 * dm["nhop_d"] + dm["Wf"]) > kernels._REFINE_SMEM_MAX
