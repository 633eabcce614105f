"""The PyTorch port's multi-device layer on the CPU: tests/test_parallel.py's
oracles on ranks of torch.distributed (gloo), and the port's frame-sharded
analysis and synthesis against the JAX package's seqparallel.

One world of 4 ranks (torch.multiprocessing.spawn, a FileStore under the
test's temporary directory) runs every sharded case once and saves what
each rank returned; the tests compare those results with the port's
one-process runs and with the JAX package, which runs here in the parent
on its 8 virtual CPU devices.  The ranks import neither jax nor
libllsm2_tpu: this module imports jax only inside its test functions."""
import dataclasses
import pickle
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.ops import harmonics as tharm
from libllsm2_tpu_torch.parallel import corpus as tcorpus
from libllsm2_tpu_torch.parallel import distributed as tdist
from libllsm2_tpu_torch.parallel import mesh as tmesh
from libllsm2_tpu_torch.parallel import seqparallel as tsp
from libllsm2_tpu_torch.utils import audio as taudio
from libllsm2_tpu_torch.utils import testsig

torch.set_num_threads(1)

RANKS = 4
CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)


def small_opt(pkg=tpkg):
    return dataclasses.replace(pkg.create_aoptions(),
                               conf=pkg.ChunkConf(**CONF))


def _batch(B=8, dur=0.4):
    xs, f0s = zip(*(testsig.make_test_utterance(duration=dur, seed=i)
                    for i in range(B)))
    x = np.stack(xs).astype(np.float32)
    return x, np.stack(f0s).astype(np.float32), \
        np.full((B,), x.shape[1], np.int32)


def _corpus():
    rng = np.random.default_rng(0)
    sigs, f0s = [], []
    for i in range(12):
        x, f0 = testsig.make_test_utterance(
            duration=float(rng.uniform(0.2, 0.5)), seed=i)
        sigs.append(x)
        f0s.append(f0)
    return sigs, f0s


def _wav_paths(d):
    """test_parallel.py's six WAV files (sidecars on the even ones)."""
    fs = small_opt().conf.fs
    rng = np.random.default_rng(1)
    paths = []
    for i in range(6):
        x, f0 = testsig.make_test_utterance(
            duration=float(rng.uniform(0.25, 0.45)), seed=10 + i)
        p = f"{d}/utt{i}.wav"
        taudio.wavwrite(p, x.astype(np.float32), fs)
        if i % 2 == 0:
            np.save(f"{d}/utt{i}.f0.npy", f0.astype(np.float32))
        paths.append(p)
    return paths


def _chunk_np(c):
    return {k: getattr(c, k).detach().cpu().numpy()
            for k in ("f0", "ampl", "phse", "hm_mask", "psd", "edc",
                      "eenv_a", "eenv_p")}


def _init(r, n, d):
    torch.set_num_threads(1)
    tdist.initialize_multihost(f"file://{d}/store", n, r, timeout_s=300)


def _parallel_rank(r, n, d, paths):
    """Every sharded case of this module on rank r -> {d}/rank{r}.pkl."""
    _init(r, n, d)
    opt, sopt = small_opt(), tpkg.create_soptions()
    out = {"backend": dist.get_backend()}
    m = tmesh.make_mesh(n, device="cpu")                  # (batch 4, frame 1)
    # the data-parallel batch: this rank's rows
    xs, f0s, nxs = tmesh.shard_batch(_batch(), m)
    y, snr, mean = tcorpus.batched_pipeline(opt, sopt, xs, f0s, nxs, mesh=m)
    out["bp"] = (y.numpy(), snr.numpy(), float(mean))
    sigs, f0l = _corpus()
    ck = {}
    out["rc"] = [(b["bucket"], b["indices"], b["snr"], b["y"].numpy())
                 for b in tcorpus.run_corpus(opt, sopt, sigs, f0l,
                                             bucket_frames=(64, 128),
                                             batch_size=4, checkpoint=ck,
                                             mesh=m)]
    out["rc_resume"] = list(tcorpus.run_corpus(
        opt, sopt, sigs, f0l, bucket_frames=(64, 128), batch_size=4,
        checkpoint=ck, mesh=m))
    out["rcf"] = [(b["paths"], b["snr"], b["y"], b["nx"])
                  for b in tcorpus.run_corpus_files(
                      opt, sopt, paths[:4], bucket_frames=(128,),
                      batch_size=4, mesh=m, want_audio=True)]
    # frame-sharded synthesis and analysis over a (1, 4) mesh
    mf = tmesh.make_mesh(n, frame_parallel=n, device="cpu")
    x, f0 = testsig.make_test_utterance(duration=0.8, seed=3)
    c3 = tl0.analyze(opt, x, f0, device="cpu")
    out["synth"] = tsp.synthesize_frame_sharded(sopt, c3, mf)._asdict()
    x, f0 = testsig.make_test_utterance(duration=0.8, seed=4)
    frames = []
    real = tharm.harmonic_analysis

    def counted(x_, f0_, *a, **k):           # the frames a projection sees
        frames.append(tuple(f0_.shape))
        return real(x_, f0_, *a, **k)

    mf.reset_counts()
    tharm.harmonic_analysis = counted
    try:
        c4 = tsp.analyze_frame_sharded(opt, x, f0, mf)
    finally:
        tharm.harmonic_analysis = real
    out["analysis"] = _chunk_np(c4)
    out["frames"], out["log"] = frames, list(mf.log)
    out["render4"] = tsp.synthesize_frame_sharded(sopt, c4, mf)._asdict()
    # the kernel route (the kernels' plain versions on the CPU)
    x, f0 = testsig.make_test_utterance(duration=0.4, seed=6)
    out["pallas"] = _chunk_np(tsp.analyze_frame_sharded(
        dataclasses.replace(opt, use_pallas=True), x, f0, mf))
    # halos that do not fit in one neighbour shard: 20 frames a shard with
    # the default conf's ha = 17, hb = 22
    try:
        tsp.analyze_frame_sharded(tpkg.create_aoptions(),
                                  np.zeros(80 * 80, np.float32),
                                  np.full((80,), 140.0, np.float32), mf)
        out["undersized"] = None
    except ValueError as e:
        out["undersized"] = str(e)
    out["result_to_numpy"] = True
    for k in ("synth", "render4"):
        out[k] = {f: (v.numpy() if torch.is_tensor(v) else v)
                  for f, v in out[k].items()}
    with open(f"{d}/rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("world"))
    paths = _wav_paths(d)
    mp.spawn(_parallel_rank, args=(RANKS, d, paths), nprocs=RANKS)
    ranks = []
    for r in range(RANKS):
        with open(f"{d}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, paths


def test_ranks_run_gloo(world):
    ranks, _ = world
    assert [o["backend"] for o in ranks] == ["gloo"] * RANKS


def test_batched_pipeline_sharded(world):
    """Each rank's y rows and the all-gathered snr equal the one-process
    batch (a row does not depend on its batch); mean_snr is the global
    mean on every rank."""
    ranks, _ = world
    opt, sopt = small_opt(), tpkg.create_soptions()
    x, f0, nxv = (torch.from_numpy(a) for a in _batch())
    y, snr, mean = tcorpus.batched_pipeline(opt, sopt, x, f0, nxv)
    assert float(mean) > 15.0
    per = x.shape[0] // RANKS
    for r, o in enumerate(ranks):
        yr, snr_r, mean_r = o["bp"]
        assert yr.shape == (per, x.shape[1])      # the rows stay sharded
        np.testing.assert_array_equal(yr, y[r * per:(r + 1) * per].numpy())
        np.testing.assert_array_equal(snr_r, snr.numpy())
        assert abs(mean_r - float(mean)) <= 1e-5


def test_run_corpus_bucketed_with_checkpoint(world):
    """Every rank yields the same dicts, covering the corpus once, the
    SNRs and the gathered y those of the one-process run; the resumed run
    yields nothing."""
    ranks, _ = world
    opt, sopt = small_opt(), tpkg.create_soptions()
    sigs, f0s = _corpus()
    ref = list(tcorpus.run_corpus(opt, sopt, sigs, f0s,
                                  bucket_frames=(64, 128), batch_size=4,
                                  device="cpu"))
    covered = sorted(i for b in ranks[0]["rc"] for i in b[1])
    assert covered == list(range(12))
    for o in ranks:
        assert o["rc_resume"] == []
        assert len(o["rc"]) == len(ref)
        for (bucket, idx, snr, y), b in zip(o["rc"], ref):
            assert (bucket, idx) == (b["bucket"], b["indices"])
            assert np.all(np.isfinite(snr))
            np.testing.assert_array_equal(snr, b["snr"])
            np.testing.assert_array_equal(y, b["y"].numpy())


def test_run_corpus_files_end_to_end(world):
    """The file runner over the mesh (tracked rows and sidecars, want_audio)
    gives every rank the one-process run's SNRs and audio rows."""
    ranks, paths = world
    opt, sopt = small_opt(), tpkg.create_soptions()
    ref = list(tcorpus.run_corpus_files(opt, sopt, paths[:4],
                                        bucket_frames=(128,), batch_size=4,
                                        want_audio=True, device="cpu"))
    for o in ranks:
        (p, snr, y, nx), = o["rcf"]
        assert p == ref[0]["paths"]
        assert min(snr) > 20.0
        np.testing.assert_array_equal(snr, ref[0]["snr"])
        np.testing.assert_array_equal(y, ref[0]["y"])
        np.testing.assert_array_equal(nx, ref[0]["nx"])


def test_frame_sharded_synthesis_matches_single_device(world):
    ranks, _ = world
    opt, sopt = small_opt(), tpkg.create_soptions()
    x, f0 = testsig.make_test_utterance(duration=0.8, seed=3)
    ref = tl0.synthesize(sopt, tl0.analyze(opt, x, f0, device="cpu"))
    for o in ranks:
        np.testing.assert_allclose(o["synth"]["y_sin"], ref.y_sin.numpy(),
                                   atol=2e-4)
        np.testing.assert_allclose(o["synth"]["y"], ref.y.numpy(),
                                   atol=2e-3)


def _check_chunk(got, ref, f0_rtol=0.0):
    """test_parallel.py's tolerances: f0 and the mask equal (f0 within
    f0_rtol across packages: their float operations differ), the harmonic
    tracks exact to float rounding, the noise model within the envelope
    filterbank's overlap-save truncation."""
    np.testing.assert_allclose(got["f0"], ref["f0"], rtol=f0_rtol, atol=0)
    np.testing.assert_array_equal(got["hm_mask"], ref["hm_mask"])
    np.testing.assert_allclose(got["ampl"], ref["ampl"], atol=2e-6)
    za = ref["ampl"] * np.exp(1j * ref["phse"])
    zb = got["ampl"] * np.exp(1j * got["phse"])
    assert np.abs(za - zb).max() < 1e-5
    np.testing.assert_allclose(got["psd"], ref["psd"], atol=1e-5)
    np.testing.assert_allclose(got["edc"], ref["edc"], atol=5e-3)
    ea = ref["eenv_a"] * np.exp(1j * ref["eenv_p"])
    eb = got["eenv_a"] * np.exp(1j * got["eenv_p"])
    assert np.abs(ea - eb).max() < 8e-3
    assert np.abs(ea - eb)[4:-4].max() < 1e-3


def test_frame_sharded_analysis_matches_single_device(world):
    """ALL chunk fields against the port's one-process analysis, on every
    rank (each returns the whole chunk)."""
    ranks, _ = world
    x, f0 = testsig.make_test_utterance(duration=0.8, seed=4)
    ref = _chunk_np(tl0.analyze(small_opt(), x, f0, device="cpu"))
    for o in ranks:
        _check_chunk(o["analysis"], ref)


def test_frame_sharded_analysis_kernel_route(world):
    """use_pallas=True (the kernels' plain versions here): against the
    one-process kernel route on every row -- f0 within 1e-6 relative, the
    mask equal, ampl within 2e-6, psd within 1e-5 -- and on interior rows against the plain
    route within 2e-3.  test_parallel.py holds the JAX package's sharded
    kernel route to the plain route on all rows instead: its refine's
    decimating FIR rings into the zero halo past the signal, which moves
    the edge rows off its own one-process kernel route and near the plain
    one.  The port's sharded refine zeroes that halo's FIR output
    (refine_f0's bounds), so it equals its one-process kernel route there,
    which itself lies up to ~9e-3 from the plain route at the last rows."""
    ranks, _ = world
    opt = dataclasses.replace(small_opt(), use_pallas=True)
    x, f0 = testsig.make_test_utterance(duration=0.4, seed=6)
    ref = tl0.analyze(opt, x, f0, device="cpu")
    refj = tl0.analyze(dataclasses.replace(opt, use_pallas=False), x, f0,
                       device="cpu")
    for o in ranks:
        got = o["pallas"]
        # the refine's FIR on the shard's block: an ulp here and there
        np.testing.assert_allclose(got["f0"], ref.f0.numpy(), rtol=1e-6)
        np.testing.assert_array_equal(got["hm_mask"], ref.hm_mask.numpy())
        np.testing.assert_allclose(got["ampl"], ref.ampl.numpy(), atol=2e-6)
        np.testing.assert_allclose(got["psd"], ref.psd.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["ampl"][10:-10],
                                   refj.ampl.numpy()[10:-10], atol=2e-3)


def test_frame_sharded_analysis_rejects_undersized_shards(world):
    ranks, _ = world
    for o in ranks:
        assert o["undersized"] and "frames per" in o["undersized"]
    with pytest.raises(ValueError, match="czt"):
        tsp.analyze_frame_sharded(
            dataclasses.replace(small_opt(), hm_method="pp"),
            np.zeros(800, np.float32), np.zeros(10, np.float32),
            tmesh.make_mesh(1, frame_parallel=1, device="cpu"))


def test_frame_sharded_analysis_actually_partitions(world):
    """Each rank's projections see only its block plus halos (nl + 2 hb
    frames, then nl + 2 hr for the envelopes), never the utterance's N;
    every gather the comm layer logs is under half the signal's bytes, and
    every halo exchange (ppermute) brings at most hb hops of samples."""
    ranks, _ = world
    opt = small_opt()
    x, f0 = testsig.make_test_utterance(duration=0.8, seed=4)
    N = len(f0)
    nl = N // RANKS
    _, hr, hb, _ = tsp._halos(opt, nl)
    nx_bytes = N * opt.conf.nhop * 4
    for o in ranks:
        assert o["frames"][0] == (1, nl + 2 * hb)
        assert o["frames"][1] == (opt.conf.nchannel, nl + 2 * hr)
        assert all(rows < N for _, rows in o["frames"])
        gathers = [b for op, _, b in o["log"] if op == "all_gather"]
        assert gathers and max(gathers) < nx_bytes / 2
        halos = [b for op, _, b in o["log"] if op == "all_to_all"]
        assert halos and max(halos) <= hb * opt.conf.nhop * 4


def test_frame_sharded_matches_jax(world):
    """The port's frame-sharded chunk and render against the JAX package's
    seqparallel on the same numpy inputs (make_mesh(4, frame_parallel=4)),
    at test_parallel.py's tolerances; the render of the port's chunk
    through both packages."""
    import jax.numpy as jnp

    import libllsm2_tpu as jpkg
    from libllsm2_tpu.container import Chunk as JChunk
    from libllsm2_tpu.parallel import mesh as jmesh
    from libllsm2_tpu.parallel import seqparallel as jsp

    ranks, _ = world
    jm = jmesh.make_mesh(RANKS, frame_parallel=RANKS)
    x, f0 = testsig.make_test_utterance(duration=0.8, seed=4)
    jc = jsp.analyze_frame_sharded(small_opt(jpkg), x, f0, jm)
    ref = {k: np.asarray(getattr(jc, k)) for k in ranks[0]["analysis"]}
    got = ranks[0]["analysis"]
    _check_chunk(got, ref, f0_rtol=1e-6)
    chunk = JChunk(**{k: jnp.asarray(v) for k, v in got.items()},
                   conf=small_opt(jpkg).conf)
    jy = jsp.synthesize_frame_sharded(jpkg.create_soptions(), chunk, jm)
    np.testing.assert_allclose(ranks[0]["render4"]["y_sin"],
                               np.asarray(jy.y_sin), atol=2e-4)
    np.testing.assert_allclose(ranks[0]["render4"]["y"], np.asarray(jy.y),
                               atol=2e-3)


def _tcp_rank(r, n, d, port):
    torch.set_num_threads(1)
    tdist.initialize_multihost(f"tcp://localhost:{port}", n, r,
                               timeout_s=120)
    tdist.initialize_multihost(f"tcp://localhost:{port}", n, r)  # no-op
    try:                          # ranks default to the card: none here
        tdist.global_mesh()
        no_card = None
    except RuntimeError as e:
        no_card = str(e)
    m = tdist.global_mesh(device="cpu")
    v = tmesh.psum(torch.tensor([float(r + 1)]), m, tmesh.BATCH_AXIS)
    with open(f"{d}/tcp{r}.pkl", "wb") as f:
        pickle.dump((dist.get_world_size(), dist.get_backend(), m.shape,
                     float(v), "CUDA" in (no_card or "")), f)
    dist.destroy_process_group()


def test_initialize_multihost_two_processes(tmp_path):
    """Two processes joined by an explicit tcp:// address (the counterpart
    of test_multiprocess.py): a 2-rank global mesh whose psum sums both;
    a second call is a no-op; an explicit spec that cannot be met
    raises."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(_tcp_rank, args=(2, str(tmp_path), port), nprocs=2)
    for r in range(2):
        with open(tmp_path / f"tcp{r}.pkl", "rb") as f:
            assert pickle.load(f) == (2, "gloo", {"batch": 2, "frame": 1},
                                      3.0, not torch.cuda.is_available())
    with pytest.raises(ValueError, match="num_processes"):
        tdist.initialize_multihost("tcp://localhost:1")
    assert not dist.is_initialized()


def test_noise_bins_negative_frame_base():
    """The first shard of a frame-sharded render draws frames -2 and -1
    (frame_base = -hs): noise_bins_ref at frame_base=-2 against the JAX
    package's _synth_noise draw (int32 frame indices -2 .. N-3 through
    fold_in), its uint32 bits exactly and its normals within 1e-6 (XLA's
    erf_inv to an ulp); the wrapper accepts the base on the CPU."""
    import jax
    import jax.numpy as jnp

    from libllsm2_tpu_torch.ops import kernels as tkernels

    seed, N, nbin = 0x5eed, 12, 81
    key = jax.random.PRNGKey(seed)

    def frame(i):
        kr, ki = jax.random.split(jax.random.fold_in(key, i))
        return tuple(f(k, (nbin,), d) for k in (kr, ki) for f, d in (
            (jax.random.normal, jnp.float32), (jax.random.bits, jnp.uint32)))

    jre, jbre, jim, jbim = map(np.asarray, jax.vmap(frame)(
        -2 + jnp.arange(N, dtype=jnp.int32)))
    re, im, bre, bim = tkernels.noise_bins_ref(seed, -2, 1, N, nbin,
                                               bits=True)
    np.testing.assert_array_equal(bre.numpy().view(np.uint32), jbre)
    np.testing.assert_array_equal(bim.numpy().view(np.uint32), jbim)
    np.testing.assert_allclose(re[0].numpy(), jre, atol=1e-6, rtol=0)
    np.testing.assert_allclose(im[0].numpy(), jim, atol=1e-6, rtol=0)
    got = tkernels.noise_bins(seed, -2, 1, N, nbin, "cpu")
    assert torch.equal(got[0], re) and torch.equal(got[1], im)


def test_shard_cycle_base_gives_the_whole_track():
    """sample_cycles' base and start: a block of frames integrated from the
    exact sum of the hop totals before it (cycle_totals) at the whole
    track's sample positions gives the whole track's samples bit for bit,
    a halo of frames past the signal's start included (the first shard's);
    the JAX package's float32 mod-1 offsets are ~1e-7 cycles off.  The
    plain version here; phase 19 holds the kernel to it on the card."""
    from libllsm2_tpu_torch.ops import kernels as tkernels

    _, f0 = testsig.make_test_utterance(duration=2.0, seed=0)
    f0 = torch.tensor(f0, dtype=torch.float32)
    nhop, fs, hb = 80, 16000.0, 15
    N = f0.shape[0]
    whole = tkernels.sample_cycles_ref(f0, nhop, fs, N * nhop)
    for a, b in ((0, 100), (100, 250), (37, 301), (250, N)):
        lo, end = a - hb, min(b + hb, N)          # halos, as _shard_cycles
        blk = torch.cat([torch.zeros(max(-lo, 0)), f0[max(lo, 0):end]])
        tot = tkernels.cycle_totals(blk, nhop, fs, blk.shape[0] * nhop, lo)
        before = tkernels.cycle_totals(f0, nhop, fs, N * nhop)[:a].sum()
        base = torch.remainder(before - tot[:a - lo].sum(), 1.0)
        got = tkernels.sample_cycles_ref(blk, nhop, fs, blk.shape[0] * nhop,
                                         base, lo)
        core = got[(a - lo) * nhop:(b - lo) * nhop]
        assert torch.equal(core, whole[a * nhop:b * nhop]), (a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shard_cycles_edges_equal_the_whole_track(seed):
    """seqparallel._shard_cycles on a one-rank frame mesh (the block is the
    first and the last, zero F0 halos on both sides) gives the whole
    track's samples bit for bit in its core and the edge samples beyond,
    on 10 random 50-frame F0 tracks: the last block stops at the signal's
    end, so its last hop holds F0 as the one-process lerp does.  (A lerp
    into an edge-replicated F0 halo, f (1 - t) + f t, rounds: it moved a
    quarter of such tracks' last hop by an ulp.)"""
    from libllsm2_tpu_torch.ops import kernels as tkernels

    rng = np.random.default_rng(seed)
    nhop, fs, hb, N = 80, 16000.0, 22, 50
    m = tmesh.make_mesh(1, frame_parallel=1, device="cpu")
    for _ in range(10):
        f0 = torch.tensor(rng.uniform(80.0, 300.0, N).astype(np.float32))
        whole = tkernels.sample_cycles_ref(f0, nhop, fs, N * nhop)
        ext = torch.nn.functional.pad(f0, (hb, hb))
        got = tsp._shard_cycles(m, ext, nhop, fs, hb, N)
        assert got.shape == (ext.shape[0] * nhop,)
        assert torch.equal(got[hb * nhop:(hb + N) * nhop], whole)
        assert torch.all(got[:hb * nhop] == whole[0])
        assert torch.all(got[(hb + N) * nhop:] == whole[-1])
