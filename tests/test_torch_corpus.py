"""The PyTorch port's corpus runners (parallel/corpus.py) and WAV loading
(utils/dataio.py, utils/audio.py) against the JAX package on the CPU, at
the small verification shapes: bucketing, run_corpus's batches and SNRs
with checkpoint and resume, the retry policy, run_corpus_files on WAV
files with and without F0 sidecars, its guards, and the loader's arrays.
The JAX runs use the Pallas branch in interpret mode.  Inputs are made
from seeds with numpy; each test states its tolerance."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.parallel import corpus as jcorpus
from libllsm2_tpu.utils import dataio as jdataio
from libllsm2_tpu.utils import testsig

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.parallel import corpus as tcorpus
from libllsm2_tpu_torch.parallel import mesh as tmesh
from libllsm2_tpu_torch.utils import audio as taudio
from libllsm2_tpu_torch.utils import dataio as tdataio

torch.set_num_threads(1)

CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
BUCKETS = (64, 128)


def _opts(pkg):
    """test_parallel.py's small_opt with the Pallas branch (the port runs
    no other), and its synthesis options."""
    opt = dataclasses.replace(pkg.create_aoptions(),
                              conf=pkg.ChunkConf(**CONF), use_pallas=True)
    return opt, dataclasses.replace(pkg.create_soptions(), use_pallas=True)


@pytest.mark.parametrize("seed,buckets", [(0, (64, 128)), (1, (200, 400,
                                                                800, 1600)),
                                          (2, (1600, 200, 800)), (3, (50,))])
def test_make_buckets_matches_jax(seed, buckets):
    """make_buckets on 200 seeded lengths (some past the longest bucket)
    gives the JAX package's assignment exactly."""
    lengths = np.random.default_rng(seed).integers(1, 2000, 200).tolist()
    assert tcorpus.make_buckets(lengths, buckets) == \
        jcorpus.make_buckets(lengths, buckets)


def _utterances(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    sigs, f0s = [], []
    for i in range(n):
        x, f0 = testsig.make_test_utterance(
            duration=float(rng.uniform(lo, hi)), seed=i,
            noise_level=0.05 * (i % 2))
        sigs.append(x.astype(np.float32))
        f0s.append(f0.astype(np.float32))
    return sigs, f0s


def test_run_corpus_matches_jax_and_resumes():
    """run_corpus on 12 utterances (0.2-0.5 s, buckets (64, 128), batch 4):
    the JAX package's batches (bucket, indices) in order and its per-row
    SNR within 0.05 dB (test_torch_layer0's bound); a second call with the
    checkpoint yields nothing, and after one batch is dropped from it only
    that batch runs again, with the same SNRs bit for bit."""
    sigs, f0s = _utterances(12, 0.2, 0.5, 0)
    jopt, jsopt = _opts(jpkg)
    topt, tsopt = _opts(tpkg)
    ref = list(jcorpus.run_corpus(jopt, jsopt, sigs, f0s,
                                  bucket_frames=BUCKETS, batch_size=4))
    ckpt = {}
    got = list(tcorpus.run_corpus(topt, tsopt, sigs, f0s,
                                  bucket_frames=BUCKETS, batch_size=4,
                                  checkpoint=ckpt, device="cpu"))
    assert [(r["bucket"], r["indices"]) for r in got] == \
        [(r["bucket"], r["indices"]) for r in ref]
    assert sorted(i for r in got for i in r["indices"]) == list(range(12))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["snr"], np.asarray(r["snr"]), atol=0.05)
        assert tuple(g["y"].shape) == (4, g["bucket"] * 80)
    assert list(tcorpus.run_corpus(topt, tsopt, sigs, f0s,
                                   bucket_frames=BUCKETS, batch_size=4,
                                   checkpoint=ckpt, device="cpu")) == []
    last = got[-1]["bucket"]
    start = sum(len(r["indices"]) for r in got[:-1] if r["bucket"] == last)
    ckpt["done"].remove((last, start))
    again = list(tcorpus.run_corpus(topt, tsopt, sigs, f0s,
                                    bucket_frames=BUCKETS, batch_size=4,
                                    checkpoint=ckpt, device="cpu"))
    assert len(again) == 1 and again[0]["indices"] == got[-1]["indices"]
    np.testing.assert_array_equal(again[0]["snr"], got[-1]["snr"])


@pytest.mark.parametrize("error,transient", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (ConnectionError("peer dropped"), True),
    (TimeoutError("store timed out"), True),
    (BrokenPipeError("pipe"), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (ValueError("deterministic shape bug"), False),
    (TypeError("bad argument"), False),
    (KeyError("x"), False)])
def test_is_transient_error(error, transient):
    """Device-layer and transport failures are retried; sticky CUDA errors
    and Python bugs are not."""
    assert tcorpus.is_transient_error(error) is transient


def test_pipeline_snr_of_a_row_alone_equals_its_batch_row():
    """batched_pipeline's per-row SNR sums run in calls of a fixed row
    count: rows 0 and 2 of a 3-row batch alone (a batch of one) give their
    batch SNRs bit for bit."""
    opt, sopt = _opts(tpkg)
    sigs, f0s = _utterances(3, 0.3, 0.3, 2)
    x, f0 = (torch.tensor(np.stack(a)) for a in (sigs, f0s))
    nxv = torch.full((3,), x.shape[1])
    _, whole, _ = tcorpus.batched_pipeline(opt, sopt, x, f0, nxv)
    for r in (0, 2):
        _, alone, _ = tcorpus.batched_pipeline(
            opt, sopt, x[r:r + 1], f0[r:r + 1], nxv[r:r + 1])
        assert torch.equal(alone[0], whole[r])


def _small_corpus():
    sigs, f0s = _utterances(4, 0.3, 0.3, 1)
    return sigs, f0s


def test_corpus_retries_transient_failures(monkeypatch):
    """A transient device error in the first step is retried once and the
    run covers every utterance (test_parallel.py's counterpart)."""
    opt, sopt = _opts(tpkg)
    sigs, f0s = _small_corpus()
    calls = {"n": 0}
    real = tcorpus.batched_pipeline

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.cuda.OutOfMemoryError("transient device error")
        return real(*a, **kw)

    monkeypatch.setattr(tcorpus, "batched_pipeline", flaky)
    results = list(tcorpus.run_corpus(opt, sopt, sigs, f0s,
                                      bucket_frames=(64,), batch_size=4,
                                      max_retries=1, device="cpu"))
    assert sorted(i for r in results for i in r["indices"]) == list(range(4))
    assert calls["n"] == 2


def test_corpus_does_not_retry_deterministic_errors(monkeypatch):
    """A Python-level bug propagates at once with its own traceback, even
    with retries left (test_parallel.py's counterpart)."""
    opt, sopt = _opts(tpkg)
    sigs, f0s = _small_corpus()
    calls = {"n": 0}

    def buggy(*a, **kw):
        calls["n"] += 1
        raise ValueError("deterministic shape bug")

    monkeypatch.setattr(tcorpus, "batched_pipeline", buggy)
    with pytest.raises(ValueError, match="deterministic"):
        list(tcorpus.run_corpus(opt, sopt, sigs[:2], f0s[:2],
                                bucket_frames=(64,), batch_size=2,
                                max_retries=3, device="cpu"))
    assert calls["n"] == 1


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    """Six 0.25-0.45 s WAVs (test_parallel.py's), the even ones with an F0
    sidecar, the odd ones tracked -> (paths, sidecar flags)."""
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(1)
    paths = []
    for i in range(6):
        dur = float(rng.uniform(0.25, 0.45))
        x, f0 = testsig.make_test_utterance(duration=dur, seed=10 + i)
        p = str(d / f"utt{i}.wav")
        taudio.wavwrite(p, x.astype(np.float32), 16000.0)
        if i % 2 == 0:
            np.save(str(d / f"utt{i}.f0.npy"), f0.astype(np.float32))
        paths.append(p)
    return paths, [i % 2 == 0 for i in range(6)]


def test_run_corpus_files_matches_jax_and_resumes(wav_corpus):
    """run_corpus_files on the six WAVs (buckets (64, 128), batch 4,
    want_audio): the JAX package's batches and paths; SNR within 0.05 dB on
    sidecar rows and 0.1 dB on tracked rows (the two trackers' F0 agree to
    ~1e-5 relative, which the analysis carries into the SNR); nx the file
    length within its bucket and y rows of that length with signal in
    them; a second call with the checkpoint yields nothing."""
    paths, sidecar = wav_corpus
    jopt, jsopt = _opts(jpkg)
    topt, tsopt = _opts(tpkg)
    ref = list(jcorpus.run_corpus_files(jopt, jsopt, paths,
                                        bucket_frames=BUCKETS, batch_size=4,
                                        want_audio=True))
    ckpt = {}
    got = list(tcorpus.run_corpus_files(topt, tsopt, paths,
                                        bucket_frames=BUCKETS, batch_size=4,
                                        checkpoint=ckpt, want_audio=True,
                                        device="cpu"))
    assert [(r["bucket"], r["paths"]) for r in got] == \
        [(r["bucket"], r["paths"]) for r in ref]
    assert sorted(p for r in got for p in r["paths"]) == sorted(paths)
    for g, r in zip(got, ref):
        for j, p in enumerate(g["paths"]):
            tol = 0.05 if sidecar[paths.index(p)] else 0.1
            assert abs(g["snr"][j] - float(r["snr"][j])) <= tol, \
                (p, g["snr"][j], float(r["snr"][j]))
            nx = int(g["nx"][j])
            assert nx == int(r["nx"][j]) == min(tdataio.wav_nsamples(p),
                                                g["bucket"] * 80)
            assert float(np.std(g["y"][j, :nx])) > 1e-3
        assert g["y"].shape == (len(g["paths"]), g["bucket"] * 80)
    assert list(tcorpus.run_corpus_files(topt, tsopt, paths,
                                         bucket_frames=BUCKETS, batch_size=4,
                                         checkpoint=ckpt,
                                         device="cpu")) == []


def test_run_corpus_files_equals_run_corpus_on_quantized_signals(wav_corpus):
    """A batch from files equals run_corpus on the same int16-quantized
    float signals (x_i16 * float32(1 / 32767), F0 from the sidecars and,
    for tracked files, ops.f0 on those rows) bit for bit: SNR and y."""
    from libllsm2_tpu_torch.ops import f0 as tf0
    paths, sidecar = wav_corpus
    opt, sopt = _opts(tpkg)
    got = list(tcorpus.run_corpus_files(opt, sopt, paths,
                                        bucket_frames=(128,), batch_size=6,
                                        want_audio=True, device="cpu"))
    assert len(got) == 1
    x16, ln, _ = tdataio.load_wav_batch(paths, 128 * 80, dtype="int16")
    xq = x16.astype(np.float32) * np.float32(1.0 / 32767.0)
    cfg = tf0.F0Config(fs=16000.0, nhop=80, f0_floor=90.0)
    tracked = tf0.track_batch(cfg, torch.tensor(xq), device="cpu").numpy()
    # a tracked row's F0 spans the whole bucket, as run_corpus_files
    # tracks the padded row
    f0s = [np.load(p[:-4] + ".f0.npy") if s else tracked[i]
           for i, (p, s) in enumerate(zip(paths, sidecar))]
    sigs = [xq[i, :n] for i, n in enumerate(ln)]
    ref = list(tcorpus.run_corpus(opt, sopt, sigs, f0s, bucket_frames=(128,),
                                  batch_size=6, device="cpu"))
    assert ref[0]["indices"] == got[0]["indices"]
    np.testing.assert_array_equal(got[0]["snr"], ref[0]["snr"])
    np.testing.assert_array_equal(got[0]["y"], ref[0]["y"].numpy())


def test_run_corpus_files_guards(wav_corpus, tmp_path):
    """A file at another rate is refused with a clear ValueError (the rate
    guard); a mesh whose batch axis does not split batch_size is refused
    with a ValueError, in both runners; a one-rank mesh runs as no mesh."""
    opt, sopt = _opts(tpkg)
    xb, _ = testsig.make_test_utterance(duration=0.3, seed=99)
    bad = str(tmp_path / "bad.wav")
    taudio.wavwrite(bad, xb.astype(np.float32), 8000)
    with pytest.raises(ValueError, match="sample rate"):
        list(tcorpus.run_corpus_files(opt, sopt, [bad], bucket_frames=(64,),
                                      batch_size=1, device="cpu"))
    four = types.SimpleNamespace(shape={"batch": 4})
    with pytest.raises(ValueError, match="does not split"):
        list(tcorpus.run_corpus_files(opt, sopt, wav_corpus[0][:1],
                                      batch_size=6, mesh=four, device="cpu"))
    sigs, f0s = _small_corpus()
    with pytest.raises(ValueError, match="does not split"):
        list(tcorpus.run_corpus(opt, sopt, sigs, f0s, batch_size=6,
                                mesh=four, device="cpu"))
    one = tmesh.make_mesh(1, device="cpu")
    kw = dict(bucket_frames=(64,), batch_size=2)
    for a, b in zip(tcorpus.run_corpus(opt, sopt, sigs, f0s, mesh=one, **kw),
                    tcorpus.run_corpus(opt, sopt, sigs, f0s, device="cpu",
                                       **kw)):
        np.testing.assert_array_equal(a["snr"], b["snr"])
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            list(tcorpus.run_corpus(opt, sopt, sigs, f0s, bucket_frames=(64,)))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_load_wav_batch_matches_jax_dataio(wav_corpus, tmp_path, monkeypatch,
                                           native, dtype):
    """load_wav_batch (the native loader, then the scipy fallback of both
    packages) and wav_nsamples / wav_info give the JAX dataio's arrays bit
    for bit, a truncated file included (length 0, zero row); the port
    fills a caller's array in place."""
    paths = list(wav_corpus[0])
    broken = str(tmp_path / "broken.wav")
    with open(paths[0], "rb") as f, open(broken, "wb") as g:
        g.write(f.read(30))
    paths.append(broken)
    if native:
        assert tdataio.native_available() and jdataio.native_available()
    else:
        monkeypatch.setattr(tdataio, "_load", lambda: None)
        monkeypatch.setattr(jdataio, "_load", lambda: None)
    ref = jdataio.load_wav_batch(paths, 6000, dtype=dtype)
    got = tdataio.load_wav_batch(paths, 6000, dtype=dtype)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got[1][-1] == 0 and not got[0][-1].any()
    out = np.full((len(paths), 6000), 7, got[0].dtype)
    assert tdataio.load_wav_batch(paths, 6000, dtype=dtype, out=out)[0] is out
    np.testing.assert_array_equal(out, ref[0])
    for p in paths:
        assert tdataio.wav_nsamples(p) == jdataio.wav_nsamples(p)
        assert tdataio.wav_info(p) == jdataio.wav_info(p)


def test_wav_round_trip_matches_jax_audio(tmp_path):
    """wavwrite / wavread (copied whole) read back the JAX package's
    samples and rate exactly."""
    from libllsm2_tpu.utils import audio as jaudio
    x = np.random.default_rng(2).uniform(-1.2, 1.2, 999).astype(np.float32)
    pt, pj = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    taudio.wavwrite(pt, x, 16000.0)
    jaudio.wavwrite(pj, x, 16000.0)
    (yt, ft), (yj, fj) = taudio.wavread(pt), jaudio.wavread(pj)
    assert ft == fj == 16000.0
    np.testing.assert_array_equal(yt, yj)
