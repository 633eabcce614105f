"""The PyTorch port's multi-stream serving pool (runtime/rtserve.py) on the
CPU, with tests/test_rtserve.py's oracle: every pool stream equals, bit
for bit, a solo RTSynthesizer fed the same frames with the same derived
noise seed.  Three voices of synth_lf_speech at the small verification
conf, analyzed by the port; then the pool against the JAX package's on
one carried-across voice."""
import dataclasses
import types

import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.runtime import rtserve as jserve

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import CHUNK_FIELDS, chunk_from_numpy
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.runtime import rtsynth as trt
from libllsm2_tpu_torch.runtime.rtserve import StreamPool
from libllsm2_tpu_torch.utils import testsig as tts

torch.set_num_threads(1)

CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
OPT = dataclasses.replace(tpkg.create_aoptions(**CONF), track_denoise=False,
                          use_pallas=True)
SOPT = tpkg.create_soptions()


@pytest.fixture(scope="module")
def voices():
    """test_rtserve.py's three voices (0.8 / 0.6 / 1.0 s at 120 / 200 /
    160 Hz) through the port's analysis, with their numpy sources."""
    out = []
    for dur, f0b in ((0.8, 120.0), (0.6, 200.0), (1.0, 160.0)):
        f0 = tts.make_f0_track(int(dur / OPT.conf.thop), OPT.conf.thop,
                               f0_base=f0b)
        x, _ = tts.synth_lf_speech(f0, noise_level=0.02)
        x, f0 = np.asarray(x, np.float32), np.asarray(f0, np.float32)
        out.append((tl0.analyze(OPT, x, f0, device="cpu"), x, f0))
    return out


def _solo(chunk, seed_offset, **kw):
    sopt = dataclasses.replace(SOPT, noise_seed=SOPT.noise_seed + seed_offset)
    return trt.stream_chunk(sopt, chunk, block=16, **kw)


def _drain_pool(pool, chunks, feed_piece=7):
    """test_rtserve.py's drain: feed in small pieces, service as they
    come, end every stream -> each stream's audio."""
    frames = [trt.RTSynthesizer.chunk_frames_np(c) for c in chunks]
    outs = [[] for _ in chunks]
    pos = [0] * len(chunks)
    while True:
        fed_any = False
        for s, fr in enumerate(frames):
            if pos[s] < len(fr):
                pool.feed(s, fr[pos[s]:pos[s] + feed_piece])
                pos[s] += feed_piece
                fed_any = True
        while pool.service():
            pass
        for s in range(len(chunks)):
            got = pool.fetch(s, pool.readable(s))
            if len(got):
                outs[s].append(got)
        if not fed_any:
            break
    for s in range(len(chunks)):
        pool.end_stream(s)
        got = pool.fetch(s, pool.readable(s))
        if len(got):
            outs[s].append(got)
    return [np.concatenate(o) for o in outs]


@pytest.mark.parametrize("synth_mode", ["harmonic", "pbp"])
def test_pool_matches_solo_bitexact(voices, synth_mode):
    """Every stream equals its solo stream_chunk(block=16) bit for bit, in
    harmonic and in PbP mode (the JAX suite holds PbP within 1e-5)."""
    chunks = [v[0] for v in voices]
    if synth_mode == "pbp":
        chunks = [tl1.chunk_to_layer1(c) for c in chunks[:2]]
    pool = StreamPool(SOPT, OPT.conf, n_streams=len(chunks), feed_block=16,
                      synth_mode=synth_mode, device="cpu")
    got = _drain_pool(pool, chunks)
    for s, c in enumerate(chunks):
        ref = _solo(c, s, synth_mode=synth_mode)
        assert got[s].shape == ref.shape
        np.testing.assert_array_equal(got[s], ref)
        assert float(np.std(got[s])) > 1e-3


def test_pool_one_dispatch_per_tick(voices):
    """test_rtserve.py: every due stream rides one render a tick, so the
    render count is bounded by the longest stream's ticks."""
    pool = StreamPool(SOPT, OPT.conf, n_streams=3, feed_block=8, device="cpu")
    for s, (c, _, _) in enumerate(voices):
        pool.feed(s, c)
    timings = []
    assert pool.service(timings) == 3
    assert pool.dispatches == 1
    assert set(timings[0]) == {"assemble", "render", "commit"}
    while pool.service():
        pass
    longest = max(c.nfrm for c, _, _ in voices)
    assert pool.dispatches <= -(-longest // 8) + 1
    assert all(pool.queued(s) <= 8 for s in range(3))


def test_stream_recycling_and_idle_streams(voices):
    """end_stream + reset_stream reuse a slot with unchanged output; idle
    streams of a wider pool render nothing."""
    c = [v[0] for v in voices]
    pool = StreamPool(SOPT, OPT.conf, n_streams=4, feed_block=16, device="cpu")
    got = _drain_pool(pool, c[:2])
    np.testing.assert_array_equal(got[0], _solo(c[0], 0))
    pool.reset_stream(0)
    pool.reset_stream(1)
    got2 = _drain_pool(pool, [c[2], c[0]])
    np.testing.assert_array_equal(got2[0], _solo(c[2], 0))
    np.testing.assert_array_equal(got2[1], _solo(c[0], 1))
    assert pool.readable(2) == pool.readable(3) == 0


def test_pool_matches_jax_pool(voices):
    """A carried-across JAX chunk through both packages' pools: within
    2e-5 (the stream tolerance)."""
    _, x, f0 = voices[1]
    jopt = dataclasses.replace(jpkg.create_aoptions(**CONF),
                               track_denoise=False, use_pallas=True)
    j = jl0.analyze(jopt, x, f0)
    t = chunk_from_numpy({f: np.asarray(getattr(j, f)) for f in CHUNK_FIELDS
                          if getattr(j, f) is not None}, OPT.conf,
                         device="cpu")
    jpool = jserve.StreamPool(jpkg.create_soptions(), jopt.conf,
                              n_streams=2, feed_block=16)
    tpool = StreamPool(SOPT, OPT.conf, n_streams=2, feed_block=16,
                       device="cpu")
    outs = []
    for pool, c in ((jpool, j), (tpool, t)):
        pool.feed(1, c)
        while pool.service():
            pass
        pool.end_stream(1)
        outs.append(pool.fetch(1, pool.readable(1)))
    assert outs[1].shape == outs[0].shape
    np.testing.assert_allclose(outs[1], outs[0], atol=2e-5)


def test_refusals(voices):
    c = tl1.chunk_to_layer1(voices[0][0])
    four = types.SimpleNamespace(axis_names=("batch",), shape={"batch": 4},
                                 index=lambda axis: 0, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        StreamPool(SOPT, OPT.conf, n_streams=2, mesh=four)
    pool = StreamPool(SOPT, OPT.conf, n_streams=2, feed_block=16,
                      synth_mode="pbp", device="cpu")
    pool.streams[1].sopt = dataclasses.replace(SOPT, pbp_oversample=2)
    pool.feed(0, c)
    pool.feed(1, c)
    with pytest.raises(ValueError, match="pbp_oversample"):
        pool.service()
