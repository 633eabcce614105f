"""The PyTorch port's streaming runtime (libllsm2_tpu_torch/runtime: the
native OLA ring and the streaming synthesizer) against the JAX package's
on the CPU.  The JAX chunks (0.5 s at the small verification shapes, the
Pallas branch in interpret mode) are carried across, so both packages
render the same frames; both draw the same numpy noise.  Each test states
its tolerance."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import layer1 as jl1
from libllsm2_tpu.runtime import native as jnative
from libllsm2_tpu.runtime import rtsynth as jrt
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import CHUNK_FIELDS, chunk_from_numpy
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.models import pbp as tpbp
from libllsm2_tpu_torch.runtime import native as tnative
from libllsm2_tpu_torch.runtime import rtsynth as trt
from libllsm2_tpu_torch.utils import metrics as tmetrics
from libllsm2_tpu_torch.utils import testsig as tts

torch.set_num_threads(1)

CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
HARMONIC = [("absolute", 0), ("absolute", 16), ("propagate", 0),
            ("propagate", 16)]


@pytest.fixture(scope="module")
def chunks():
    """test_runtime.py's TestFeedMany chunk through the JAX analysis
    (small shapes, Pallas in interpret mode) and its layer-1 chunk: (JAX
    layer 0, port layer 0, JAX layer 1, port layer 1), the port's on the
    CPU."""
    x, f0 = jts.make_test_utterance(duration=0.5, noise_level=0.03)
    opt = dataclasses.replace(jpkg.create_aoptions(**CONF), use_pallas=True)
    j0 = jl0.analyze(opt, x, f0)
    j1 = jl1.chunk_to_layer1(j0)
    carry = lambda c: chunk_from_numpy(
        {f: np.asarray(getattr(c, f)) for f in CHUNK_FIELDS
         if getattr(c, f) is not None}, tpkg.ChunkConf(**CONF), device="cpu")
    return j0, carry(j0), j1, carry(j1)


def _ring_ops(seed, capacity, n_ops):
    """A random add / advance / read sequence that wraps a ring of
    `capacity` samples many times and tries writes behind the read point
    and past capacity (which must raise)."""
    rng = np.random.default_rng(seed)
    ops, w = [], 0
    for _ in range(n_ops):
        kind = rng.integers(0, 4)
        if kind < 2:
            n = int(rng.integers(1, capacity // 2))
            pos = max(w - int(rng.integers(0, capacity // 2)), 0)
            ops.append(("add", rng.standard_normal(n).astype(np.float32), pos))
            w = max(w, pos + n) if rng.random() < 0.9 else w
        elif kind == 2:
            ops.append(("advance", w - int(rng.integers(0, 8))))
        else:
            ops.append(("read", int(rng.integers(0, capacity))))
    ops.append(("add", np.zeros(capacity + 1, np.float32), w))   # overrun
    return ops


def _apply(ring, ops):
    out = []
    for op in ops:
        try:
            if op[0] == "add":
                ring.add(op[1], op[2])
                out.append(None)
            elif op[0] == "advance":
                ring.advance(op[1])
                out.append(ring.readable())
            else:
                out.append(ring.read(op[1]))
        except BufferError:
            out.append("overrun")
    return out


@pytest.mark.parametrize("seed,capacity", [(0, 32), (1, 64), (2, 257)])
def test_ring_matches_jax(seed, capacity):
    """The port's native ring, its plain twin and the JAX package's native
    ring over one add / advance / read sequence with wraparound and
    overruns: every read and readable count equal, bit for bit."""
    ops = _ring_ops(seed, capacity, 400)
    ref = _apply(jnative.OLARing(capacity), ops)
    assert any(isinstance(r, str) for r in ref)
    assert sum(len(r) for r in ref if isinstance(r, np.ndarray)) > capacity
    for ring in (tnative.OLARing(capacity), tnative._PyRing(capacity)):
        got = _apply(ring, ops)
        for a, b in zip(got, ref):
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b


def test_ring_builds_from_source_into_build_native():
    ring = tnative.OLARing(16)
    ring.add(np.ones(4, np.float32), 0)
    ring.advance(4)
    np.testing.assert_array_equal(ring.read(8), np.ones(4))
    assert os.path.isfile(tnative._SO_PATH)
    assert os.path.dirname(tnative._SO_PATH).endswith(
        os.path.join("build", "native"))
    with pytest.raises(BufferError):
        ring.add(np.zeros(17, np.float32), 4)


@pytest.mark.parametrize("phase_mode,block", HARMONIC)
def test_stream_chunk_matches_jax(chunks, phase_mode, block):
    """stream_chunk on the same carried chunk: within 2e-5 of the JAX
    package's (test_runtime.py's feed / feed_many tolerance)."""
    j0, t0, _, _ = chunks
    sopt_j, sopt_t = jpkg.create_soptions(), tpkg.create_soptions()
    ref = jrt.stream_chunk(sopt_j, j0, block=block, phase_mode=phase_mode)
    got = trt.stream_chunk(sopt_t, t0, block=block, phase_mode=phase_mode)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("block", [0, 16])
def test_stream_pbp_matches_jax(chunks, block):
    """PbP streaming on the carried layer-1 chunk: within 2e-4 of the JAX
    package's (test_runtime.py's PbP tolerance)."""
    _, _, j1, t1 = chunks
    ref = jrt.stream_chunk(jpkg.create_soptions(), j1, block=block,
                           synth_mode="pbp")
    got = trt.stream_chunk(tpkg.create_soptions(), t1, block=block,
                           synth_mode="pbp")
    assert got.shape == ref.shape and float(np.std(got)) > 1e-3
    np.testing.assert_allclose(got, ref, atol=2e-4)


@pytest.mark.parametrize("synth_mode,tol", [("harmonic", 2e-5),
                                            ("pbp", 2e-4)])
def test_feed_many_matches_per_frame(chunks, synth_mode, tol):
    """As test_runtime.py's TestFeedMany, on the port: feed_many within
    2e-5 of per-frame feed (PbP 2e-4)."""
    t = chunks[1] if synth_mode == "harmonic" else chunks[3]
    sopt = tpkg.create_soptions()
    y1 = trt.stream_chunk(sopt, t, synth_mode=synth_mode)
    y2 = trt.stream_chunk(sopt, t, block=32, synth_mode=synth_mode)
    assert y1.shape == y2.shape
    np.testing.assert_allclose(y2, y1, atol=tol)


def test_dispatch_count_bounded(chunks):
    """test_runtime.py's dispatch counts on the port: feed_many of a whole
    chunk renders at most nfrm // feed_block + 2 times, per-frame feed
    once a frame, and the first under an eighth of the second."""
    t = chunks[1]
    sopt = tpkg.create_soptions()
    rt = trt.RTSynthesizer(sopt, t.conf, capacity_frames=t.nfrm + 8,
                           device="cpu")
    rt.feed_many(t)
    rt.flush()
    assert rt.dispatches <= t.nfrm // rt.feed_block + 2, rt.dispatches
    rt2 = trt.RTSynthesizer(sopt, t.conf, capacity_frames=t.nfrm + 8,
                            device="cpu")
    for i in range(t.nfrm):
        rt2.feed(t.frame(i))
    rt2.flush()
    assert rt2.dispatches == t.nfrm
    assert rt.dispatches * 8 < rt2.dispatches


def test_latency_reset_and_frame_inputs(chunks):
    """Two hops of latency (test_runtime.py), a reset synthesizer renders
    as a fresh one, and 1-frame chunks, field dicts and a whole chunk feed
    the same frames."""
    t = chunks[1]
    sopt = tpkg.create_soptions()
    rt = trt.RTSynthesizer(sopt, t.conf, capacity_frames=t.nfrm + 8,
                           device="cpu")
    rt.feed(t.frame(0))
    assert rt.readable() == 0
    rt.feed(t.frame(1))
    assert rt.readable() == 0
    rt.feed(t.frame(2))
    assert rt.readable() == t.conf.nhop
    rt.reset()
    dicts = trt.RTSynthesizer.chunk_frames_np(t)
    rt.feed_many(dicts)
    rt.flush()
    a = rt.fetch(rt.readable())
    rt2 = trt.RTSynthesizer(sopt, t.conf, capacity_frames=t.nfrm + 8,
                            device="cpu")
    rt2.feed_many([t.frame(i) for i in range(t.nfrm)])
    rt2.flush()
    np.testing.assert_array_equal(rt2.fetch(rt2.readable()), a)
    np.testing.assert_array_equal(
        a, trt.stream_chunk(sopt, t, block=rt.feed_block))


def test_render_reads_only_noise_seed_and_oversample(chunks):
    """use_pallas=False in the synthesis options is not refused: the
    stream render has no kernel branch (the JAX package's neither)."""
    t = chunks[1]
    sopt = dataclasses.replace(tpkg.create_soptions(), use_pallas=False)
    y = trt.stream_chunk(sopt, t, block=16)
    np.testing.assert_array_equal(
        y, trt.stream_chunk(tpkg.create_soptions(), t, block=16))


def test_default_device_is_the_card(chunks):
    t = chunks[1]
    rt = trt.RTSynthesizer(tpkg.create_soptions(), t.conf)
    assert rt.device.type == "cuda"
    if not torch.cuda.is_available():
        rt.feed(t.frame(0))
        with pytest.raises((AssertionError, RuntimeError)):
            rt.feed(t.frame(1))


def test_stream_matches_offline_on_the_port():
    """test_runtime.py's offline oracles on the port's own analysis
    (library default, its 0.6 s fixtures): the stream against the offline
    harmonic part > 15 dB (breath noise 0.05), PbP streaming against
    offline PbP > 35 dB."""
    opt = dataclasses.replace(tpkg.create_aoptions(), use_pallas=True)
    sopt = dataclasses.replace(tpkg.create_soptions(), use_pallas=True)

    def analyze(**kw):
        x, f0 = tts.make_test_utterance(duration=0.6, **kw)
        return tl0.analyze(opt, x.astype(np.float32), f0.astype(np.float32),
                           device="cpu")

    ch = analyze(noise_level=0.05)
    off = tl0.synthesize(sopt, ch).y_sin.numpy()
    y = trt.stream_chunk(sopt, ch)
    n = min(len(y), len(off))
    assert tmetrics.snr_db(off[:n], y[:n]) > 15.0
    l1 = tl1.chunk_to_layer1(analyze())
    y_off = tpbp.pbp_synthesize(sopt, l1).y_sin.numpy()
    y_st = trt.stream_chunk(sopt, l1, synth_mode="pbp")
    n = min(len(y_st), len(y_off))
    assert tmetrics.snr_db(y_off[:n], y_st[:n]) > 35.0
