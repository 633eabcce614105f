"""The PyTorch port's streaming analysis (runtime/rtanalyze.py) against the
JAX package's on the CPU, at tests/test_rtanalyze.py's shapes (small
verification conf, 1 s with breath noise 0.04, blocks of 32 hops with 24
of halo, fed in misaligned pieces), the Pallas branch in interpret mode;
then test_rtanalyze.py's floors on the port against its own offline
analysis.  Each test states its tolerance."""
import dataclasses

import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.runtime import rtanalyze as jrta
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import chunk_to_numpy
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.runtime import rtanalyze as trta

torch.set_num_threads(1)

CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)


def _opt(pkg, denoise):
    return dataclasses.replace(pkg.create_aoptions(**CONF),
                               track_denoise=denoise, use_pallas=True)


def _stream(mod, opt, x, f0, x_pieces=997, f0_pieces=13, **kw):
    """test_rtanalyze.py's feed in deliberately misaligned pieces."""
    rta = mod.RTAnalyzer(opt, block_hops=32, halo_hops=24, **kw)
    outs = []
    xi = fi = 0
    while xi < len(x) or fi < len(f0):
        got = rta.feed(x[xi:xi + x_pieces] if xi < len(x) else None,
                       f0[fi:fi + f0_pieces] if fi < len(f0) else None)
        if got is not None:
            outs.append(got)
        xi += x_pieces
        fi += f0_pieces
    tail = rta.flush()
    if tail is not None:
        outs.append(tail)
    return mod.concat_frames(outs)


@pytest.fixture(scope="module")
def signal():
    x, f0 = jts.make_test_utterance(duration=1.0, noise_level=0.04)
    return np.asarray(x, np.float32), np.asarray(f0, np.float32)


def _snr(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    err = np.sum((ref - got) ** 2)
    return 10 * np.log10(np.sum(ref ** 2) / max(err, 1e-30))


@pytest.mark.parametrize("denoise", [False, True])
def test_stream_matches_jax(signal, denoise):
    """The port's streamed frames against the JAX package's, with
    tests/test_torch_layer0.py's tolerances on the analysis chunk."""
    x, f0 = signal
    j = _stream(jrta, _opt(jpkg, denoise), x, f0)
    t = chunk_to_numpy(_stream(trta, _opt(tpkg, denoise), x, f0,
                               device="cpu"))
    assert t["f0"].shape == np.asarray(j.f0).shape == f0.shape
    np.testing.assert_allclose(t["f0"], np.asarray(j.f0), rtol=1e-4)
    np.testing.assert_array_equal(t["hm_mask"], np.asarray(j.hm_mask))
    np.testing.assert_allclose(t["ampl"], np.asarray(j.ampl), atol=1e-3)
    scale = float(np.abs(np.asarray(j.ampl)).max())
    np.testing.assert_allclose(
        t["ampl"] * np.exp(1j * t["phse"]),
        np.asarray(j.ampl) * np.exp(1j * np.asarray(j.phse)),
        atol=1e-3 * scale)
    escale = float(np.abs(np.asarray(j.eenv_a)).max())
    np.testing.assert_allclose(
        t["eenv_a"] * np.exp(1j * t["eenv_p"]),
        np.asarray(j.eenv_a) * np.exp(1j * np.asarray(j.eenv_p)),
        atol=1e-3 * escale)
    for f in ("psd", "edc"):
        jv = np.asarray(getattr(j, f))
        np.testing.assert_allclose(t[f], jv, rtol=1e-3,
                                   atol=1e-6 * float(np.abs(jv).max()))


def test_stream_equals_offline_on_the_port(signal):
    """test_rtanalyze.py's floors, the port's stream against its own
    offline analysis (denoiser off)."""
    x, f0 = signal
    opt = _opt(tpkg, False)
    off = chunk_to_numpy(tl0.analyze(opt, x, f0, device="cpu"))
    st = chunk_to_numpy(_stream(trta, opt, x, f0, device="cpu"))
    assert st["f0"].shape == off["f0"].shape
    np.testing.assert_allclose(st["f0"], off["f0"], atol=1e-3)
    assert _snr(off["ampl"], st["ampl"]) >= 45.0
    w = off["ampl"] * off["hm_mask"]
    dph = np.angle(np.exp(1j * (st["phse"] - off["phse"])))
    assert float(np.sum(w * np.abs(dph)) / np.sum(w)) < 0.05
    for f, floor in (("psd", 35.0), ("edc", 35.0), ("eenv_a", 30.0)):
        assert _snr(off[f], st[f]) >= floor, f
    we = off["eenv_a"]
    dpe = np.angle(np.exp(1j * (st["eenv_p"] - off["eenv_p"])))
    assert float(np.sum(we * np.abs(dpe)) / np.sum(we)) < 0.1


def test_feed_granularity_invariance(signal):
    """One big feed and many misaligned small feeds give equal frames."""
    x, f0 = signal
    opt = _opt(tpkg, False)
    a = _stream(trta, opt, x, f0, 10 ** 9, 10 ** 9, device="cpu")
    b = _stream(trta, opt, x, f0, 331, 7, device="cpu")
    for f in ("f0", "ampl", "phse", "psd", "eenv_a"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_short_stream_is_one_whole_analysis(signal):
    """A stream shorter than one block flushes as one analysis of the
    whole: equal to the offline analysis."""
    x, f0 = signal
    opt = _opt(tpkg, True)
    n = 60
    rta = trta.RTAnalyzer(opt, block_hops=32, halo_hops=24, device="cpu")
    assert rta.feed(x[:n * 80], f0[:n]) is None
    got = rta.flush()
    off = tl0.analyze(opt, x[:n * 80], f0[:n], device="cpu")
    for f in ("f0", "ampl", "phse", "psd", "edc", "eenv_a", "eenv_p"):
        assert torch.equal(getattr(got, f), getattr(off, f)), f
    assert rta.flush() is None


def test_concat_frames_layer1_none_and_extras(signal):
    x, f0 = signal
    ch = tl0.analyze(_opt(tpkg, False), x[:40 * 80], f0[:40], device="cpu")
    ch = ch.attach("tag", torch.arange(40.0))
    parts = [ch.map(lambda a: a[:15]), ch.map(lambda a: a[15:])]
    got = trta.concat_frames(parts)
    assert got.rd is None and got.vtmagn is None
    for f in ("f0", "ampl", "eenv_p"):
        assert torch.equal(getattr(got, f), getattr(ch, f))
    assert torch.equal(got.get("tag"), torch.arange(40.0))
    other = parts[1].replace(conf=tpkg.ChunkConf())
    with pytest.raises(ValueError):
        trta.concat_frames([parts[0], other])


def test_unported_options_raise(signal):
    """RTAnalyzer with use_pallas=False (the plain branches, which it once
    refused) against the JAX package's RTAnalyzer with its jnp branches,
    denoiser off, on the first 0.5 s: every field within 1e-3 of its
    largest value, as test_stream_matches_jax holds the kernel
    path."""
    x, f0 = signal
    x, f0 = x[:8000], f0[:100]
    got = _stream(trta, dataclasses.replace(_opt(tpkg, False),
                                            use_pallas=False), x, f0,
                  device="cpu")
    ref = _stream(jrta, dataclasses.replace(_opt(jpkg, False),
                                            use_pallas=False), x, f0)
    assert got.nfrm == ref.nfrm == len(f0)
    for f in ("ampl", "psd", "edc", "eenv_a"):
        r = np.asarray(getattr(ref, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), r,
                                   atol=1e-3 * np.abs(r).max())
