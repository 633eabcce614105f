"""The PyTorch port's pulse-by-pulse synthesis against the JAX package on
the CPU, on a 0.8 s LF fixture (as tests/test_pbp.py) carried across as a
JAX layer-1 chunk: the pulse onsets, y_sin, and y_nos with the JAX noise
bins injected through bins=.  Utterances stay under 1 s:
the onsets come from a float32 cumsum of f0 thop, which two libraries sum
in different orders."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import layer1 as jl1
from libllsm2_tpu.models import pbp as jpbp
from libllsm2_tpu.utils import testsig as jts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import CHUNK_FIELDS, chunk_from_numpy
from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.models import pbp as tpbp
from libllsm2_tpu_torch.ops import kernels

from test_torch_layer0 import _jax_bins

torch.set_num_threads(1)


def _sopt(pkg):
    return dataclasses.replace(pkg.create_soptions(), use_pallas=True)


@pytest.fixture(scope="module")
def ref():
    """Two 0.8 s LF utterances (Rd 0.7 and a 0.5 -> 2.0 track, the second
    with an unvoiced tail): JAX layer-1 chunks and JAX PbP outputs."""
    rows = []
    for seed, rd, tail in ((0, 0.7, 0.0), (1, np.linspace(0.5, 2.0, 160), 0.15)):
        f0 = jts.make_f0_track(160, 0.005, unvoiced_tail_frac=tail)
        x, f0 = jts.synth_lf_speech(f0, rd=rd, seed=seed)
        opt = dataclasses.replace(jpkg.create_aoptions(), use_pallas=True)
        l1 = jl1.chunk_to_layer1(jl0.analyze(opt, x.astype(np.float32),
                                             f0.astype(np.float32)))
        rows.append((l1, jpbp.pbp_synthesize(_sopt(jpkg), l1)))
    d = {f: np.stack([np.asarray(getattr(l1, f)) for l1, _ in rows])
         for f in CHUNK_FIELDS}
    return rows, chunk_from_numpy(d, tpkg.ChunkConf(), device="cpu")


def test_pulse_onsets_match(ref):
    """Onset times within 1e-6 s relative, onset frames and validity equal."""
    rows, chunk = ref
    conf = chunk.conf
    p_max = int(chunk.nfrm * conf.thop * conf.f0_ceil) + 2
    t_on, frame_of, valid = tpbp._pulse_onsets(chunk.f0, conf.thop, p_max)
    for b, (l1, _) in enumerate(rows):
        tj, fj, vj = map(np.asarray, jpbp._pulse_onsets(l1.f0, conf.thop, p_max))
        np.testing.assert_allclose(t_on[b].numpy(), tj, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(frame_of[b].numpy(), fj)
        np.testing.assert_array_equal(valid[b].numpy(), vj)
        assert vj.sum() > 50


def test_pbp_y_sin_matches(ref):
    """PbP y_sin of both rows (one batched call) against the JAX render:
    within 1e-3 x peak and an error 60 dB under the signal (float32
    pulse spectra and irffts of two libraries, summed at other orders)."""
    rows, chunk = ref
    out = tpbp._pbp_synthesize(_sopt(tpkg), chunk)
    for b, (_, jout) in enumerate(rows):
        yj, yt = np.asarray(jout.y_sin), out.y_sin[b].numpy()
        err = yt - yj
        np.testing.assert_allclose(yt, yj, atol=1e-3 * np.abs(yj).max())
        assert 10 * np.log10(np.sum(yj ** 2) / np.sum(err ** 2)) > 60.0


def test_pbp_y_nos_matches_with_jax_bins(ref):
    """The noise part through layer0._synth_noise (noise_mod_ola's twin on
    the CPU) with the JAX bins injected: 1e-4 absolute, as layer 0's."""
    rows, chunk = ref
    nbin = chunk.conf.nhop + 1
    bins = [_jax_bins(_sopt(jpkg).noise_seed, chunk.nfrm, nbin)] * 2
    out = tpbp._pbp_synthesize(_sopt(tpkg), chunk,
                               bins=tuple(np.stack(v) for v in zip(*bins)))
    for b, (_, jout) in enumerate(rows):
        np.testing.assert_allclose(out.y_nos[b].numpy(), np.asarray(jout.y_nos),
                                   atol=1e-4)
        np.testing.assert_allclose(out.y[b].numpy(), np.asarray(jout.y),
                                   atol=1e-3)


def test_pbp_rows_independent_of_grouping(ref, monkeypatch):
    """Rendering the pulses one row group at a time (the memory bound at
    full batch) gives each row exactly what it gives alone; the public
    single-chunk call gives the batched row."""
    _, chunk = ref
    whole = tpbp._pbp_sin(chunk, 4)
    monkeypatch.setattr(tpbp, "_PULSE_ELEMS", 1)
    np.testing.assert_array_equal(tpbp._pbp_sin(chunk, 4).numpy(),
                                  whole.numpy())
    single = chunk.replace(**{f: getattr(chunk, f)[1] for f in CHUNK_FIELDS})
    out = tpkg.models.pbp_synthesize(_sopt(tpkg), single)
    assert out.y_sin.shape == whole[1].shape
    np.testing.assert_allclose(out.y_sin.numpy(), whole[1].numpy(), atol=1e-6)


def test_pbp_refuses_layer0_chunks_and_runs_no_kernel_on_cpu(ref):
    _, chunk = ref
    with pytest.raises(ValueError, match="layer-1"):
        tpbp.pbp_synthesize(_sopt(tpkg), chunk.replace(rd=None))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpbp.pbp_synthesize(tpkg.create_soptions(), chunk)
    kernels.reset_launches()
    tl1.chunk_to_layer0(chunk)
    tpbp._pbp_synthesize(_sopt(tpkg), chunk)
    assert all(v == 0 for v in kernels.LAUNCHES.values())
