"""The PyTorch port's learned models, serving pool and checkpoints over a
mesh of torch.distributed ranks (gloo, the CPU): test_neural.py's
data-parallel step and tensor-parallel-matches-DP, test_acoustic.py's
data-parallel step, the VQ codec's data-parallel step, a masked loss
whose ranks hold different mask counts, test_rtserve.py's two mesh cases
and test_dspkit.py's checkpoint round trip on the port's
torch.distributed.checkpoint directories.

One world of 4 ranks (torch.multiprocessing.spawn, FileStore rendezvous)
runs every sharded case once; the one-process references run here in the
parent.  Nothing here imports jax."""
import dataclasses
import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import chunk_from_numpy, chunk_to_numpy
from libllsm2_tpu_torch.models import acoustic as tac
from libllsm2_tpu_torch.models import layer0 as tl0
from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.models import neural as tnn
from libllsm2_tpu_torch.models import vq as tvq
from libllsm2_tpu_torch.parallel import distributed as tdist
from libllsm2_tpu_torch.parallel import mesh as tmesh
from libllsm2_tpu_torch.runtime import rtsynth as trt
from libllsm2_tpu_torch.runtime.rtserve import StreamPool
from libllsm2_tpu_torch.utils import serialize as tser
from libllsm2_tpu_torch.utils import testsig as tts

torch.set_num_threads(1)

RANKS = 4
CONF = dict(maxnhar=24, npsd=32, nspec=65, f0_floor=90.0, fnyq=6000.0)
OPT = dataclasses.replace(tpkg.create_aoptions(**CONF), track_denoise=False,
                          use_pallas=True)
SOPT = tpkg.create_soptions()
DIMS = 20
AE = tnn.AEConfig(dims=DIMS, hidden=32, latent=8, depth=1)
AC = tac.AcousticConfig(dims=DIMS, n_phones=6, hidden=16, embed=8,
                        dilations=(1, 2))
VQ = tvq.VQConfig(dims=DIMS, hidden=32, latent=8, depth=1, groups=4,
                  codebook=16)


def _vectors(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((n, DIMS)), dtype=torch.float32)


def _mask(n=64):
    """Frames kept: rank r's 16 rows keep 16 - 4 r (different counts)."""
    m = np.zeros((n,), np.float32)
    for r in range(RANKS):
        m[16 * r:16 * r + 16 - 4 * r] = 1.0
    return torch.tensor(m)


def _acoustic_batch(B=8, N=24, seed=1):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), np.float32)
    for b in range(B):                      # ragged lengths: other counts
        mask[b, N - 2 * b:] = 0.0
    return (torch.tensor(rng.integers(0, AC.n_phones, (B, N))),
            torch.tensor(rng.standard_normal((B, N, AC.n_feats)),
                         dtype=torch.float32),
            torch.tensor(rng.standard_normal((B, N, DIMS)),
                         dtype=torch.float32),
            torch.tensor(mask))


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _drain(pool, chunks, feed_piece=7):
    """test_rtserve.py's drain: feed small pieces, service as they come,
    end every stream -> each stream's audio."""
    frames = [trt.RTSynthesizer.chunk_frames_np(c) for c in chunks]
    outs = [[] for _ in chunks]
    for p in range(0, max(map(len, frames)), feed_piece):
        for s, fr in enumerate(frames):
            if p < len(fr):
                pool.feed(s, fr[p:p + feed_piece])
        while pool.service():
            pass
        for s in range(len(chunks)):
            outs[s].append(pool.fetch(s, pool.readable(s)))
    for s in range(len(chunks)):
        pool.end_stream(s)
        outs[s].append(pool.fetch(s, pool.readable(s)))
    return [np.concatenate(o) for o in outs]


def _rank(r, n, d):
    torch.set_num_threads(1)
    tdist.initialize_multihost(f"file://{d}/store", n, r, timeout_s=300)
    out = {}
    m = tmesh.make_mesh(n, device="cpu")                 # (batch 4, frame 1)
    # the AE, data-parallel: one step, and 5 steps of the masked loss
    model = tnn.init_params(AE, torch.Generator().manual_seed(1), "cpu")
    opt = tnn.make_optimizer(AE, model)
    x = tmesh.shard_batch(_vectors(), m)
    model, opt, loss = tnn.train_step(AE, model, opt, x, mesh=m)
    out["dp"] = (float(loss), _state(model))
    mask = tmesh.shard_batch(_mask(), m)
    out["masked"] = float(tnn.loss_fn(AE, model, x, mask, mesh=m))
    # tensor parallel over (batch 2, model 2): 5 steps
    tm = tmesh.make_tp_mesh(n, model_parallel=2, device="cpu")
    model = tnn.shard_params_tp(AE, tnn.init_params(
        AE, torch.Generator().manual_seed(3), "cpu"), tm)
    opt = tnn.make_optimizer(AE, model)
    x = tmesh.shard_batch(_vectors(seed=3), tm)
    losses = []
    for _ in range(5):
        model, opt, loss = tnn.train_step(AE, model, opt, x, mesh=tm)
        losses.append(float(loss))
    out["tp"] = (losses, tuple(model.enc_in.weight.shape))
    # the acoustic model, data-parallel, ragged masks
    model = tac.init_params(AC, torch.Generator().manual_seed(2), "cpu")
    opt = tac.make_optimizer(AC, model)
    batch = tmesh.shard_batch(_acoustic_batch(), m)
    model, opt, loss = tac.train_step(AC, model, opt, batch, mesh=m)
    out["acoustic"] = (float(loss), _state(model))
    # the VQ codec, data-parallel (its commitment means global too)
    model = tvq.init_params(VQ, torch.Generator().manual_seed(4), "cpu")
    opt = tvq.make_optimizer(VQ, model)
    x = tmesh.shard_batch(_vectors(seed=4), m)
    model, opt, rec = tvq.train_step(VQ, model, opt, x, mesh=m)
    out["vq"] = (float(rec), _state(model))
    # the pool: 8 streams (4 fed) over 4 ranks, then PbP, 4 streams
    with open(f"{d}/voices.pkl", "rb") as f:
        voices, l1 = pickle.load(f)
    voices = [chunk_from_numpy(v, OPT.conf, device="cpu") for v in voices]
    pool = StreamPool(SOPT, OPT.conf, n_streams=8, feed_block=8, mesh=m)
    out["pool"] = _drain(pool, voices + voices[:1])
    try:
        StreamPool(SOPT, OPT.conf, n_streams=6, mesh=m)
        out["pool6"] = None
    except ValueError as e:
        out["pool6"] = str(e)
    pool = StreamPool(SOPT, OPT.conf, n_streams=4, feed_block=16,
                      synth_mode="pbp", mesh=m)
    out["pbp"] = _drain(pool, [chunk_from_numpy(l1, OPT.conf,
                                                device="cpu")])
    # a chunk written by 2 frame blocks (ranks of one block write it once)
    mf = tmesh.make_mesh(n, frame_parallel=2, device="cpu")
    tser.chunk_save_orbax(f"{d}/ckpt", voices[0], mesh=mf)
    with open(f"{d}/rank{r}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def voices():
    """test_rtserve.py's three voices through the port's analysis, and the
    first one's layer-1 chunk."""
    out = []
    for dur, f0b in ((0.8, 120.0), (0.6, 200.0), (1.0, 160.0)):
        f0 = tts.make_f0_track(int(dur / OPT.conf.thop), OPT.conf.thop,
                               f0_base=f0b)
        x, _ = tts.synth_lf_speech(f0, noise_level=0.02)
        out.append(tl0.analyze(OPT, np.asarray(x, np.float32),
                               np.asarray(f0, np.float32), device="cpu"))
    return out, tl1.chunk_to_layer1(out[0])


@pytest.fixture(scope="module")
def world(tmp_path_factory, voices):
    d = str(tmp_path_factory.mktemp("world"))
    chunks, l1 = voices
    with open(f"{d}/voices.pkl", "wb") as f:
        pickle.dump(([chunk_to_numpy(c) for c in chunks],
                     chunk_to_numpy(l1)), f)
    mp.spawn(_rank, args=(RANKS, d), nprocs=RANKS)
    ranks = []
    for r in range(RANKS):
        with open(f"{d}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, d


def test_dp_train_step(world):
    """test_neural's sharded step: the loss is the whole batch's (the
    one-process loss), the parameters stay replicated (equal on every rank
    after the step) and equal the one-process step's."""
    ranks, _ = world
    model = tnn.init_params(AE, torch.Generator().manual_seed(1), "cpu")
    opt = tnn.make_optimizer(AE, model)
    model, opt, loss = tnn.train_step(AE, model, opt, _vectors())
    ref = _state(model)
    for o in ranks:
        l_r, state = o["dp"]
        np.testing.assert_allclose(l_r, float(loss), rtol=1e-6)
        for k, v in state.items():
            np.testing.assert_array_equal(v, ranks[0]["dp"][1][k])
            np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-6)


def test_masked_loss_global_over_ranks(world):
    """Ranks whose masks keep 16, 12, 8 and 4 frames: the mesh loss is the
    one-process masked MSE of the whole batch (numerator and count summed
    over the ranks), not the mean of the ranks' own means."""
    ranks, _ = world
    model = tnn.init_params(AE, torch.Generator().manual_seed(1), "cpu")
    opt = tnn.make_optimizer(AE, model)
    model, opt, _ = tnn.train_step(AE, model, opt, _vectors())
    x, mask = _vectors(), _mask()
    ref = float(tnn.loss_fn(AE, model, x, mask))
    means = [float(tnn.loss_fn(AE, model, x[16 * r:16 * r + 16],
                               mask[16 * r:16 * r + 16]))
             for r in range(RANKS)]
    assert abs(np.mean(means) - ref) > 1e-3 * ref   # the case tells apart
    for o in ranks:
        np.testing.assert_allclose(o["masked"], ref, rtol=1e-5)


def test_tensor_parallel_train_step_matches_dp(world):
    """Megatron-style sharding over a (batch 2, model 2) mesh: the 5-step
    losses match the unsharded run (rtol 2e-2, bfloat16 operands) and each
    rank holds half the hidden columns of enc_in."""
    ranks, _ = world
    model = tnn.init_params(AE, torch.Generator().manual_seed(3), "cpu")
    opt = tnn.make_optimizer(AE, model)
    ref = []
    for _ in range(5):
        model, opt, loss = tnn.train_step(AE, model, opt, _vectors(seed=3))
        ref.append(float(loss))
    for o in ranks:
        losses, shape = o["tp"]
        np.testing.assert_allclose(losses, ref, rtol=2e-2)
        assert shape == (AE.hidden // 2, DIMS)


def test_tp_param_specs():
    """The layout of the JAX package's tp_param_specs on nn.Linear's
    [out, in] weights: column-parallel entries, row-parallel rest."""
    specs = tnn.tp_param_specs(AE)
    assert specs["enc_in"] == specs["dec_in"] == {
        "weight": (0, tmesh.MODEL_AXIS), "bias": (0, tmesh.MODEL_AXIS)}
    for name in ("enc_out", "dec_out", "enc_res.0", "dec_res.0"):
        assert specs[name] == {"weight": (1, tmesh.MODEL_AXIS), "bias": None}


def test_acoustic_dp_train_step(world):
    """test_acoustic's data-parallel step with ragged masks: the global
    masked loss, parameters replicated and equal to the one-process
    step's."""
    ranks, _ = world
    model = tac.init_params(AC, torch.Generator().manual_seed(2), "cpu")
    opt = tac.make_optimizer(AC, model)
    model, opt, loss = tac.train_step(AC, model, opt, _acoustic_batch())
    ref = _state(model)
    for o in ranks:
        l_r, state = o["acoustic"]
        np.testing.assert_allclose(l_r, float(loss), rtol=1e-5)
        for k, v in state.items():
            np.testing.assert_array_equal(v, ranks[0]["acoustic"][1][k])
            np.testing.assert_allclose(v, ref[k], rtol=1e-4, atol=1e-6)


def test_vq_dp_train_step(world):
    """The VQ codec's data-parallel step: the reconstruction loss that of
    the one-process step, the parameters equal on every rank and those of
    the one-process step.  Adam's first step moves every element by +-lr
    whatever its gradient's size, so an element whose gradient is rounding
    noise (an unused code's) may step the other way: at most 1% of the
    elements may differ, each by at most 2 lr."""
    ranks, _ = world
    model = tvq.init_params(VQ, torch.Generator().manual_seed(4), "cpu")
    opt = tvq.make_optimizer(VQ, model)
    model, opt, rec = tvq.train_step(VQ, model, opt, _vectors(seed=4))
    ref = _state(model)
    for o in ranks:
        r_r, state = o["vq"]
        np.testing.assert_allclose(r_r, float(rec), rtol=1e-5)
        for k, v in state.items():
            np.testing.assert_array_equal(v, ranks[0]["vq"][1][k])
            off = ~np.isclose(v, ref[k], rtol=1e-4, atol=1e-6)
            assert off.mean() <= 0.01, (k, off.sum())
            assert np.abs(v - ref[k]).max() <= 2 * VQ.lr, k


def _solo(chunk, s, **kw):
    sopt = dataclasses.replace(SOPT, noise_seed=SOPT.noise_seed + s)
    return trt.stream_chunk(sopt, chunk, **kw)


def test_pool_sharded_over_mesh_matches_solo(world, voices):
    """The tick's render sharded over 4 ranks (8 streams, 4 fed): every
    rank's every stream equals its solo render bit for bit; a width that
    does not split over the ranks is refused."""
    ranks, _ = world
    chunks, _ = voices
    fed = chunks + chunks[:1]
    for o in ranks:
        for s, c in enumerate(fed):
            np.testing.assert_array_equal(o["pool"][s], _solo(c, s, block=8))
        assert "divide" in o["pool6"]


def test_pool_sharded_pbp_matches_solo(world, voices):
    """PbP pulses under the mesh (the pooled pulse groups round up to a
    multiple of the ranks): within 1e-5 of the solo PbP stream."""
    ranks, _ = world
    _, l1 = voices
    ref = _solo(l1, 0, block=16, synth_mode="pbp")
    for o in ranks:
        assert o["pbp"][0].shape == ref.shape
        np.testing.assert_allclose(o["pbp"][0], ref, atol=1e-5)
        assert float(np.std(o["pbp"][0])) > 1e-3


@pytest.mark.parametrize("writers", [1, 2])
def test_orbax_roundtrip(tmp_path, world, voices, writers):
    """test_dspkit's checkpoint round trip on the port's
    torch.distributed.checkpoint directory, written by one process or by
    the ranks of 2 frame blocks, loaded by one process: the conf and every
    field back."""
    chunks, _ = voices
    chunk = chunks[0]
    if writers == 1:
        path = str(tmp_path / "ckpt")
        tser.chunk_save_orbax(path, chunk)
    else:
        path = f"{world[1]}/ckpt"
    back = tser.chunk_load_orbax(path, device="cpu")
    assert back.conf == chunk.conf
    for k, v in chunk_to_numpy(chunk).items():
        np.testing.assert_array_equal(chunk_to_numpy(back)[k], v)
