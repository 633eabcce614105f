"""The PyTorch port's learned models (models/neural.py, vq.py,
acoustic.py, abs.py) and the TTS corpus (utils/ttsdata.py) against the
JAX package on the CPU.  The networks run on weights initialized by the
JAX package and carried across (params_from_jax), on seeded numpy inputs,
at small widths; abs_refine runs on JAX-analyzed chunks carried across.
Each test states its tolerance.  The quality floors of the JAX suite on
the port's own initialization are in tests/test_torch_learned_floors.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libllsm2_tpu as jpkg
from libllsm2_tpu.models import abs as jabs
from libllsm2_tpu.models import acoustic as jac
from libllsm2_tpu.models import layer0 as jl0
from libllsm2_tpu.models import neural as jnn
from libllsm2_tpu.models import vq as jvq
from libllsm2_tpu.utils import testsig as jts
from libllsm2_tpu.utils import ttsdata as jtts

import libllsm2_tpu_torch as tpkg
from libllsm2_tpu_torch.container import chunk_from_numpy
from libllsm2_tpu_torch.models import abs as tabs
from libllsm2_tpu_torch.models import acoustic as tac
from libllsm2_tpu_torch.models import neural as tnn
from libllsm2_tpu_torch.models import vq as tvq
from libllsm2_tpu_torch.utils import ttsdata as ttts

torch.set_num_threads(1)
DIMS = 20
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params_close(model, jparams, names, atol):
    """Every carried-across parameter of `model` within atol of JAX's."""
    got = dict(model.named_parameters())
    for name, ref in names(jparams):
        np.testing.assert_allclose(got[name].detach().numpy(), ref,
                                   atol=atol, err_msg=name)


def _ae_names(p, prefix=""):
    for name in ("enc_in", "enc_out", "dec_in", "dec_out"):
        yield prefix + name + ".weight", np.asarray(p[name]["w"]).T
        yield prefix + name + ".bias", np.asarray(p[name]["b"])
    for side in ("enc", "dec"):
        i = 0
        while f"{side}_res{i}" in p:
            q = p[f"{side}_res{i}"]
            yield f"{prefix}{side}_res.{i}.weight", np.asarray(q["w"]).T
            yield f"{prefix}{side}_res.{i}.bias", np.asarray(q["b"])
            i += 1


def _ac_names(p):
    yield "embed", np.asarray(p["embed"])
    for name, port in (("in", "inp"), ("out", "out")):
        yield port + ".weight", np.asarray(p[name]["w"]).T
        yield port + ".bias", np.asarray(p[name]["b"])
    i = 0
    while f"conv{i}" in p:
        w = np.asarray(p[f"conv{i}"]["w"])
        yield f"convs.{i}.weight", w[::-1].transpose(2, 1, 0)
        yield f"convs.{i}.bias", np.asarray(p[f"conv{i}"]["b"])
        i += 1


# --- the autoencoder -------------------------------------------------------

def _ae(dtype):
    jd, td = DTYPES[dtype]
    kw = dict(dims=DIMS, hidden=32, latent=8, depth=2, lr=3e-3)
    return jnn.AEConfig(**kw, compute_dtype=jd), \
        tnn.AEConfig(**kw, compute_dtype=td)


def _ae_data(n=96, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, DIMS)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ae_forward_matches_jax(dtype):
    """float32 products: within 1e-5 of the output's scale (sums in
    other orders).  bfloat16 operands: within 2e-2 of it -- where a
    float32 activation lies near a bfloat16 rounding boundary the two
    libraries' last-bit differences round it to neighbouring bfloat16
    values (a 2^-8 relative step), which the next layers carry."""
    jc, tc = _ae(dtype)
    p = _np_tree(jnn.init_params(jc, jax.random.PRNGKey(0)))
    x = _ae_data()
    ref = np.asarray(jnn.forward(jc, p, jnp.asarray(x)))
    got = tnn.forward(tc, tnn.params_from_jax(tc, p, device="cpu"),
                      torch.from_numpy(x)).detach().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("masked", [False, True])
def test_ae_train_step_matches_jax(masked):
    """One AdamW step in float32: the loss within 1e-6 relative; every
    parameter within 1e-6 (the step moves each by about lr = 3e-3, the
    sign of its gradient: AdamW's first step)."""
    jc, tc = _ae("float32")
    p = _np_tree(jnn.init_params(jc, jax.random.PRNGKey(1)))
    x = _ae_data(seed=1).reshape(4, 24, DIMS)
    mask = (np.arange(24)[None, :] < np.array([24, 20, 16, 9])[:, None]
            ).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    p2, _, jloss = jnn.train_step(jc, p, jnn.make_optimizer(jc).init(p),
                                  jnp.asarray(x), jm)
    model = tnn.params_from_jax(tc, p, device="cpu")
    model, _, loss = tnn.train_step(
        tc, model, tnn.make_optimizer(tc, model), torch.from_numpy(x),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _params_close(model, _np_tree(p2), _ae_names, atol=1e-6)


def test_ae_trajectory_matches_jax():
    """20 float32 AdamW steps: every loss within 2e-2 relative."""
    jc, tc = _ae("float32")
    p = jnn.init_params(jc, jax.random.PRNGKey(2))
    model = tnn.params_from_jax(tc, _np_tree(p), device="cpu")
    opt_t, opt_j = tnn.make_optimizer(tc, model), jnn.make_optimizer(jc).init(p)
    x = _ae_data(seed=2)
    ref, got = [], []
    for _ in range(20):
        p, opt_j, loss = jnn.train_step(jc, p, opt_j, jnp.asarray(x))
        ref.append(float(loss))
        model, opt_t, loss = tnn.train_step(tc, model, opt_t,
                                            torch.from_numpy(x))
        got.append(float(loss))
    np.testing.assert_allclose(got, ref, rtol=2e-2)
    assert got[-1] < got[0]


def test_ae_mesh_entries_raise():
    """The tensor-parallel entries, once refused, now run:
    tp_param_specs shards what the JAX package's PartitionSpecs shard (its
    [in, out] w's model axis at nn.Linear's other dimension), and
    shard_params_tp on a one-rank mesh gives the module's forward."""
    from libllsm2_tpu.parallel import mesh as jmesh
    from libllsm2_tpu_torch.parallel import mesh as tmesh

    jc, tc = _ae("float32")
    specs = tnn.tp_param_specs(tc)
    for name, spec in jnn.tp_param_specs(jc).items():
        t = specs[name.replace("_res", "_res.")]
        w_dim = list(spec["w"]).index(jmesh.MODEL_AXIS)
        assert t["weight"] == (1 - w_dim, tmesh.MODEL_AXIS)
        assert t["bias"] == (None if spec["b"] == jax.sharding.PartitionSpec()
                             else (0, tmesh.MODEL_AXIS))
    model = tnn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    tp = tnn.shard_params_tp(tc, model, tmesh.make_tp_mesh(1, 1, "cpu"))
    x = torch.tensor(np.random.default_rng(0).standard_normal((8, DIMS)),
                     dtype=torch.float32)
    with torch.no_grad():
        np.testing.assert_allclose(tnn.forward(tc, tp, x).numpy(),
                                   tnn.forward(tc, model, x).numpy(),
                                   rtol=1e-6, atol=1e-6)


# --- the VQ codec ----------------------------------------------------------

def _vq(dtype):
    jd, td = DTYPES[dtype]
    kw = dict(dims=DIMS, hidden=32, latent=8, depth=1, groups=4,
              codebook=16, lr=2e-3)
    return jvq.VQConfig(**kw, compute_dtype=jd), \
        tvq.VQConfig(**kw, compute_dtype=td)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_vq_forward_and_tokens_match_jax(dtype):
    """Tokens: >= 99% equal (a latent within rounding of two codes' tie
    may pick either; bfloat16 operands move the latent by more).  The
    reconstruction and both auxiliary losses: within 1e-5 of scale in
    float32; in bfloat16 the frames whose tokens agree within 2e-2."""
    jc, tc = _vq(dtype)
    p = _np_tree(jvq.init_params(jc, jax.random.PRNGKey(0)))
    model = tvq.params_from_jax(tc, p, device="cpu")
    x = _ae_data(n=400, seed=3)
    jt = np.asarray(jvq.encode_tokens(jc, p, jnp.asarray(x)))
    tt = tvq.encode_tokens(tc, model, torch.from_numpy(x)).numpy()
    assert tt.dtype == np.int32 and tt.shape == (400, 4)
    assert (jt == tt).mean() >= 0.99, (jt == tt).mean()
    same = (jt == tt).all(axis=-1)
    recon, commit, codebk = jvq.forward(jc, p, jnp.asarray(x))
    r, c, b = (t.detach().numpy() for t in
               tvq.forward(tc, model, torch.from_numpy(x)))
    tol = 1e-5 if dtype == "float32" else 2e-2
    ref = np.asarray(recon)
    np.testing.assert_allclose(r[same], ref[same],
                               atol=tol * np.abs(ref).max())
    if dtype == "float32" and same.all():
        np.testing.assert_allclose([c, b], [commit, codebk], rtol=1e-5)
    back_j = np.asarray(jvq.decode_tokens(jc, p, jnp.asarray(jt)))
    back_t = tvq.decode_tokens(tc, model, torch.tensor(jt)).numpy()
    np.testing.assert_allclose(back_t, back_j,
                               atol=tol * np.abs(back_j).max())


def test_vq_train_step_and_trajectory_match_jax():
    """float32: one step's reconstruction loss within 1e-6 relative and
    every parameter (codebook included: AdamW decays it too) within
    1e-6; then 20 steps' losses within 2e-2 relative."""
    jc, tc = _vq("float32")
    p = jvq.init_params(jc, jax.random.PRNGKey(4))
    model = tvq.params_from_jax(tc, _np_tree(p), device="cpu")
    opt_t, opt_j = tvq.make_optimizer(tc, model), jvq.make_optimizer(jc).init(p)
    x = _ae_data(n=128, seed=4)
    ref, got = [], []
    for i in range(20):
        p, opt_j, rec = jvq.train_step(jc, p, opt_j, jnp.asarray(x))
        ref.append(float(rec))
        model, opt_t, rec = tvq.train_step(tc, model, opt_t,
                                           torch.from_numpy(x))
        got.append(float(rec))
        if i == 0:
            np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
            jp = _np_tree(p)
            _params_close(model, jp, lambda q: _ae_names(q["ae"], "ae."),
                         atol=1e-6)
            np.testing.assert_allclose(model.codebook.detach().numpy(),
                                       jp["codebook"], atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=2e-2)


# --- the acoustic model ----------------------------------------------------

def _acoustic(dtype):
    jd, td = DTYPES[dtype]
    kw = dict(dims=DIMS, n_phones=8, embed=8, hidden=16, dilations=(1, 2),
              lr=3e-3)
    return jac.AcousticConfig(**kw, compute_dtype=jd), \
        tac.AcousticConfig(**kw, compute_dtype=td)


def _ac_batch(seed=0, B=4, N=40):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 8, (B, N)).astype(np.int32)
    feats = rng.uniform(0, 1, (B, N, 2)).astype(np.float32)
    tgt = rng.standard_normal((B, N, DIMS)).astype(np.float32)
    mask = (np.arange(N)[None, :] < rng.integers(N // 2, N + 1, B)[:, None]
            ).astype(np.float32)
    return ids, feats, tgt, mask


def _j(batch):
    return tuple(jnp.asarray(a) for a in batch)


def _t(batch):
    return tuple(torch.from_numpy(a) for a in batch)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_acoustic_forward_matches_jax(dtype):
    """Tolerances as the autoencoder's: 1e-5 / 2e-2 of the scale."""
    jc, tc = _acoustic(dtype)
    p = _np_tree(jac.init_params(jc, jax.random.PRNGKey(0)))
    ids, feats, _, _ = _ac_batch()
    ref = np.asarray(jac.forward(jc, p, jnp.asarray(ids), jnp.asarray(feats)))
    got = tac.forward(tc, tac.params_from_jax(tc, p, device="cpu"),
                      torch.from_numpy(ids), torch.from_numpy(feats))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.detach().numpy(), ref,
                               atol=tol * np.abs(ref).max())


def test_acoustic_tap_order():
    """One tap at a time (the others zeroed, biases nonzero): JAX tap 0
    reads h[i + d], tap 2 h[i - d]; Conv1d reads x[i + (k - 1) d] at
    kernel index k, so params_from_jax puts tap t at 2 - t.  The port
    equals JAX within 1e-5 of scale for each tap, and loading the taps
    unreversed does not (the case has teeth)."""
    jc, tc = _acoustic("float32")
    p0 = _np_tree(jac.init_params(jc, jax.random.PRNGKey(5)))
    ids, feats, _, _ = _ac_batch(seed=5)
    for t in (0, 2):
        p = jax.tree.map(np.copy, p0)
        for i in range(len(jc.dilations)):
            w = p[f"conv{i}"]["w"]
            w[[u for u in range(3) if u != t]] = 0.0
            p[f"conv{i}"]["b"] = np.full_like(p[f"conv{i}"]["b"], 0.1)
        ref = np.asarray(jac.forward(jc, p, jnp.asarray(ids),
                                     jnp.asarray(feats)))
        model = tac.params_from_jax(tc, p, device="cpu")
        got = tac.forward(tc, model, torch.from_numpy(ids),
                          torch.from_numpy(feats)).detach().numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
        with torch.no_grad():
            for conv in model.convs:
                conv.weight.copy_(conv.weight.flip(-1))
        wrong = tac.forward(tc, model, torch.from_numpy(ids),
                            torch.from_numpy(feats)).detach().numpy()
        assert np.abs(wrong - ref).max() > 1e-2 * np.abs(ref).max()


def test_acoustic_train_step_and_trajectory_match_jax():
    """float32 with an F0-slot weight of 4 and a mask: one step's loss
    within 1e-6 relative and every parameter within 1e-6; 20 steps'
    losses within 2e-2 relative."""
    jc, tc = _acoustic("float32")
    p = jac.init_params(jc, jax.random.PRNGKey(6))
    model = tac.params_from_jax(tc, _np_tree(p), device="cpu")
    opt_t, opt_j = tac.make_optimizer(tc, model), jac.make_optimizer(jc).init(p)
    batch = _ac_batch(seed=6)
    w = np.ones(DIMS, np.float32)
    w[0] = 4.0
    ref, got = [], []
    for i in range(20):
        p, opt_j, loss = jac.train_step(jc, p, opt_j, _j(batch),
                                        jnp.asarray(w))
        ref.append(float(loss))
        model, opt_t, loss = tac.train_step(tc, model, opt_t, _t(batch),
                                            torch.from_numpy(w))
        got.append(float(loss))
        if i == 0:
            np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
            _params_close(model, _np_tree(p), _ac_names, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=2e-2)


def test_predict_vectors_matches_jax():
    """Denormalized predictions (bfloat16 default) within 2e-2 of the
    scale, the unvoiced snap applied alike."""
    jc, tc = _acoustic("bfloat16")
    p = _np_tree(jac.init_params(jc, jax.random.PRNGKey(7)))
    ids, feats, tgt, _ = _ac_batch(seed=7)
    norm = jnn.Normalizer(tgt.reshape(-1, DIMS) * 50.0 + 100.0)
    tnorm = tnn.Normalizer(tgt.reshape(-1, DIMS) * 50.0 + 100.0)
    ref = jac.predict_vectors(jc, p, jnp.asarray(ids), jnp.asarray(feats),
                              norm, unvoiced_below=100.0)
    got = tac.predict_vectors(tc, tac.params_from_jax(tc, p, device="cpu"),
                              ids, feats, tnorm, unvoiced_below=100.0)
    assert got.dtype == np.float32
    assert ((got[..., 0] == 0) == (ref[..., 0] == 0)).mean() > 0.97
    both = (got[..., 0] > 0) & (ref[..., 0] > 0)
    np.testing.assert_allclose(got[both], ref[both],
                               atol=2e-2 * np.abs(ref).max())


# --- analysis by synthesis -------------------------------------------------

def _carry(jchunk):
    conf = tpkg.ChunkConf(**dataclasses.asdict(jchunk.conf))
    return chunk_from_numpy(
        {f: np.asarray(getattr(jchunk, f)) for f in
         ("f0", "ampl", "phse", "hm_mask", "psd", "edc", "eenv_a",
          "eenv_p")}, conf, device="cpu")


def test_abs_refine_matches_jax_weak_analysis():
    """test_abs's weakened analysis (JAX, carried across), refined 100
    steps at lr 0.1: every loss within 1e-3 relative of JAX's (measured
    7e-5), the refined amplitudes within 1e-3 of their peak."""
    x, f0, _ = jts.synth_hard_utterance(
        duration=0.6, register="female", seed=3, jitter=0.01, shimmer=0.1,
        noise_level=0.0, burst=False, unvoiced_tail_frac=0.0)
    opt = dataclasses.replace(jpkg.create_aoptions(), hm_passes=1,
                              hm_correction="none")
    jchunk = jl0.analyze(opt, x, f0)
    jref, jl = jabs.abs_refine(jpkg.create_soptions(), jchunk, x,
                               n_steps=100, lr=0.1)
    ref, losses = tabs.abs_refine(tpkg.create_soptions(), _carry(jchunk), x,
                                  n_steps=100, lr=0.1)
    jl = np.asarray(jl)
    assert losses.shape == (100,)
    np.testing.assert_allclose(losses.numpy(), jl, rtol=1e-3)
    a = np.asarray(jref.ampl)
    np.testing.assert_allclose(ref.ampl.numpy(), a, atol=1e-3 * a.max())


def test_abs_refine_matches_jax_noop():
    """test_abs's no-op fixture (the chunk's own resynthesis as target,
    20 steps at lr 0.01).  Its gradient starts at rounding noise, which
    Adam normalizes to lr-sized steps whose signs are the noise's, so the
    traces agree in level, not value: every loss of both packages within
    1e-4 of the target's power (-40 dB)."""
    x, f0 = jts.make_test_utterance(duration=0.4, seed=2)
    jchunk = jl0.analyze(jpkg.create_aoptions(), x, f0)
    y = np.asarray(jl0.synthesize(jpkg.create_soptions(), jchunk).y_sin)
    _, jl = jabs.abs_refine(jpkg.create_soptions(), jchunk, y, n_steps=20,
                            lr=0.01)
    _, losses = tabs.abs_refine(tpkg.create_soptions(), _carry(jchunk),
                                torch.tensor(y), n_steps=20, lr=0.01)
    power = float(np.mean(y ** 2))
    assert np.abs(losses.numpy() - np.asarray(jl)).max() < 1e-4 * power
    assert losses.numpy().max() < 1e-4 * power


# --- the TTS corpus --------------------------------------------------------

@pytest.fixture(scope="module")
def jax_corpus():
    return jtts.build_corpus(2, seed=0)


def test_build_corpus_on_carried_analysis_matches_jax(jax_corpus,
                                                      monkeypatch):
    """The port's build_corpus(2) on the JAX package's audio and layer-0
    analysis carried across, so that only its own chunk_to_layer1 and
    coder.encode run: every target slot within the coder tolerance of
    tests/test_torch_coder.py, 1e-4, absolute and relative (vtmagn, a log
    envelope over the layer-1 fit's rd, measured 1.4e-4 absolute at
    -8.2, 7.9e-5 relative; every other slot <= 4e-5 absolute)."""
    from libllsm2_tpu_torch.container import CHUNK_FIELDS
    from libllsm2_tpu_torch.models import layer0 as tl0

    def carried(opt, x, f0, device):
        jc = jl0.analyze(jpkg.create_aoptions(), x, f0)
        return chunk_from_numpy(
            {k: np.asarray(getattr(jc, k)) for k in CHUNK_FIELDS
             if getattr(jc, k) is not None}, tpkg.ChunkConf(), device=device)
    monkeypatch.setattr(tl0, "analyze", carried)
    monkeypatch.setattr(ttts, "synth_phone_utterance",
                        jtts.synth_phone_utterance)
    jc = jax_corpus
    tc = ttts.build_corpus(2, seed=0, device="cpu")
    for k in ("ids", "feats", "mask", "f0"):
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    m = jc["mask"] > 0
    for name, off, size in tc["cc"].layout():
        np.testing.assert_allclose(tc["targets"][..., off:off + size][m],
                                   jc["targets"][..., off:off + size][m],
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_build_corpus_matches_jax(jax_corpus):
    """build_corpus(2) through each package's own analysis on the CPU, a
    looser second check beside the carried-analysis case above (the two
    analyses of the same audio differ where the layer-1 fit is flat).
    ids, feats, mask and f0 exact.  The targets by slot: f0, edc and
    eenv_a within the coder tolerance of tests/test_torch_coder.py (1e-4
    absolute); rd within 0.02 (the layer-1 fit's score is nearly flat:
    measured 0.012); vtmagn and the log PSD, which take logs of small
    magnitudes, linear (exp of the slot) within 3e-2 and 5e-3 of each
    frame's peak (measured 1.5e-2 and 1.8e-3)."""
    jc = jax_corpus
    tc = ttts.build_corpus(2, seed=0, device="cpu")
    for k in ("ids", "feats", "mask", "f0"):
        np.testing.assert_array_equal(tc[k], jc[k], err_msg=k)
    m = jc["mask"] > 0
    tols = {"f0": 1e-4, "edc": 1e-4, "eenv_a": 1e-4, "rd": 0.02}
    lin = {"vtmagn": 3e-2, "psd": 5e-3}
    for name, off, size in tc["cc"].layout():
        a = jc["targets"][..., off:off + size][m]
        b = tc["targets"][..., off:off + size][m]
        if name in lin:
            a, b = np.exp(a.astype(np.float64)), np.exp(b.astype(np.float64))
            err = np.abs(a - b) / a.max(axis=-1, keepdims=True)
            assert err.max() < lin[name], (name, err.max())
        else:
            np.testing.assert_allclose(b, a, atol=tols[name], err_msg=name)


def test_synth_phone_utterance_matches_jax():
    """The rendered audio within 1e-6 of its peak (the LF source is
    float32 in both packages, its exp / sin from different libraries)."""
    seq, durs = [1, 6, 2, 7, 0], [30, 20, 30, 20, 20]
    jx, jf0, jids, jpos = jtts.synth_phone_utterance(seq, durs, seed=4)
    tx, tf0, tids, tpos = ttts.synth_phone_utterance(seq, durs, seed=4)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tf0, jf0)
    np.testing.assert_allclose(tx, jx, atol=1e-6)
    assert ttts.N_PHONES == jtts.N_PHONES
    assert [p.name for p in ttts.PHONE_SET] == [p.name for p in jtts.PHONE_SET]


def test_learned_pins_reproduce_on_the_cpu():
    """chip_smoke.py phase 17d's check on the CPU: the JAX package's
    default-width AE, VQ and acoustic model (scripts/port_jax_pins_learned
    .npz, written by scripts/port_jax_pins.py only=learned) through
    params_from_jax: forwards within 2e-2 of scale, >= 99% of the tokens
    equal, 5 AdamW steps' losses within 2e-2 relative of JAX's."""
    import chip_smoke
    ok, detail = chip_smoke.jax_weights_check(torch, "cpu")
    assert ok, detail


@pytest.mark.parametrize("fn", [tnn.init_params, tvq.init_params,
                                tac.init_params, ttts.build_corpus],
                         ids=["neural", "vq", "acoustic", "ttsdata"])
def test_entry_points_default_to_the_card(fn):
    import inspect
    assert inspect.signature(fn).parameters["device"].default == "cuda"
