"""The JAX suite's quality floors for the learned models on the PyTorch
port, on the CPU, with the port's own seeded initialization
(torch.Generator): tests/test_abs.py's two cases, test_neural.py's
training and round-trip cases, test_acoustic.py's four single-device
cases and test_vq.py's four cases, each at its own sizes and floors.  The
inits differ from the JAX package's, so these are floors, not parity
(parity on carried weights: tests/test_torch_learned.py).  The sharded
cases (test_neural's two, test_acoustic's dp step) belong to the
multi-device slice."""
import dataclasses

import numpy as np
import pytest
import torch

from libllsm2_tpu_torch import create_aoptions, create_soptions
from libllsm2_tpu_torch.models import abs as absmod
from libllsm2_tpu_torch.models import acoustic, coder, layer0, layer1
from libllsm2_tpu_torch.models import neural, vq
from libllsm2_tpu_torch.runtime import rtsynth
from libllsm2_tpu_torch.utils import metrics, testsig, ttsdata

torch.set_num_threads(1)
CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def snr_db(ref, est):
    ref, est = np.asarray(ref), np.asarray(est)
    n = min(len(ref), len(est))
    lo, hi = int(0.05 * n), int(0.95 * n)
    e = ref[lo:hi] - est[lo:hi]
    return 10 * np.log10(np.sum(ref[lo:hi] ** 2) / max(np.sum(e ** 2), 1e-20))


# --- tests/test_abs.py -----------------------------------------------------

def test_abs_refine_recovers_crippled_analysis():
    x, f0, xh = testsig.synth_hard_utterance(
        duration=0.6, register="female", seed=3, jitter=0.01, shimmer=0.1,
        noise_level=0.0, burst=False, unvoiced_tail_frac=0.0)
    opt_weak = dataclasses.replace(create_aoptions(), hm_passes=1,
                                   hm_correction="none")
    sopt = create_soptions()
    chunk = layer0.analyze(opt_weak, x, f0, device=CPU)
    snr_before = snr_db(xh, layer0.synthesize(sopt, chunk).y_sin)
    refined, losses = absmod.abs_refine(sopt, chunk, x, n_steps=100, lr=0.1)
    snr_after = snr_db(xh, layer0.synthesize(sopt, refined).y_sin)
    losses = losses.numpy()
    assert losses[-1] < 0.95 * losses[0], (losses[0], losses[-1])
    assert snr_after > snr_before + 6.0, (snr_before, snr_after)
    m = chunk.hm_mask
    assert float((refined.ampl * (1 - m)).abs().max()) == 0.0


def test_abs_refine_noop_on_perfect_chunk():
    x, f0 = testsig.make_test_utterance(duration=0.4, seed=2)
    sopt = create_soptions()
    chunk = layer0.analyze(create_aoptions(), x, f0, device=CPU)
    y_own = layer0.synthesize(sopt, chunk).y_sin
    refined, _ = absmod.abs_refine(sopt, chunk, y_own, n_steps=20, lr=0.01)
    assert snr_db(y_own, layer0.synthesize(sopt, refined).y_sin) > 35.0


# --- tests/test_neural.py --------------------------------------------------

def _coder_dataset(n_utts):
    opt = create_aoptions()
    cc = coder.CoderConfig(conf=opt.conf)
    vecs = []
    for i in range(n_utts):
        x, f0 = testsig.make_test_utterance(duration=0.3, seed=i,
                                            noise_level=0.05)
        l1 = layer1.chunk_to_layer1(layer0.analyze(opt, x, f0, device=CPU))
        vecs.append(coder.encode(cc, l1).numpy())
    return np.concatenate(vecs, axis=0), cc


@pytest.fixture(scope="module")
def coder_data():
    return _coder_dataset(6)


def test_training_reduces_loss(coder_data):
    data, cc = coder_data
    data = data[:len(data) * 4 // 6]                 # test_neural's 4
    norm = neural.Normalizer(data)
    data_n = torch.tensor(norm.fwd(data), dtype=torch.float32)
    cfg = neural.AEConfig(dims=cc.dims, hidden=64, latent=16, depth=1,
                          lr=3e-3)
    params = neural.init_params(cfg, _gen(0), device=CPU)
    opt_state = neural.make_optimizer(cfg, params)
    losses = []
    for _ in range(60):
        params, opt_state, loss = neural.train_step(cfg, params, opt_state,
                                                    data_n)
        losses.append(float(loss))
    assert losses[-1] < 0.3 * losses[0], (losses[0], losses[-1])


def test_roundtrip_through_model_synthesizes(coder_data):
    data, cc = coder_data
    data = data[:len(data) * 2 // 6]                 # test_neural's 2
    norm = neural.Normalizer(data)
    cfg = neural.AEConfig(dims=cc.dims, hidden=64, latent=24, depth=1,
                          lr=3e-3)
    params = neural.init_params(cfg, _gen(2), device=CPU)
    opt_state = neural.make_optimizer(cfg, params)
    d = torch.tensor(norm.fwd(data), dtype=torch.float32)
    for _ in range(100):
        params, opt_state, _ = neural.train_step(cfg, params, opt_state, d)
    recon = norm.inv(neural.forward(cfg, params, d).detach().numpy())
    f0_in, f0_out = data[:, 0], recon[:, 0]
    voiced = f0_in > 0
    err = np.abs(f0_out[voiced] - f0_in[voiced]) / f0_in[voiced]
    assert np.median(err) < 0.15, np.median(err)
    chunk = coder.decode(cc, recon[:40].astype(np.float32), device=CPU)
    out = layer0.synthesize(create_soptions(), chunk)
    assert bool(torch.isfinite(out.y).all())


# --- tests/test_vq.py ------------------------------------------------------

@pytest.fixture(scope="module")
def trained_vq(coder_data):
    data, cc = coder_data
    norm = neural.Normalizer(data)
    dn = torch.tensor(norm.fwd(data), dtype=torch.float32)
    cfg = vq.VQConfig(dims=cc.dims, hidden=96, latent=16, depth=1,
                      groups=4, codebook=64, lr=2e-3)
    params = vq.init_params(cfg, _gen(0), device=CPU)
    opt_state = vq.make_optimizer(cfg, params)
    recs = []
    for _ in range(220):
        params, opt_state, rec = vq.train_step(cfg, params, opt_state, dn)
        recs.append(float(rec))
    return cc, norm, cfg, params, dn, recs


def test_vq_training_reduces_recon(trained_vq):
    recs = trained_vq[-1]
    assert recs[-1] < 0.4 * recs[0], (recs[0], recs[-1])


def test_vq_codebooks_used(trained_vq):
    _, _, cfg, params, dn, _ = trained_vq
    idx = vq.encode_tokens(cfg, params, dn).numpy()
    assert idx.shape == (dn.shape[0], cfg.groups)
    for g in range(cfg.groups):
        used = len(np.unique(idx[:, g]))
        assert used >= 8, (g, used)


def test_vq_token_roundtrip_renders(trained_vq):
    cc, norm, cfg, params, dn, _ = trained_vq
    tokens = vq.encode_tokens(cfg, params, dn)
    assert cfg.bits_per_frame == 24
    back = norm.inv(vq.decode_tokens(cfg, params, tokens).numpy())
    orig = norm.inv(dn.numpy())
    voiced = orig[:, 0] > 0
    f0_back = back[:, 0]
    agree = ((f0_back > 50.0) == voiced).mean()
    assert agree > 0.9, agree
    m = voiced & (f0_back > 50.0)
    rel = np.abs(f0_back[m] - orig[m, 0]) / orig[m, 0]
    assert np.median(rel) < 0.05, np.median(rel)
    chunk = coder.decode(cc, back.astype(np.float32), device=CPU)
    a = chunk.ampl
    assert bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0.0


def test_vq_token_render_mcd_floor(trained_vq):
    cc, norm, cfg, params, dn, _ = trained_vq
    sopt = create_soptions()
    orig = norm.inv(dn.numpy())
    n = orig.shape[0] // 6
    v = orig[:n].astype(np.float32)
    tokens = vq.encode_tokens(cfg, params, torch.tensor(
        norm.fwd(v), dtype=torch.float32))
    back = norm.inv(vq.decode_tokens(cfg, params, tokens).numpy())
    y_ref = layer0.synthesize(sopt, coder.decode(cc, v, device=CPU)).y_sin
    y_vq = layer0.synthesize(sopt, coder.decode(
        cc, back.astype(np.float32), device=CPU)).y_sin
    mcd = metrics.mel_cepstral_distortion_db(y_ref.numpy(), y_vq.numpy(),
                                             fs=cc.conf.fs)
    assert mcd < 2.5, mcd


# --- tests/test_acoustic.py ------------------------------------------------

def _slot(cc, name):
    for n, off, size in cc.layout():
        if n == name:
            return slice(off, off + size)
    raise KeyError(name)


@pytest.fixture(scope="module")
def trained():
    corp = ttsdata.build_corpus(8, seed=0, total_frames=192, n_seg=(5, 8),
                                dur=(16, 34), device=CPU)
    cc = corp["cc"]
    norm = neural.Normalizer(corp["targets"].reshape(
        -1, corp["targets"].shape[-1]))
    tgt_n = torch.tensor(norm.fwd(corp["targets"]), dtype=torch.float32)
    cfg = acoustic.AcousticConfig(dims=cc.dims, n_phones=ttsdata.N_PHONES,
                                  embed=24, hidden=48, dilations=(1, 2, 4),
                                  lr=3e-3)
    params = acoustic.init_params(cfg, _gen(0), device=CPU)
    opt_state = acoustic.make_optimizer(cfg, params)
    batch = (torch.tensor(corp["ids"]), torch.tensor(corp["feats"]), tgt_n,
             torch.tensor(corp["mask"]))
    w = torch.ones(cc.dims)
    w[_slot(cc, "f0")] = 4.0
    losses = []
    for _ in range(240):
        params, opt_state, loss = acoustic.train_step(cfg, params, opt_state,
                                                      batch, w)
        losses.append(float(loss))
    return corp, cc, norm, cfg, params, losses


def test_acoustic_training_reduces_loss(trained):
    losses = trained[-1]
    assert losses[-1] < 0.2 * losses[0], (losses[0], losses[-1])


def test_f0_contour_recovered(trained):
    corp, cc, norm, cfg, params, _ = trained
    held = ttsdata.build_corpus(2, seed=99, total_frames=192, n_seg=(5, 8),
                                dur=(16, 34), device=CPU)
    pred = acoustic.predict_vectors(cfg, params, held["ids"], held["feats"],
                                    norm)
    f0_pred = pred[..., _slot(cc, "f0")][..., 0]
    f0_true = held["f0"]
    v = f0_true > 0
    assert v.sum() > 50
    err = np.abs(f0_pred[v] - f0_true[v]) / f0_true[v]
    assert np.median(err) < 0.05, np.median(err)
    c = np.corrcoef(f0_pred[v], f0_true[v])[0, 1]
    assert c > 0.85, c


def test_phone_identity_in_vt_slots(trained):
    corp, cc, norm, cfg, params, _ = trained
    sl = _slot(cc, "vtmagn")

    def feat(v):
        x = v[..., sl]
        return x - x.mean(axis=-1, keepdims=True)
    vowels = [i for i, ph in enumerate(ttsdata.PHONE_SET)
              if ph.kind == "vowel"]
    cents = {}
    ids_t, pos_t = corp["ids"], corp["feats"][..., 0]
    mid_t = (pos_t > 0.3) & (pos_t < 0.7)
    for pid in vowels:
        m = (ids_t == pid) & mid_t
        if m.sum():
            cents[pid] = feat(corp["targets"][m]).mean(axis=0)
    held = ttsdata.build_corpus(2, seed=123, total_frames=192, device=CPU)
    pred = acoustic.predict_vectors(cfg, params, held["ids"], held["feats"],
                                    norm)
    mid = (held["feats"][..., 0] > 0.3) & (held["feats"][..., 0] < 0.7)
    hits = tot = 0
    for pid in vowels:
        m = (held["ids"] == pid) & mid
        for vec in feat(pred[m]):
            d = {q: np.linalg.norm(vec - c) for q, c in cents.items()}
            hits += min(d, key=d.get) == pid
            tot += 1
    assert tot > 30
    assert hits / tot > 0.75, (hits, tot)


def test_tts_serving_render(trained):
    from scipy import signal as sps

    corp, cc, norm, cfg, params, _ = trained
    fs, nhop = cc.conf.fs, cc.conf.nhop
    seq, durs = [1, 6, 2, 0], [56, 40, 56, 40]       # aa  s  iy  sil
    N = sum(durs)
    ids = np.zeros((1, N), np.int32)
    feats = np.zeros((1, N, 2), np.float32)
    a = 0
    for pi, d in zip(seq, durs):
        ids[0, a:a + d] = pi
        feats[0, a:a + d, 0] = (np.arange(d) + 0.5) / d
        a += d
    feats[0, :, 1] = np.arange(N) / (N - 1)
    pred = acoustic.predict_vectors(cfg, params, ids, feats, norm,
                                    unvoiced_below=cc.conf.f0_floor)[0]
    rt = rtsynth.RTSynthesizer(create_soptions(), cc.conf,
                               capacity_frames=N + 8, phase_mode="propagate",
                               device=CPU)
    out = []
    for s in range(0, N, 16):
        rt.feed_many(coder.decode_frames(cc, pred[s:s + 16], device=CPU))
        out.append(rt.fetch(rt.readable()))
    rt.flush()
    out.append(rt.fetch(rt.readable()))
    y = np.concatenate(out)
    assert np.isfinite(y).all()
    mid = slice(20 * nhop, 48 * nhop)
    f0m = float(np.median(pred[20:48, 0]))
    assert f0m > 80.0, f0m
    seg = y[mid] - y[mid].mean()
    lag = int(round(fs / f0m))
    r = np.correlate(seg, seg, "full")[len(seg) - 1:]
    assert r[lag - 2:lag + 3].max() / max(r[0], 1e-12) > 0.4
    fr = slice((56 + 8) * nhop, (56 + 36) * nhop)
    f, P = sps.welch(y[fr], fs=fs, nperseg=512)
    cent = float((f * P).sum() / max(P.sum(), 1e-12))
    assert cent > 2500.0, cent
    sil = y[(N - 24) * nhop:(N - 4) * nhop]
    assert np.std(sil) < 0.1 * np.std(y[mid]) + 1e-9
