"""End-to-end TTS demo on the PyTorch port (counterpart of
scripts/train_tts_demo.py): train the phoneme-conditioned acoustic model
on the synthetic parallel corpus (libllsm2_tpu_torch.utils.ttsdata), then
render an UNSEEN sentence through the streaming serving path
(coder.decode_frames -> RTSynthesizer phase_mode="propagate") and write
it to examples/out/tts_demo_torch.wav.

  python scripts/port_train_tts_demo.py [utts=24] [steps=400] [hidden=64]

Runs on the card; LLSM_PLATFORM=cpu runs it on the CPU.  Prints one JSON
line with the training metrics.
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(utts=24, steps=400, hidden=64):
    import torch

    from libllsm2_tpu_torch import create_soptions
    from libllsm2_tpu_torch.models import acoustic, coder, neural
    from libllsm2_tpu_torch.runtime import rtsynth
    from libllsm2_tpu_torch.utils import audio, ttsdata

    dev = os.environ.get("LLSM_PLATFORM") or "cuda"
    t0 = time.time()
    corp = ttsdata.build_corpus(int(utts), seed=0, device=dev)
    cc = corp["cc"]
    t_data = time.time() - t0

    norm = neural.Normalizer(
        corp["targets"].reshape(-1, corp["targets"].shape[-1]))
    cfg = acoustic.AcousticConfig(dims=cc.dims, n_phones=ttsdata.N_PHONES,
                                  hidden=int(hidden))
    params = acoustic.init_params(cfg, torch.Generator().manual_seed(0),
                                  device=dev)
    opt_state = acoustic.make_optimizer(cfg, params)
    batch = tuple(torch.tensor(a, device=dev) for a in (
        corp["ids"], corp["feats"],
        norm.fwd(corp["targets"]).astype(np.float32), corp["mask"]))
    w = torch.ones(cc.dims, device=dev)
    w[0] = 4.0                                    # F0 slot

    t0 = time.time()
    first = None
    for step in range(int(steps)):
        params, opt_state, loss = acoustic.train_step(
            cfg, params, opt_state, batch, w)
        if step == 0:
            first = float(loss)
    last = float(loss)
    t_train = time.time() - t0

    # unseen sentence: "aa s iy sh ao sil"
    seq, durs = [1, 6, 2, 7, 5, 0], [50, 36, 50, 36, 56, 30]
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
                               capacity_frames=N + 8,
                               phase_mode="propagate", device=dev)
    out = []
    for s in range(0, N, 16):
        rt.feed_many(coder.decode_frames(cc, pred[s:s + 16], device=dev))
        out.append(rt.fetch(rt.readable()))
    rt.flush()
    out.append(rt.fetch(rt.readable()))
    y = np.concatenate(out)

    outdir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "out")
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "tts_demo_torch.wav")
    audio.wavwrite(path, y, cc.conf.fs)

    print(json.dumps({
        "device": dev, "utts": int(utts), "steps": int(steps),
        "dims": cc.dims, "loss_first": round(first, 4),
        "loss_last": round(last, 5), "data_s": round(t_data, 1),
        "train_s": round(t_train, 1), "wav": path,
        "samples": int(y.shape[0]),
    }))


if __name__ == "__main__":
    kw = {}
    for arg in sys.argv[1:]:
        k, v = arg.split("=")
        kw[k] = int(v)
    main(**kw)
