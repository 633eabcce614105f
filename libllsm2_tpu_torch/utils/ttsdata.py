"""Synthetic phonetic parallel corpus for the acoustic-model workload
(counterpart of libllsm2_tpu.utils.ttsdata: the same phones, sentences and
renders; the LF source through the port's ops/lf.py, the analysis through
the port's layer0 -> layer1 -> coder on `device`).

The reference's coder exists so ML models can regress LLSM frames
(reference: coder.c; SURVEY.md 3.5) but ships neither a model nor data.
This module provides the data half of that loop without any external
audio (the environment has none; SURVEY.md 4 "fixtures"): a small phone
inventory rendered from first principles -- LF glottal source with a
continuous phase track through formant filters for vowels, band-shaped
noise for fricatives -- so a frame-level acoustic model has a learnable,
fully-known mapping (phone identity + position -> coder vector) and its
predictions can be validated against ground truth (F0 contour, formant
structure, voicing) rather than by eyeball.

Host-side numpy/scipy by design, like utils.testsig: corpus rendering is
data *preparation*; the device parts are the analysis pipeline that turns
audio into coder targets and the model that trains on them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Phone:
    name: str
    kind: str                                  # "silence" | "vowel" | "fricative"
    formants: Tuple[Tuple[float, float], ...] = ()   # vowels: (fc, bw) Hz
    band: Tuple[float, float] = (0.0, 0.0)     # fricatives: passband Hz
    gain: float = 1.0                          # level relative to vowel rms


# Formant targets are textbook adult values (Peterson-Barney style);
# the exact numbers only need to be distinct and inside fnyq.
PHONE_SET: Tuple[Phone, ...] = (
    Phone("sil", "silence"),
    Phone("aa", "vowel", ((730.0, 90.0), (1090.0, 110.0), (2440.0, 120.0))),
    Phone("iy", "vowel", ((270.0, 60.0), (2290.0, 100.0), (3010.0, 150.0))),
    Phone("uw", "vowel", ((300.0, 65.0), (870.0, 90.0), (2240.0, 120.0))),
    Phone("eh", "vowel", ((530.0, 70.0), (1840.0, 100.0), (2480.0, 120.0))),
    Phone("ao", "vowel", ((570.0, 80.0), (840.0, 100.0), (2410.0, 130.0))),
    Phone("s", "fricative", band=(3500.0, 7000.0), gain=0.30),
    Phone("sh", "fricative", band=(1500.0, 4000.0), gain=0.35),
)
N_PHONES = len(PHONE_SET)


def synth_phone_utterance(phone_idx: Sequence[int],
                          durs_frames: Sequence[int],
                          fs: float = 16000.0, thop: float = 0.005,
                          rd: float = 1.0,
                          f0_hi: float = 175.0, f0_lo: float = 115.0,
                          seed: int = 0):
    """Render a phone sequence; returns (x, f0_frames, ids, pos).

    x [nx] float64; f0_frames [nfrm] (0 where unvoiced); ids [nfrm] int32
    phone index per frame; pos [nfrm] position-in-phone in [0, 1).

    The glottal source keeps ONE continuous phase track across the whole
    utterance (vowel-to-vowel transitions are glottal-cycle coherent);
    each vowel is that source through its own formant cascade, and
    segments are crossfaded with complementary linear ramps so the per-
    segment weights always sum to 1.
    """
    import torch
    from scipy import signal as sps

    from ..ops import lf

    phone_idx = list(phone_idx)
    durs_frames = list(durs_frames)
    assert len(phone_idx) == len(durs_frames)
    nhop = int(round(thop * fs))
    nfrm = int(sum(durs_frames))
    nx = nfrm * nhop

    ids = np.zeros(nfrm, np.int32)
    pos = np.zeros(nfrm, np.float64)
    voiced_frame = np.zeros(nfrm, bool)
    spans = []                                    # (phone, frame_a, frame_b)
    a = 0
    for pi, d in zip(phone_idx, durs_frames):
        ph = PHONE_SET[pi]
        ids[a:a + d] = pi
        pos[a:a + d] = (np.arange(d) + 0.5) / d
        voiced_frame[a:a + d] = ph.kind == "vowel"
        spans.append((ph, a, a + d))
        a += d

    # declining F0 with a gentle vibrato -- a deterministic function of
    # global position, so a model given that position can learn it
    gp = np.arange(nfrm) / max(nfrm - 1, 1)
    contour = f0_hi * (f0_lo / f0_hi) ** gp
    contour = contour * (1.0 + 0.015 * np.sin(2 * np.pi * 4.5 * gp
                                              * nfrm * thop))
    f0_frames = np.where(voiced_frame, contour, 0.0)

    # continuous LF source (phase runs through unvoiced stretches so
    # vowel onsets stay cycle-coherent)
    t = np.arange(nx) / fs
    frame_t = np.arange(nfrm) * thop
    f0_s = np.interp(t, frame_t, contour)
    voiced_s = np.interp(t, frame_t, voiced_frame.astype(np.float64)) > 0.5
    cycles = np.cumsum(f0_s) / fs
    p = lf.lf_from_rd(float(rd))
    u = lf.lf_flow_deriv(torch.from_numpy((cycles % 1.0).astype(np.float32)),
                         p).numpy().astype(np.float64)
    u = u * voiced_s

    rng = np.random.default_rng(seed)
    cache: Dict[str, np.ndarray] = {}

    def phone_signal(ph: Phone) -> np.ndarray:
        if ph.name in cache:
            return cache[ph.name]
        if ph.kind == "silence":
            sig = np.zeros(nx)
        elif ph.kind == "vowel":
            sig = u.copy()
            for fc, bw in ph.formants:
                r = np.exp(-np.pi * bw / fs)
                th = 2 * np.pi * fc / fs
                sig = sps.lfilter([1.0 - r], [1.0, -2 * r * np.cos(th),
                                              r * r], sig)
            sig = np.diff(sig, prepend=0.0)       # lip radiation
            ref = sig[voiced_s]
            sig = sig / max(np.std(ref) if ref.size else 0.0, 1e-9)
        else:                                     # fricative
            n = rng.standard_normal(nx)
            lo, hi = ph.band
            b, ba = sps.butter(4, [lo / (fs / 2), min(hi / (fs / 2), 0.99)],
                               "bandpass")
            sig = sps.lfilter(b, ba, n)
            sig = ph.gain * sig / max(np.std(sig), 1e-9)
        cache[ph.name] = sig
        return sig

    # complementary crossfades: segment k's weight is ramp(start_edge) -
    # ramp(end_edge), a linear rise centered on each internal boundary;
    # the sum over segments telescopes to exactly 1 at every sample
    xfade = nhop * 2                              # 10 ms ramps
    samp = np.arange(nx, dtype=np.float64)

    def ramp(edge: int) -> np.ndarray:            # 0 before, 1 after edge
        if edge <= 0:
            return np.ones(nx)
        if edge >= nx:
            return np.zeros(nx)
        return np.clip((samp - (edge - xfade / 2)) / xfade, 0.0, 1.0)

    x = np.zeros(nx)
    for ph, fa, fb in spans:
        w = ramp(fa * nhop) - ramp(fb * nhop)
        x += w * phone_signal(ph)
    peak = np.abs(x).max()
    if peak > 0:
        x = 0.7 * x / peak
    return x, f0_frames, ids, pos


def sample_sentence(rng: np.random.Generator,
                    n_seg: Tuple[int, int] = (5, 8),
                    dur: Tuple[int, int] = (18, 42)):
    """Random phone sequence: at least two vowels, no adjacent repeats."""
    k = int(rng.integers(n_seg[0], n_seg[1]))
    vowels = [i for i, ph in enumerate(PHONE_SET) if ph.kind == "vowel"]
    others = [i for i, ph in enumerate(PHONE_SET) if ph.kind != "vowel"]
    seq = []
    for j in range(k):
        pool = vowels if (j % 2 == 0) else vowels + others
        c = int(rng.choice(pool))
        while seq and c == seq[-1]:
            c = int(rng.choice(pool))
        seq.append(c)
    durs = [int(rng.integers(dur[0], dur[1])) for _ in seq]
    return seq, durs


def build_corpus(n_utts: int, opt=None, cc=None, seed: int = 0,
                 n_seg: Tuple[int, int] = (5, 8),
                 dur: Tuple[int, int] = (18, 42),
                 total_frames: int = 224,
                 device="cuda") -> Dict[str, np.ndarray]:
    """Render + analyze + encode a parallel corpus.

    Returns a dict of padded arrays: ids [B, N] int32, feats [B, N, 2]
    (position-in-phone, global position), targets [B, N, D] coder
    vectors, mask [B, N], f0 [B, N], plus the CoderConfig under "cc".
    Audio goes through the real pipeline (layer-0 analysis with the known
    F0 track, layer-1 conversion, coder encode) -- the corpus is the
    framework's own analysis output, exactly what a production TTS
    data-prep job would build (parallel.corpus at scale).  The analysis
    runs on `device` (the card by default; "cpu" for the CPU); the arrays
    come back as numpy.
    """
    from ..config import create_aoptions
    from ..models import coder as coder_mod
    from ..models import layer0, layer1

    opt = opt or create_aoptions()
    cc = cc or coder_mod.CoderConfig(conf=opt.conf)
    rng = np.random.default_rng(seed)

    rows = []
    for ui in range(n_utts):
        seq, durs = sample_sentence(rng, n_seg=n_seg, dur=dur)
        # fixed utterance length (trailing silence pad): one shape for
        # every analyze call
        budget = total_frames - 10
        if sum(durs) > budget:
            scale = budget / sum(durs)
            durs = [max(8, int(d * scale)) for d in durs]
            while sum(durs) > budget:
                durs[int(np.argmax(durs))] -= 1
        seq = seq + [0]                           # final sil fills the pad
        durs = durs + [total_frames - sum(durs)]
        x, f0, ids, pos = synth_phone_utterance(
            seq, durs, fs=opt.conf.fs, thop=opt.conf.thop,
            seed=int(rng.integers(1 << 30)))
        chunk = layer0.analyze(opt, x, f0, device=device)
        l1 = layer1.chunk_to_layer1(chunk)
        tgt = coder_mod.encode(cc, l1).cpu().numpy()
        rows.append((ids, pos, tgt, f0))

    nmax = max(r[0].shape[0] for r in rows)
    B, D = len(rows), rows[0][2].shape[-1]
    out = {
        "ids": np.zeros((B, nmax), np.int32),
        "feats": np.zeros((B, nmax, 2), np.float32),
        "targets": np.zeros((B, nmax, D), np.float32),
        "mask": np.zeros((B, nmax), np.float32),
        "f0": np.zeros((B, nmax), np.float32),
    }
    for i, (ids, pos, tgt, f0) in enumerate(rows):
        n = ids.shape[0]
        gp = np.arange(n) / max(n - 1, 1)
        out["ids"][i, :n] = ids
        out["feats"][i, :n, 0] = pos
        out["feats"][i, :n, 1] = gp
        out["targets"][i, :n] = tgt
        out["mask"][i, :n] = 1.0
        out["f0"][i, :n] = f0
    out["cc"] = cc
    return out
