"""Deterministic synthetic speech-like test signals (pure numpy).

A copy of the fixtures of libllsm2_tpu/utils/testsig.py (the first five,
the hardened, nasal and voiced-fricative ones, and the oracle fixtures:
out-of-model sources, octave traps, consonant clusters, creak, whisper,
Rd transitions, diphthongs, two voices), so that the port's scripts run
on a machine without jax; tests/test_torch_ops.py and
tests/test_torch_layer1.py hold the copies equal to the originals.  A
vowel-like utterance with a known F0 track: a harmonic source shaped by a
formant envelope, optionally mixed with breath noise (generated in
float64, so the fixture itself introduces no phase error); and LF-excited
speech with a known Rd, whose pulse shape comes from the port's
ops/lf.py.
"""
from __future__ import annotations

import numpy as np


def formant_envelope(f, formants=((700, 80), (1220, 90), (2600, 120)), tilt_db_oct=-6.0):
    """Vowel-ish spectral magnitude envelope at frequencies f [Hz]."""
    f = np.asarray(f, np.float64)
    env = np.zeros_like(f)
    for fc, bw in formants:
        env += 1.0 / np.sqrt(1.0 + ((f - fc) / bw) ** 4)
    env += 1e-3
    tilt = np.power(np.maximum(f, 50.0) / 200.0, tilt_db_oct / 6.0)
    return env * np.minimum(tilt, 1.0)


def make_f0_track(nfrm: int, thop: float, f0_base=140.0, vibrato_hz=5.0,
                  vibrato_depth=0.03, glide=0.25, unvoiced_tail_frac=0.0):
    """Smooth F0 contour [nfrm] with vibrato and a slow glide; optionally a
    trailing unvoiced region (f0 = 0)."""
    t = np.arange(nfrm) * thop
    f0 = f0_base * (1.0 + glide * (t / max(t[-1], 1e-9) - 0.5)) \
        * (1.0 + vibrato_depth * np.sin(2 * np.pi * vibrato_hz * t))
    if unvoiced_tail_frac > 0:
        n_uv = int(nfrm * unvoiced_tail_frac)
        if n_uv > 0:
            f0[-n_uv:] = 0.0
    return f0.astype(np.float64)


def synth_harmonic(f0_frames, fs=16000.0, thop=0.005, nharmonics=60,
                   fnyq=None, seed=0, noise_level=0.0,
                   noise_band=(2500.0, 7000.0), return_parts=False):
    """Additive-harmonic utterance from a frame-rate F0 track.

    Returns (x [nx], f0_frames), or (x, f0_frames, x_harm) with
    return_parts=True, where x_harm is the clean harmonic component at
    the same final scale as x.  Harmonic amplitudes follow a fixed formant
    envelope sampled at k*f0(t); phases are coherent (integral of k*f0 in
    float64).  If noise_level > 0, adds band-limited Gaussian noise
    amplitude-modulated by the glottal cycle.
    """
    f0_frames = np.asarray(f0_frames, np.float64)
    src = _harmonic_source(f0_frames, fs, thop, nharmonics, fnyq)
    x, x_harm = _add_noise(src, fs, seed, noise_level, noise_band)
    if return_parts:
        return x.astype(np.float64), f0_frames, x_harm.astype(np.float64)
    return x.astype(np.float64), f0_frames


def _harmonic_source(f0_frames, fs, thop, nharmonics, fnyq):
    """synth_harmonic's normalized harmonic part with its sample-rate
    voicing and cycle track: (x, voiced_s, phase_cycles)."""
    nhop = int(round(thop * fs))
    nfrm = len(f0_frames)
    nx = nfrm * nhop
    t = np.arange(nx) / fs
    # sample-rate F0 via linear interpolation between frame centers
    frame_t = np.arange(nfrm) * thop
    voiced_f = f0_frames > 0
    f0_s = np.interp(t, frame_t, np.where(voiced_f, f0_frames, 0.0))
    voiced_s = np.interp(t, frame_t, voiced_f.astype(np.float64)) > 0.999
    phase_cycles = np.cumsum(np.where(voiced_s, f0_s, 0.0)) / fs

    x = np.zeros(nx)
    fny = fnyq if fnyq is not None else 0.47 * fs
    for k in range(1, nharmonics + 1):
        fk = k * f0_s
        active = voiced_s & (fk < fny)
        if not active.any():
            break
        amp = formant_envelope(fk) * active
        x += amp * np.cos(2 * np.pi * k * phase_cycles + 0.7 * k)
    x /= max(np.abs(x).max(), 1e-9)
    return x, voiced_s, phase_cycles


def _add_noise(src, fs, seed, noise_level, noise_band):
    """synth_harmonic's breath noise on a _harmonic_source -> (x, x_harm)."""
    x, voiced_s, phase_cycles = src
    x_harm = x
    if noise_level > 0:
        nx = len(x)
        rng = np.random.default_rng(seed)
        n = rng.standard_normal(nx)
        spec = np.fft.rfft(n)
        f = np.fft.rfftfreq(nx, 1 / fs)
        band = (f >= noise_band[0]) & (f <= noise_band[1])
        spec *= band
        n = np.fft.irfft(spec, nx)
        n /= max(np.abs(n).max(), 1e-9)
        mod = np.where(voiced_s,
                       0.5 + 0.5 * np.cos(2 * np.pi * phase_cycles), 1.0)
        x = x + noise_level * n * mod
        scale = max(np.abs(x).max(), 1e-9)
        x = x / scale
        x_harm = x_harm / scale
    return x, x_harm


def make_test_utterance(duration=1.0, fs=16000.0, thop=0.005, seed=0,
                        noise_level=0.0, unvoiced_tail_frac=0.0,
                        return_parts=False):
    """One-call fixture: returns (x float64 [nx], f0 float64 [nfrm]);
    with return_parts=True also the clean harmonic component (same
    scale), for un-confounded harmonic-SNR oracles on noisy fixtures."""
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    f0 = make_f0_track(nfrm, thop, unvoiced_tail_frac=unvoiced_tail_frac)
    return synth_harmonic(f0, fs=fs, thop=thop, seed=seed,
                          noise_level=noise_level,
                          return_parts=return_parts)


def synth_lf_speech(f0_frames, rd=1.0, fs=16000.0, thop=0.005,
                    formants=((700, 80), (1220, 90), (2600, 120)),
                    zeros=(), noise_level=0.02, seed=0):
    """LF glottal flow derivative pulses of known Rd (a scalar, or one per
    frame held constant over each glottal cycle) through an all-pole
    formant filter, optional antiformants (min-phase zero pairs), lip
    radiation, and aspiration noise; the JAX package's fixture, with the
    pulse shape from the port's ops/lf.py in float32."""
    import torch
    from scipy import signal as sps

    from ..ops import lf

    f0_frames = np.asarray(f0_frames, np.float64)
    nhop = int(round(thop * fs))
    nfrm = len(f0_frames)
    nx = nfrm * nhop
    t = np.arange(nx) / fs
    frame_t = np.arange(nfrm) * thop
    f0_s = np.interp(t, frame_t, np.where(f0_frames > 0, f0_frames, 0.0))
    voiced_s = f0_s > 1.0
    cycles = np.cumsum(np.where(voiced_s, f0_s, 0.0)) / fs

    # the pulse shape within each cycle: u[n] = E(frac(cycles[n]))
    phase = torch.as_tensor(cycles % 1.0, dtype=torch.float32)
    rd_arr = np.asarray(rd, np.float64)
    if rd_arr.ndim == 0:
        p = lf.lf_from_rd(float(rd))
    else:
        # per-frame Rd track, held constant per glottal cycle
        assert rd_arr.shape == (nfrm,), (rd_arr.shape, nfrm)
        c_idx = np.floor(cycles).astype(np.int64)
        ncyc = int(c_idx.max()) + 1
        onset = np.searchsorted(cycles, np.arange(ncyc))
        rd_cyc = rd_arr[np.clip(onset // nhop, 0, nfrm - 1)]
        rd_s = rd_cyc[np.clip(c_idx, 0, ncyc - 1)]
        p = lf.lf_from_rd(torch.as_tensor(rd_s, dtype=torch.float32))
    u = lf.lf_flow_deriv(phase, p).numpy() * voiced_s

    # all-pole formant filter (cascade of resonators)
    x = u.astype(np.float64)
    for fc, bw in formants:
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * fc / fs
        a = [1.0, -2 * r * np.cos(th), r * r]
        x = sps.lfilter([1.0 - r], a, x)
    for fc, bw in zeros:
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * fc / fs
        b = np.array([1.0, -2 * r * np.cos(th), r * r])
        x = sps.lfilter(b / b.sum(), [1.0], x)   # unit DC gain, min-phase
    # lip radiation (differentiator)
    x = np.diff(x, prepend=0.0)

    if noise_level > 0:
        rng = np.random.default_rng(seed)
        n = rng.standard_normal(nx)
        b, a = sps.butter(2, 2500 / (fs / 2), "highpass")
        n = sps.lfilter(b, a, n)
        x = x + noise_level * np.std(x) / max(np.std(n), 1e-9) * n
    x = x / max(np.abs(x).max(), 1e-9)
    return x, f0_frames


def make_hard_f0_track(nfrm: int, thop: float, register: str = "male",
                       jitter: float = 0.0, seed: int = 0,
                       unvoiced_tail_frac: float = 0.0):
    """F0 contour for the hardened fixtures (VERDICT r1 #6): three
    registers (male 80 / female 220 / child 300 Hz base), vibrato, glide,
    and optional cycle-to-cycle jitter (random-walk perturbation, the
    classic voice-quality stressor)."""
    base = {"male": 80.0, "female": 220.0, "child": 300.0}[register]
    f0 = make_f0_track(nfrm, thop, f0_base=base,
                       unvoiced_tail_frac=unvoiced_tail_frac)
    if jitter > 0:
        rng = np.random.default_rng(seed + 17)
        walk = np.cumsum(rng.standard_normal(nfrm))
        walk = walk - np.linspace(walk[0], walk[-1], nfrm)
        walk /= max(np.abs(walk).max(), 1e-9)
        f0 = f0 * (1.0 + jitter * walk) * (f0 > 0)
    return f0


def synth_hard_utterance(duration=1.0, fs=16000.0, thop=0.005,
                         register="male", seed=0, jitter=0.01,
                         shimmer=0.1, glide_formants=True,
                         burst=True, noise_level=0.05,
                         unvoiced_tail_frac=0.15):
    """Hardened fixture (VERDICT r1 #6): jitter + shimmer + diphthong
    formant glides + a consonant burst + breath noise + unvoiced tail,
    at a selectable F0 register.  Returns (x, f0, x_harm) with x_harm
    the clean harmonic component at the same scale.

    Built in float64 on the host like synth_harmonic; the formant
    envelope glides from /a/-like to /i/-like targets when
    glide_formants is set, amplitudes get a slow multiplicative shimmer,
    and `burst` injects a 25 ms high-band noise transient (stop-consonant
    release) right before the voiced region.
    """
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    f0_frames = make_hard_f0_track(nfrm, thop, register=register,
                                   jitter=jitter, seed=seed,
                                   unvoiced_tail_frac=unvoiced_tail_frac)
    nx = nfrm * nhop
    t = np.arange(nx) / fs
    frame_t = np.arange(nfrm) * thop
    f0_s = np.interp(t, frame_t, np.where(f0_frames > 0, f0_frames, 0.0))
    voiced_s = np.interp(t, frame_t,
                         (f0_frames > 0).astype(np.float64)) > 0.999
    phase_cycles = np.cumsum(np.where(voiced_s, f0_s, 0.0)) / fs

    # diphthong formant glide: /a/ (730, 1090, 2440) -> /i/ (270, 2290, 3010)
    fa = np.array([[730.0, 90.0], [1090.0, 110.0], [2440.0, 140.0]])
    fi = np.array([[270.0, 60.0], [2290.0, 120.0], [3010.0, 150.0]])
    g = (t / max(t[-1], 1e-9))[:, None, None] if glide_formants else 0.0
    form_t = fa[None] * (1 - g) + fi[None] * g          # [nx, 3, 2]

    rng = np.random.default_rng(seed)
    # slow multiplicative shimmer (amplitude modulation, ~8 Hz band)
    sh = rng.standard_normal(nx)
    b = np.fft.rfft(sh)
    fr = np.fft.rfftfreq(nx, 1 / fs)
    b *= np.exp(-0.5 * (fr / 8.0) ** 2)
    sh = np.fft.irfft(b, nx)
    sh = 1.0 + shimmer * sh / max(np.abs(sh).max(), 1e-9)

    x = np.zeros(nx)
    fny = 0.47 * fs
    for k in range(1, 81):
        fk = k * f0_s
        active = voiced_s & (fk < fny)
        if not active.any():
            break
        env = np.zeros(nx)
        for j in range(3):
            fc, bw = form_t[:, j, 0], form_t[:, j, 1]
            env += 1.0 / np.sqrt(1.0 + ((fk - fc) / bw) ** 4)
        env += 1e-3
        tilt = np.power(np.maximum(fk, 50.0) / 200.0, -1.0)
        amp = env * np.minimum(tilt, 1.0) * active
        x += amp * np.cos(2 * np.pi * k * phase_cycles + 0.7 * k)
    x *= sh
    x /= max(np.abs(x).max(), 1e-9)
    x_harm = x.copy()

    if burst:
        # 25 ms high-band transient at the first voiced onset
        on = int(np.argmax(voiced_s)) if voiced_s.any() else 0
        start = max(on - int(0.030 * fs), 0)
        L = int(0.025 * fs)
        n = rng.standard_normal(L)
        spec = np.fft.rfft(n)
        fb = np.fft.rfftfreq(L, 1 / fs)
        spec *= (fb > 2000.0)
        n = np.fft.irfft(spec, L)
        n *= np.exp(-np.arange(L) / (0.004 * fs))
        n /= max(np.abs(n).max(), 1e-9)
        x[start:start + L] += 0.5 * n[:max(0, min(L, nx - start))]

    if noise_level > 0:
        n = rng.standard_normal(nx)
        spec = np.fft.rfft(n)
        fr = np.fft.rfftfreq(nx, 1 / fs)
        spec *= (fr >= 2500.0) & (fr <= 7000.0)
        n = np.fft.irfft(spec, nx)
        n /= max(np.abs(n).max(), 1e-9)
        mod = np.where(voiced_s,
                       0.5 + 0.5 * np.cos(2 * np.pi * phase_cycles), 1.0)
        x = x + noise_level * n * mod

    scale = max(np.abs(x).max(), 1e-9)
    return ((x / scale).astype(np.float64), f0_frames,
            (x_harm / scale).astype(np.float64))


def synth_nasal_utterance(duration=1.0, fs=16000.0, thop=0.005, rd=1.0,
                          f0_base=120.0, seed=0, noise_level=0.02,
                          zero=(800.0, 100.0)):
    """Nasal-murmur stress fixture (VERDICT r2 missing #2): LF source
    through a pole-zero tract -- low dense F1 (~250 Hz), damped higher
    formants, and an ANTIFORMANT near `zero` Hz (the /m/-like side-branch
    null).  The spectral zero violates the smooth-envelope interpolation
    and exercises the minimum-phase reconstruction in layer 1.
    Returns (x, f0)."""
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    f0 = make_f0_track(nfrm, thop, f0_base=f0_base, vibrato_depth=0.015,
                       glide=0.1)
    return synth_lf_speech(
        f0, rd=rd, fs=fs, thop=thop,
        formants=((250.0, 70.0), (1100.0, 180.0), (2300.0, 220.0)),
        zeros=(zero,), noise_level=noise_level, seed=seed)


def synth_voiced_fricative(duration=1.0, fs=16000.0, thop=0.005,
                           f0_base=110.0, seed=0, frication=0.35,
                           mod_sharpness=2.0, noise_band=(3000.0, 7500.0),
                           return_parts=False):
    """Voiced-fricative stress fixture (/z/-like; VERDICT r2 missing #2):
    strong low harmonics PLUS strong frication noise in a high band,
    amplitude-modulated by the glottal cycle (the noise pulses at glottal
    closure).  Stresses the analyzer's hardest separation: simultaneous
    harmonic and modulated-noise energy, with the noise envelope's
    harmonic decomposition (edc/eenv) carrying real structure.

    Returns (x, f0) or, with return_parts, (x, f0, x_harm, cycles) where
    cycles is the sample-level glottal phase (for modulation oracles).
    """
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    f0t = make_f0_track(nfrm, thop, f0_base=f0_base, vibrato_depth=0.02,
                        glide=0.15)
    nx = nfrm * nhop
    t = np.arange(nx) / fs
    frame_t = np.arange(nfrm) * thop
    f0_s = np.interp(t, frame_t, f0t)
    cycles = np.cumsum(f0_s) / fs

    # voiced part: harmonics through a lowpassed vowel envelope
    x = np.zeros(nx)
    for k in range(1, 40):
        fk = k * f0_s
        active = fk < 0.47 * fs
        if not active.any():
            break
        amp = formant_envelope(fk) / np.sqrt(1.0 + (fk / 2500.0) ** 6)
        x += amp * active * np.cos(2 * np.pi * k * cycles + 0.7 * k)
    x /= max(np.abs(x).max(), 1e-9)
    x_harm = x.copy()

    # frication: band noise x glottal-cycle modulation (peaky)
    rng = np.random.default_rng(seed)
    n = rng.standard_normal(nx)
    spec = np.fft.rfft(n)
    fr = np.fft.rfftfreq(nx, 1 / fs)
    spec *= (fr >= noise_band[0]) & (fr <= noise_band[1])
    n = np.fft.irfft(spec, nx)
    n /= max(np.std(n), 1e-9)
    mod = (0.5 + 0.5 * np.cos(2 * np.pi * cycles)) ** mod_sharpness
    x = x + frication * n * mod

    scale = max(np.abs(x).max(), 1e-9)
    x /= scale
    x_harm /= scale
    if return_parts:
        return x.astype(np.float64), f0t, x_harm.astype(np.float64), cycles
    return x.astype(np.float64), f0t


def make_test_utterances(rows, duration=1.0, fs=16000.0, thop=0.005):
    """make_test_utterance(duration, fs, thop, seed, noise_level,
    return_parts=True) for every (seed, noise_level) of `rows`, with the
    harmonic part (which depends on neither) synthesized once -> list of
    (x, f0, x_harm)."""
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    f0 = make_f0_track(nfrm, thop)
    src = _harmonic_source(f0, fs, thop, 60, None)
    return [(x.astype(np.float64), f0, x_harm.astype(np.float64))
            for x, x_harm in (_add_noise(src, fs, seed, level,
                                         (2500.0, 7000.0))
                              for seed, level in rows)]


def corpus_row(i: int, half: int = 64) -> int:
    """The bench row that file i of write_test_corpus is cut from: even
    files from the noisy rows [0, half), odd ones from the clean rows
    [half, 2 half), in turn."""
    return (i // 2) % half + (half if i % 2 else 0)


def write_test_corpus(dirpath, n_files: int, row, fs: float = 16000.0,
                      nhop: int = 80, seed: int = 0, min_s: float = 0.5,
                      max_s: float = 8.0):
    """Write a seeded corpus of n_files int16 WAVs (utils.audio.wavwrite)
    to dirpath for the corpus runner (BASELINE config 5): file i is a cut
    of row(i) -> (x [nx], f0 [nx // nhop]) (bench rows: corpus_row(i)),
    its length drawn uniformly over [min_s, max_s] seconds and its start a
    whole number of hops into the row, drawn after it.  Files 4k and 4k+1
    get an F0 sidecar (``<name>.f0.npy``, the row's track over the file's
    frames), 4k+2 and 4k+3 none.  The draws do not depend on n_files, so a
    smaller corpus is the first files of a larger one.  -> list of paths."""
    import os

    from .audio import wavwrite
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        x, f0 = row(i)
        n = int(round(rng.uniform(min_s, max_s) * fs))
        s = int(rng.integers(0, (len(x) - n) // nhop + 1)) * nhop
        p = os.path.join(str(dirpath), f"utt{i:05d}.wav")
        wavwrite(p, np.asarray(x[s:s + n], np.float32), fs)
        if i % 4 < 2:
            np.save(p[:-4] + ".f0.npy",
                    np.asarray(f0[s // nhop:(s + n) // nhop], np.float32))
        paths.append(p)
    return paths


def _rosenberg_flow(phase: np.ndarray, tp=0.40, tn=0.16) -> np.ndarray:
    """Rosenberg-B glottal FLOW on phase in [0, 1): raised-cosine opening
    over [0, tp), cosine-quarter closing over [tp, tp+tn), closed after.
    A classic non-LF source model (Rosenberg 1971)."""
    p = phase % 1.0
    opening = 0.5 * (1.0 - np.cos(np.pi * p / tp))
    closing = np.cos(0.5 * np.pi * (p - tp) / tn)
    return np.where(p < tp, opening, np.where(p < tp + tn, closing, 0.0))


def _klatt_flow(phase: np.ndarray, oq=0.6) -> np.ndarray:
    """KLGLOTT88 polynomial flow: a*t^2 - b*t^3 over the open phase
    [0, oq) with flow(oq) = 0, i.e. u^2*(1-u) in normalized open-phase
    time -- closes with a nonzero slope (abrupt closure), unlike the LF
    family's exponential return (Klatt & Klatt 1990).  Peak = 1."""
    p = phase % 1.0
    u = p / oq
    return np.where(p < oq, u * u * (1.0 - u) * (27.0 / 4.0), 0.0)


def _triangle_flow(phase: np.ndarray, tp=0.45, te=0.65) -> np.ndarray:
    """Asymmetric triangular flow: linear rise to 1 at tp, linear fall to
    0 at te, closed after.  The flow derivative is piecewise-constant
    with jump discontinuities -- maximally spectrally rich, nothing like
    the LF family's smooth return phase."""
    p = phase % 1.0
    rise = p / tp
    fall = (te - p) / (te - tp)
    return np.where(p < tp, rise, np.where(p < te, fall, 0.0))


_OOM_SOURCES = {
    "rosenberg": _rosenberg_flow,
    "klatt": _klatt_flow,
    "triangle": _triangle_flow,
}


def synth_outofmodel_utterance(source: str, duration=1.0, fs=16000.0,
                               thop=0.005,
                               formants=((700, 80), (1220, 90), (2600, 120)),
                               noise_level=0.02, seed=0, f0_base=140.0,
                               reverb_rt60=0.0, clip_frac=0.0):
    """Adversarial OUT-OF-MODEL fixture (VERDICT r3 missing #2): the
    excitation is a glottal-flow model from a DIFFERENT family than the
    LF model layer1 fits (Rosenberg / Klatt / asymmetric triangle), so
    quality numbers measured on it carry no shared-model circularity.

    Optional stressors applied AFTER the vocal-tract filter:
      reverb_rt60 > 0: convolve with a synthetic exponentially-decaying
        noise impulse response (small-room reverb) -- violates the
        frame-local production model.
      clip_frac > 0: hard-clip the waveform at (1 - clip_frac) of its
        peak -- consumer-recording saturation.

    Returns (x [nx], f0 [nfrm]) like synth_lf_speech; the F0 track has
    mild vibrato so tracks are realistic but fully voiced.
    """
    from scipy import signal as sps

    flow_fn = _OOM_SOURCES[source]
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    frame_t = np.arange(nfrm) * thop
    f0_frames = f0_base * (1.0 + 0.02 * np.sin(2 * np.pi * 4.5 * frame_t)
                           + 0.05 * np.sin(2 * np.pi * 0.7 * frame_t))
    nx = nfrm * nhop
    t = np.arange(nx) / fs
    f0_s = np.interp(t, frame_t, f0_frames)
    cycles = np.cumsum(f0_s) / fs
    flow = flow_fn(cycles % 1.0)
    u = np.diff(flow, prepend=flow[:1])          # flow derivative source

    x = u.astype(np.float64)
    for fc, bw in formants:
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * fc / fs
        x = sps.lfilter([1.0 - r], [1.0, -2 * r * np.cos(th), r * r], x)
    x = np.diff(x, prepend=0.0)                  # lip radiation

    if noise_level > 0:
        rng = np.random.default_rng(seed)
        n = rng.standard_normal(nx)
        b, a = sps.butter(2, 2500 / (fs / 2), "highpass")
        n = sps.lfilter(b, a, n)
        x = x + noise_level * np.std(x) / max(np.std(n), 1e-9) * n

    if reverb_rt60 > 0:
        rng = np.random.default_rng(seed + 1)
        nir = int(reverb_rt60 * fs)
        decay = np.exp(-6.9 * np.arange(nir) / nir)   # -60 dB at rt60
        ir = rng.standard_normal(nir) * decay
        ir[0] = 3.0                                    # direct path
        ir /= np.sqrt(np.sum(ir ** 2))
        x = sps.fftconvolve(x, ir)[:nx]

    if clip_frac > 0:
        lim = (1.0 - clip_frac) * np.abs(x).max()
        x = np.clip(x, -lim, lim)

    x = x / max(np.abs(x).max(), 1e-9)
    return x, f0_frames


def make_octave_trap(duration=1.0, fs=16000.0, thop=0.005, f0_base=110.0,
                     fmt_mult=2.0, bw=60.0, floor_amp=0.02):
    """Octave-error stress fixture for F0 trackers (VERDICT r2 #3): a
    narrow formant centered EXACTLY on harmonic `fmt_mult` makes that
    harmonic dominate by >12 dB, so the YIN difference function dips at
    the corresponding fraction/multiple of the true lag -- the classic
    condition under which single-pass CMNDF trackers lock an octave off.
    Returns (x [nx], f0 [nfrm]) with the TRUE track."""
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    f0t = make_f0_track(nfrm, thop, f0_base=f0_base,
                        vibrato_depth=0.01, glide=0.1)
    nx = nfrm * nhop
    t = np.arange(nx) / fs
    frame_t = np.arange(nfrm) * thop
    f0_s = np.interp(t, frame_t, f0t)
    ph = np.cumsum(f0_s) / fs
    x = np.zeros(nx)
    for k in range(1, 40):
        fk = k * f0_s
        amp = 1.0 / np.sqrt(1.0 + ((fk - fmt_mult * f0_base) / bw) ** 4) \
            + floor_amp / k
        x += amp * np.cos(2 * np.pi * k * ph + 0.3 * k)
    x /= np.abs(x).max()
    return x, f0t




def synth_consonant_cluster(duration=1.2, fs=16000.0, thop=0.005,
                            f0_base=130.0, seed=0, n_syllables=4,
                            return_parts=False):
    """Consonant-cluster stress fixture (VERDICT r2 missing #2): rapid
    voiced/unvoiced alternation -- vowel segments separated by stop gaps
    with plosive release bursts (CV-CV...).  Stresses voicing-boundary
    handling: OLA edges, envelope guards, and burst placement in the
    noise model.  Returns (x, f0) or with return_parts also the clean
    voiced component x_harm."""
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    nx = nfrm * nhop
    rng = np.random.default_rng(seed)

    # voicing pattern: n_syllables vowels separated by stop gaps
    f0 = np.zeros(nfrm)
    syl = nfrm // n_syllables
    gap = max(int(0.06 / thop), 2)            # ~60 ms closure+burst
    for s in range(n_syllables):
        a, b = s * syl + gap, min((s + 1) * syl, nfrm)
        if b - a <= 0:       # gap swallowed the whole syllable
            continue
        t = np.arange(b - a) * thop
        f0[a:b] = f0_base * (1.0 + 0.05 * np.sin(2 * np.pi * 4.0 * t)
                             - 0.1 * (t / max(t[-1], 1e-9)))

    t = np.arange(nx) / fs
    frame_t = np.arange(nfrm) * thop
    f0_s = np.interp(t, frame_t, f0)
    voiced_s = np.interp(t, frame_t, (f0 > 0).astype(np.float64)) > 0.999
    cycles = np.cumsum(np.where(voiced_s, f0_s, 0.0)) / fs
    x = np.zeros(nx)
    for k in range(1, 50):
        fk = k * np.maximum(f0_s, 1.0)
        active = voiced_s & (fk < 0.47 * fs)
        if not active.any():
            break
        amp = formant_envelope(fk) * active
        x += amp * np.cos(2 * np.pi * k * cycles + 0.7 * k)
    # soft 10 ms voicing on/offsets (glottal attack)
    ramp = np.convolve(voiced_s.astype(np.float64),
                       np.ones(int(0.01 * fs)) / int(0.01 * fs), "same")
    x *= ramp
    x /= max(np.abs(x).max(), 1e-9)
    x_harm = x.copy()

    # plosive release burst right before each vowel onset
    on = np.flatnonzero(np.diff(voiced_s.astype(np.int8)) > 0)
    L = int(0.02 * fs)
    for o in on:
        start = max(o - int(0.025 * fs), 0)
        n = rng.standard_normal(L)
        S = np.fft.rfft(n)
        fb = np.fft.rfftfreq(L, 1 / fs)
        S *= fb > 1500.0
        n = np.fft.irfft(S, L) * np.exp(-np.arange(L) / (0.004 * fs))
        n /= max(np.abs(n).max(), 1e-9)
        x[start:start + L] += 0.4 * n[:max(0, min(L, nx - start))]

    scale = max(np.abs(x).max(), 1e-9)
    x /= scale
    x_harm /= scale
    if return_parts:
        return x.astype(np.float64), f0, x_harm.astype(np.float64)
    return x.astype(np.float64), f0


def synth_creaky_utterance(duration=1.0, fs=16000.0, thop=0.005,
                           pulse_rate=90.0, alt_amp=0.55, alt_period=0.04,
                           rd=2.5,
                           formants=((700, 80), (1220, 90), (2600, 120)),
                           noise_level=0.01, seed=0):
    """Creaky-voice / diplophonia fixture: LF glottal pulses with
    ALTERNATING per-pulse amplitude (alt_amp) and period (+-alt_period)
    through a formant filter -- a period-doubled source whose true
    periodicity is pulse_rate/2.

    Returns (x, f0_pattern): f0_pattern is the frame-rate F0 track at the
    PATTERN rate (pulse_rate/2, exact: the +- period alternation cancels
    over a pair), which is what the analysis should be given.  In the
    harmonic model the even harmonics of the pattern rate carry the mean
    pulse spectrum and the odd (sub)harmonics the alternation depth;
    alt_amp=1, alt_period=0 degenerates to a plain periodic source with
    zero odd-harmonic energy.  Stresses low-F0 window sizing (f0_floor)
    and maxnhar coverage (at 45 Hz the default maxnhar=80 reaches only
    3.6 kHz).  Reference: no analog in test/ (voice-quality stressor)."""
    import torch
    from scipy import signal as sps

    from ..ops import lf

    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    nx = nfrm * nhop
    t = np.arange(nx) / fs

    T0 = 1.0 / pulse_rate
    n_pulse = int(np.ceil(duration * pulse_rate)) + 2
    periods = T0 * (1.0 + alt_period * np.where(
        np.arange(n_pulse) % 2 == 0, 1.0, -1.0))
    onsets = 0.02 + np.concatenate([[0.0], np.cumsum(periods[:-1])])
    amps = np.where(np.arange(n_pulse) % 2 == 0, 1.0, alt_amp)

    idx = np.searchsorted(onsets, t, side="right") - 1
    inside = (idx >= 0) & (idx < n_pulse)
    idx_c = np.clip(idx, 0, n_pulse - 1)
    phase = np.where(inside,
                     (t - onsets[idx_c]) / periods[idx_c], 0.0)
    phase = np.clip(phase, 0.0, 1.0 - 1e-6)
    p = lf.lf_from_rd(float(rd))
    u = lf.lf_flow_deriv(torch.as_tensor(phase, dtype=torch.float32),
                         p).numpy().astype(np.float64)
    u = u * np.where(inside, amps[idx_c], 0.0)

    x = u
    for fc, bw in formants:
        r = np.exp(-np.pi * bw / fs)
        th = 2 * np.pi * fc / fs
        x = sps.lfilter([1.0 - r], [1.0, -2 * r * np.cos(th), r * r], x)
    x = np.diff(x, prepend=0.0)                      # lip radiation

    if noise_level > 0:
        rng = np.random.default_rng(seed)
        n = rng.standard_normal(nx)
        b, a = sps.butter(2, 2500 / (fs / 2), "highpass")
        n = sps.lfilter(b, a, n)
        x = x + noise_level * np.std(x) / max(np.std(n), 1e-9) * n
    x = x / max(np.abs(x).max(), 1e-9)

    f0_pattern = np.full(nfrm, pulse_rate / 2.0)
    return x.astype(np.float64), f0_pattern


def synth_whisper_utterance(duration=1.0, fs=16000.0, thop=0.005,
                            formants=((700, 120), (1220, 150),
                                      (2600, 200)),
                            seed=0):
    """Whispered speech (VERDICT r4 #7): NO glottal source at all --
    turbulence noise through the vocal tract, F0 identically zero, so
    the whole utterance rides the unvoiced/noise path (edc/psd only,
    zero harmonic slots).  Whisper formants are broader (aspirated
    bandwidths) and slowly time-varying here (a vowel-ish drift).
    Returns (x, f0) with f0 = zeros[nfrm]."""
    from scipy import signal as sps

    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    nx = nfrm * nhop
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(nx)
    # slow formant drift: block-wise resonator cascade with state
    # carry-over (F1/F2 slide ~15% over the utterance)
    blk = nhop
    x = np.zeros(nx)
    zis = [np.zeros(2) for _ in formants]
    for b in range(nfrm):
        t = b / max(nfrm - 1, 1)
        seg = u[b * blk:(b + 1) * blk]
        for i, (fc, bw) in enumerate(formants):
            fct = fc * (1.0 + 0.15 * t * (1 if i % 2 else -1))
            r = np.exp(-np.pi * bw / fs)
            th = 2 * np.pi * fct / fs
            a = [1.0, -2 * r * np.cos(th), r * r]
            seg, zis[i] = sps.lfilter([1.0 - r], a, seg, zi=zis[i])
        x[b * blk:(b + 1) * blk] = seg
    x = np.diff(x, prepend=0.0)
    x /= max(np.abs(x).max(), 1e-9)
    return x.astype(np.float64), np.zeros(nfrm)


def synth_rd_transition_utterance(duration=1.2, fs=16000.0, thop=0.005,
                                  f0_base=120.0, seed=0,
                                  rd_lo=0.5, rd_hi=2.5):
    """Breathy <-> pressed phonation transitions (VERDICT r4 #7): an LF
    source whose Rd swings pressed -> breathy -> pressed over the
    utterance (held per glottal cycle -- the physical ground truth),
    with the aspiration noise level riding Rd (breathier = noisier, the
    physiological covariation).  Returns (x, f0, rd_frames)."""
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    f0 = np.asarray(make_f0_track(nfrm, thop, f0_base=f0_base,
                                  vibrato_depth=0.01, glide=0.05))
    t = np.linspace(0.0, 1.0, nfrm)
    rd = rd_lo + (rd_hi - rd_lo) * 0.5 * (1.0 - np.cos(2 * np.pi * t))
    x, f0 = synth_lf_speech(f0, rd=rd, fs=fs, thop=thop,
                            noise_level=0.0, seed=seed)
    # Rd-riding aspiration: scale a highpassed noise by (rd / rd_hi)
    from scipy import signal as sps
    rng = np.random.default_rng(seed)
    n = rng.standard_normal(len(x))
    b, a = sps.butter(2, 2500 / (fs / 2), "highpass")
    n = sps.lfilter(b, a, n)
    n /= max(np.std(n), 1e-9)
    g = np.repeat(0.05 * rd / rd_hi, nhop)[:len(x)] * np.std(x)
    x = x + g * n
    x /= max(np.abs(x).max(), 1e-9)
    return x.astype(np.float64), f0, rd


def synth_diphthong_utterance(duration=1.0, fs=16000.0, thop=0.005,
                              f0_base=120.0, seed=0,
                              glide=((700.0, 300.0), (1200.0, 2300.0)),
                              stop_gap=True):
    """Diphthong glide with consonant context (VERDICT r4 #7): /ai/-like
    F1/F2 trajectories (time-varying resonators, state carried across
    blocks) around an optional stop-consonant closure + burst in the
    middle -- formant DYNAMICS plus an abrupt production-mode switch,
    which static-formant fixtures never exercise.
    Returns (x, f0)."""
    import torch
    from scipy import signal as sps

    from ..ops import lf

    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    nx = nfrm * nhop
    f0 = np.asarray(make_f0_track(nfrm, thop, f0_base=f0_base,
                                  vibrato_depth=0.01, glide=0.08))
    # stop closure: 60 ms silence + burst at 55% of the utterance
    gap_s = int(0.55 * nfrm)
    gap_e = gap_s + max(int(0.06 / thop), 1)
    if stop_gap:
        f0[gap_s:gap_e] = 0.0
    t = np.arange(nx) / fs
    frame_t = np.arange(nfrm) * thop
    f0_s = np.interp(t, frame_t, np.where(f0 > 0, f0, 0.0))
    voiced_s = f0_s > 1.0
    cycles = np.cumsum(np.where(voiced_s, f0_s, 0.0)) / fs
    p = lf.lf_from_rd(1.0)
    u = lf.lf_flow_deriv(torch.as_tensor(cycles % 1.0, dtype=torch.float32),
                         p).numpy()
    u = u * voiced_s

    # time-varying formant cascade (coefficients updated per hop,
    # filter state carried)
    prog = np.linspace(0.0, 1.0, nfrm)
    x = np.zeros(nx)
    bws = (90.0, 110.0)
    zis = [np.zeros(2) for _ in glide]
    for b in range(nfrm):
        seg = u[b * nhop:(b + 1) * nhop]
        for i, (fa, fb) in enumerate(glide):
            fc = fa + (fb - fa) * prog[b]
            r = np.exp(-np.pi * bws[i] / fs)
            th = 2 * np.pi * fc / fs
            seg, zis[i] = sps.lfilter([1.0 - r],
                                      [1.0, -2 * r * np.cos(th), r * r],
                                      seg, zi=zis[i])
        x[b * nhop:(b + 1) * nhop] = seg
    x = np.diff(x, prepend=0.0)

    if stop_gap:   # release burst at the gap end
        L = int(0.008 * fs)
        start = gap_e * nhop - L // 2
        rng = np.random.default_rng(seed)
        n = rng.standard_normal(L) * np.exp(-np.arange(L) / (0.002 * fs))
        S = np.fft.rfft(n)
        fr = np.fft.rfftfreq(L, 1 / fs)
        S *= (fr > 1200)
        n = np.fft.irfft(S, L)
        n /= max(np.abs(n).max(), 1e-9)
        x[start:start + L] += 0.5 * np.abs(x).max() * n

    # light aspiration so the analyzer's noise floor is realistic
    rng = np.random.default_rng(seed + 1)
    n = rng.standard_normal(nx)
    b_, a_ = sps.butter(2, 2500 / (fs / 2), "highpass")
    n = sps.lfilter(b_, a_, n)
    x = x + 0.02 * np.std(x) / max(np.std(n), 1e-9) * n
    x /= max(np.abs(x).max(), 1e-9)
    return x.astype(np.float64), f0


def synth_two_speaker_mixture(duration=1.0, fs=16000.0, thop=0.005,
                              f0_a=120.0, f0_b=190.0, mix_db=-10.0,
                              seed=0):
    """Two simultaneous voices (VERDICT r4 #7): target voice A plus an
    interfering voice B at mix_db, with well-separated F0s and
    different formants.  Analyzed WITH A's F0 track: the harmonic model
    must keep tracking A and degrade gracefully, not catastrophically
    (B's harmonics land between A's except at accidental near-
    coincidences).  Returns (x_mix, f0_a_frames, x_a)."""
    nhop = int(round(thop * fs))
    nfrm = int(round(duration * fs)) // nhop
    fa = np.asarray(make_f0_track(nfrm, thop, f0_base=f0_a,
                                  vibrato_depth=0.01, glide=0.05))
    fb = np.asarray(make_f0_track(nfrm, thop, f0_base=f0_b,
                                  vibrato_depth=0.015, glide=0.08))
    xa, fa = synth_lf_speech(fa, rd=0.9, fs=fs, thop=thop,
                             noise_level=0.01, seed=seed)
    xb, _ = synth_lf_speech(fb, rd=1.6, fs=fs, thop=thop,
                            formants=((550, 90), (1700, 120),
                                      (2900, 160)),
                            noise_level=0.01, seed=seed + 1)
    g = 10.0 ** (mix_db / 20.0) * np.std(xa) / max(np.std(xb), 1e-9)
    x = xa + g * xb
    scale = max(np.abs(x).max(), 1e-9)
    return ((x / scale).astype(np.float64), fa,
            (xa / scale).astype(np.float64))
