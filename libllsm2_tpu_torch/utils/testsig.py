"""Deterministic synthetic speech-like test signals (pure numpy).

A copy of the first four fixtures of libllsm2_tpu/utils/testsig.py, so
that the port's scripts run on a machine without jax;
tests/test_torch_ops.py holds the copies equal to the originals.  A
vowel-like utterance with a known F0 track: a harmonic source shaped by a
formant envelope, optionally mixed with breath noise.  Generated in
float64 so the fixture itself introduces no phase error.
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
    rng = np.random.default_rng(seed)
    for k in range(1, nharmonics + 1):
        fk = k * f0_s
        active = voiced_s & (fk < fny)
        if not active.any():
            break
        amp = formant_envelope(fk) * active
        x += amp * np.cos(2 * np.pi * k * phase_cycles + 0.7 * k)
    x /= max(np.abs(x).max(), 1e-9)

    x_harm = x
    if noise_level > 0:
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
    if return_parts:
        return x.astype(np.float64), f0_frames, x_harm.astype(np.float64)
    return x.astype(np.float64), f0_frames


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
