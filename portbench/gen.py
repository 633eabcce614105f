"""Input generator of the benchmark: speech-like batches and synthesis
chunks made on the device from a seed, in plain PyTorch.

A rewrite of the fixtures the repository's tests use (the formant
envelope, the F0 contour with vibrato and glide, the three registers and
the random-walk jitter of the hardened fixtures, the additive harmonic
source and the cycle-modulated breath noise) that makes a whole batch at
once on the card with a ``torch.Generator`` there.  Every row draws its
own contour, so the live harmonics and voiced frames vary from row to
row as in real speech, while each batch holds the same share of each
register and of unvoiced frames: every seed gives the same amount of
work, in another order.  The traffic file gives every parameter.
"""
from __future__ import annotations

import math

import torch

# vowel formants (centre, bandwidth) [Hz]: /a/, /i/, /u/, /e/, /o/
VOWELS = (((700, 80), (1220, 90), (2600, 120)),
          ((280, 60), (2250, 100), (2900, 120)),
          ((310, 60), (870, 80), (2250, 110)),
          ((450, 70), (1850, 100), (2600, 120)),
          ((500, 70), (850, 80), (2500, 120)))


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of draws of a run's seed (any
    whole number: reduced to 63 bits with the stream mixed in)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 0x9E3779B1 + stream * 0x85EBCA77 + 1)
                  % (1 << 63))
    return g


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def f0_contours(g, B: int, N: int, thop: float, p: dict, f0_floor: float,
                device) -> torch.Tensor:
    """F0 contours [B, N] (0 = unvoiced): a third of the rows in each
    register (in a seeded order), each with its own vibrato rate and
    phase, glide direction and size and jitter walk, clamped to
    [f0_floor, f0_ceil]; p["unvoiced_share"] of each row's frames unvoiced
    in p["unvoiced_runs"] runs at seeded places."""
    regs = torch.tensor(list(p["registers"].values()), dtype=torch.float32,
                        device=device)
    order = torch.randperm(B, generator=g, device=device)
    base = regs[order % len(regs)][:, None]
    t = (torch.arange(N, device=device, dtype=torch.float32) * thop)[None]
    T = max(float(N - 1) * thop, 1e-9)
    vib_hz = _uniform(g, (B, 1), *p["vibrato_hz"], device)
    vib_ph = _uniform(g, (B, 1), 0.0, 2.0 * math.pi, device)
    glide = _uniform(g, (B, 1), *p["glide"], device)
    glide = glide * torch.where(torch.rand((B, 1), generator=g,
                                           device=device) < 0.5, -1.0, 1.0)
    f0 = base * (1.0 + glide * (t / T - 0.5)) * (
        1.0 + p["vibrato_depth"] * torch.sin(2.0 * math.pi * vib_hz * t
                                             + vib_ph))
    walk = torch.cumsum(torch.randn((B, N), generator=g, device=device),
                        dim=1)
    lin = torch.linspace(0.0, 1.0, N, device=device)[None]
    walk = walk - (walk[:, :1] + (walk[:, -1:] - walk[:, :1]) * lin)
    walk = walk / torch.clamp(walk.abs().amax(dim=1, keepdim=True), min=1e-9)
    f0 = f0 * (1.0 + p["jitter"] * walk)
    f0 = torch.clamp(f0, f0_floor, p["f0_ceil"])
    # unvoiced runs: one in each of `runs` equal parts of the row
    runs = int(p["unvoiced_runs"])
    part = N // runs
    run_len = int(round(p["unvoiced_share"] * N / runs))
    if run_len > 0:
        idx = torch.arange(N, device=device)[None]
        voiced = torch.ones((B, N), dtype=torch.bool, device=device)
        for r in range(runs):
            start = r * part + torch.randint(0, max(part - run_len, 1), (B, 1),
                                             generator=g, device=device)
            voiced &= ~((idx >= start) & (idx < start + run_len))
        f0 = torch.where(voiced, f0, torch.zeros_like(f0))
    return f0


def formant_envelope(f: torch.Tensor, formants: torch.Tensor,
                     tilt_db_oct: float = -6.0) -> torch.Tensor:
    """Vowel-like magnitude envelope at frequencies f [..., R...] for
    formants [R, 3, 2] (each row's centre and bandwidth), broadcast over
    f's trailing axes after the row."""
    shape = (f.shape[0],) + (1,) * (f.dim() - 1)
    env = torch.full_like(f, 1e-3)
    for j in range(formants.shape[1]):
        fc = formants[:, j, 0].reshape(shape)
        bw = formants[:, j, 1].reshape(shape)
        env = env + torch.rsqrt(1.0 + ((f - fc) / bw) ** 4)
    tilt = torch.pow(torch.clamp(f, min=50.0) / 200.0, tilt_db_oct / 6.0)
    return env * torch.clamp(tilt, max=1.0)


def row_formants(g, B: int, device) -> torch.Tensor:
    """Each row's vowel, drawn from VOWELS -> [B, 3, 2]."""
    table = torch.tensor(VOWELS, dtype=torch.float32, device=device)
    pick = torch.randint(0, len(VOWELS), (B,), generator=g, device=device)
    return table[pick]


def _lerp_index(N: int, nhop: int, device):
    """Each sample's frame i0 and weight w for the lerp between frame
    centres (i*nhop) -> (i0 [nx] int64, w [nx] float32)."""
    pos = torch.arange(N * nhop, device=device, dtype=torch.float32) / nhop
    i0 = torch.clamp(pos.floor().long(), 0, N - 2)
    return i0, torch.clamp(pos - i0, 0.0, 1.0)


def speech(g, f0: torch.Tensor, fs: float, nhop: int, p: dict) -> torch.Tensor:
    """Speech-like rows [B, N*nhop] float32 in [-1, 1] from contours f0
    [B, N]: the sum of the harmonics below p["harmonic_nyquist"] * fs,
    each shaped by its row's vowel envelope at k F0 (taken at the frames
    and lerped), their phases the float64 integral of F0 times k (a
    rotation a harmonic in float32 from the fundamental's phasor), plus
    band-limited breath noise of p["noise_level"], modulated by the
    glottal cycle, on a seeded share p["noise_rows_share"] of the rows."""
    dev = f0.device
    B, N = f0.shape
    nx = N * nhop
    formants = row_formants(g, B, dev)
    i0, w = _lerp_index(N, nhop, dev)
    lerp = lambda a: a[:, i0] * (1.0 - w) + a[:, i0 + 1] * w
    voiced = (f0 > 0).float()
    voiced_s = lerp(voiced) > 0.999
    f0_v = torch.where(voiced_s, lerp(f0), torch.zeros((), device=dev))
    cyc = torch.remainder(torch.cumsum(f0_v.double(), dim=1) / fs, 1.0)
    ph = (2.0 * math.pi * cyc).float()
    z1 = torch.polar(torch.ones_like(ph), ph)
    del f0_v, cyc
    offset = _uniform(g, (B, 1), 0.0, 2.0 * math.pi, dev)
    x = torch.zeros((B, nx), dtype=torch.float32, device=dev)
    fny = p["harmonic_nyquist"] * fs
    fmin = float(f0[f0 > 0].min()) if bool((f0 > 0).any()) else fs
    zk = z1
    for k in range(1, int(fny / fmin) + 1):
        fk = k * f0
        amp = formant_envelope(fk, formants) * (fk < fny) * voiced
        c = torch.polar(torch.ones_like(offset), 0.7 * k + offset)
        x += lerp(amp) * voiced_s * (zk * c).real
        zk = zk * z1
    x = x / torch.clamp(x.abs().amax(dim=1, keepdim=True), min=1e-9)
    # breath noise: band-limited, modulated by the glottal cycle
    n_rows = int(round(p["noise_rows_share"] * B))
    if n_rows and p["noise_level"] > 0:
        rows = torch.randperm(B, generator=g, device=dev)[:n_rows]
        n = torch.randn((n_rows, nx), generator=g, device=dev)
        spec = torch.fft.rfft(n)
        f = torch.fft.rfftfreq(nx, 1.0 / fs, device=dev)
        lo, hi = p["noise_band_hz"]
        n = torch.fft.irfft(spec * ((f >= lo) & (f <= hi)), nx)
        n = n / torch.clamp(n.abs().amax(dim=1, keepdim=True), min=1e-9)
        mod = torch.where(voiced_s[rows], 0.5 + 0.5 * torch.cos(ph[rows]),
                          torch.ones_like(n))
        xr = x[rows] + p["noise_level"] * n * mod
        x[rows] = xr / torch.clamp(xr.abs().amax(dim=1, keepdim=True),
                                   min=1e-9)
    return x


def chunk_fields(g, f0: torch.Tensor, conf: dict, p: dict) -> dict:
    """Synthesis parameters of a batch from contours f0 [B, N], as an
    analysis would give them (a vocoder fed by a TTS or voice-conversion
    model): harmonic amplitudes from each row's vowel envelope at k F0,
    live below conf["fnyq"] on voiced frames; phases from a seeded offset a
    harmonic and a slow drift; a noise PSD on the warped axis rising
    towards high frequencies, p["unvoiced_psd_gain"] times louder on
    unvoiced frames; band DC envelopes and their harmonics at a seeded
    depth, their phases drawn a frame.  -> dict of float32 tensors."""
    dev = f0.device
    B, N = f0.shape
    K, C, Ke = conf["maxnhar"], conf["nchannel"], conf["maxnhar_e"]
    npsd = conf["npsd"]
    formants = row_formants(g, B, dev)
    kh = torch.arange(1, K + 1, dtype=torch.float32, device=dev)
    voiced = f0 > 0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    fk = kh * f0s[..., None]                                 # [B, N, K]
    mask = (voiced[..., None] & (fk < conf["fnyq"])).float()
    ampl = p["harmonic_level"] * formant_envelope(fk, formants) * mask
    t = torch.arange(N, dtype=torch.float32, device=dev) * conf["thop"]
    theta = _uniform(g, (B, 1, K), -math.pi, math.pi, dev)
    drift = _uniform(g, (B, 1, K), 0.5, 2.0, dev)
    ph = theta + 0.3 * torch.sin(2.0 * math.pi * drift * t[None, :, None])
    phse = torch.remainder(ph + math.pi, 2.0 * math.pi) - math.pi
    j = torch.arange(npsd, dtype=torch.float32, device=dev) / npsd
    shape = torch.exp(-((j - 0.6) / 0.3) ** 2) + 0.1
    level = p["psd_level"] * (1.0 + 0.5 * torch.sin(
        2.0 * math.pi * _uniform(g, (B, 1), 0.5, 3.0, dev) * t[None]))
    level = level * torch.where(voiced, 1.0, p["unvoiced_psd_gain"])
    psd = level[..., None] * shape
    edc = _uniform(g, (B, 1, C), 0.5, 1.0, dev) * (
        1.0 + 0.2 * torch.sin(2.0 * math.pi * 1.5 * t[None, :, None]))
    depth = _uniform(g, (B, 1, C, 1), 0.0, p["envelope_depth"], dev)
    ke = torch.arange(1, Ke + 1, dtype=torch.float32, device=dev)
    eenv_a = (edc[..., None] * depth / ke) * voiced[..., None, None]
    eenv_p = _uniform(g, (B, N, C, Ke), -math.pi, math.pi, dev)
    return dict(f0=f0, ampl=ampl, phse=phse * mask, hm_mask=mask, psd=psd,
                edc=edc.expand(B, N, C).contiguous(), eenv_a=eenv_a,
                eenv_p=eenv_p * (eenv_a > 0))
