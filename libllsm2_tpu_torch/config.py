"""Configuration dataclasses of the PyTorch port.

A copy of libllsm2_tpu/config.py (the port must not import the JAX
package, whose __init__ imports jax).  Same fields, defaults and derived
properties; tests/test_torch_ops.py holds the two copies equal.  In the
port, ``use_pallas=True`` means "run the hand-written CUDA kernels"
(ops/kernels.py), and False "run the JAX package's jnp branches in plain
PyTorch".  Reference: llsm.h -> llsm_aoptions / llsm_soptions /
LLSM_CONF_* conf-container entries.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ChunkConf:
    """Self-describing configuration carried with every chunk.  The frame
    count is not part of the conf: it is the frame axis of the chunk
    tensors, so one conf describes a whole batch of utterances."""

    fs: float = 16000.0          # sample rate [Hz]
    thop: float = 0.005          # hop (frame period) [s]; thop*fs must be integral
    maxnhar: int = 80            # max number of harmonics (slot k = harmonic (k+1)*f0)
    maxnhar_e: int = 4           # max harmonics of the band-wise temporal noise envelope
    npsd: int = 128              # number of warped-frequency PSD bins
    nchannel: int = 4            # number of noise-envelope channels
    chanfreq: Tuple[float, ...] = (2000.0, 4000.0, 6000.0)  # channel boundaries [Hz]
    noswarp: float = 15000.0     # frequency-warping constant for the noise PSD axis
    lip_radius: float = 0.015    # lip radiation model radius [m] (layer 1)
    nspec: int = 257             # layer-1 vocal-tract magnitude bins (= nfft//2+1)
    fnyq: float = 8000.0         # upper frequency bound of the harmonic model [Hz]
    f0_floor: float = 40.0       # lowest F0 the analysis windows are sized for [Hz]
    f0_ceil: float = 600.0       # highest F0 considered (PbP pulse budget, F0 tracking)
    rel_winsize: float = 4.0     # analysis window length in F0 periods

    @property
    def nhop(self) -> int:
        n = int(round(self.thop * self.fs))
        return max(n, 1)

    @property
    def halfwin_max(self) -> int:
        """Max half-window in samples (pitch-synchronous window at f0_floor)."""
        return int(math.ceil(self.rel_winsize * self.fs / (2.0 * self.f0_floor)))

    @property
    def winlen_max(self) -> int:
        """Static gather width for pitch-synchronous frames (odd)."""
        return 2 * self.halfwin_max + 1

    @property
    def nfft_spec(self) -> int:
        """FFT size implied by nspec (layer-1 vocal tract grid)."""
        return 2 * (self.nspec - 1)

    @property
    def nfft_noise(self) -> int:
        """FFT size for per-frame noise WOLA segments (window = 2 hops)."""
        return _round_up(2 * self.nhop, 2)

    @property
    def chan_edges(self) -> Tuple[float, ...]:
        """Full channel boundary list, 0 .. fs/2 inclusive."""
        return (0.0,) + tuple(self.chanfreq) + (self.fs / 2.0,)

    def validate(self) -> None:
        if abs(self.thop * self.fs - round(self.thop * self.fs)) >= 1e-6:
            raise ValueError("thop * fs must be an integer number of samples")
        if len(self.chanfreq) != self.nchannel - 1:
            raise ValueError("chanfreq must list nchannel-1 interior boundaries")
        if self.fnyq > self.fs / 2.0:
            raise ValueError("fnyq must not exceed fs / 2")


@dataclasses.dataclass(frozen=True)
class AnalysisOptions:
    """Analysis configuration (reference: llsm.h -> llsm_aoptions).  The
    port runs every value the JAX package accepts: hm_method "czt" or
    "pp" (FFT peak-picking), any hm_passes (Gauss-Seidel re-analysis of
    the residual), hm_correction "deconv" or "none", frame_chunk (the
    projection frame_chunk frames a call), any hm_kernel ("matmul" runs
    the main harmonic pass through the unframed projection kernel), any
    fs_input (layer0.analyze resamples from it), every setting of the
    track denoiser and of track_lowpass_hz, and use_pallas: True runs the
    hand-written CUDA kernels where the JAX package runs its Pallas
    kernels, False (the default, as in the JAX package) its jnp branches
    in plain PyTorch, on the tensors' device."""

    conf: ChunkConf = ChunkConf()
    fs_input: float = 0.0        # input-signal rate if != conf.fs (0 = conf.fs)
    hm_method: str = "czt"       # "czt" | "pp"  (reference: LLSM_AOPTION_HMCZT/HMPP)
    hm_passes: int = 1           # Gauss-Seidel re-analysis passes of the residual
    hm_correction: str = "deconv"
                                 # "deconv" | "none": analytic deconvolution of
                                 # each harmonic's amplitude-track smoothing
                                 # (layer0._deconv_correction)
    f0_refine: bool = True       # refine the supplied F0 from the harmonic fit
    f0_refine_smooth: int = 9    # frames: apply only the moving average of the
                                 # refine correction (0 = raw)
    use_pallas: bool = False     # port: run the hand-written CUDA kernels
                                 # (False: the jnp branches in plain torch)
    hm_kernel: str = "rotation"  # "rotation" | "matmul" projection kernel
    frame_chunk: int = 0         # >0: chunk the projection over frames
    env_decimate: int = 4        # band-envelope analysis decimation D (power of
                                 # two; see layer0._env_decimation)
    env_winsize_hops: int = 4    # envelope fitting window, in hops
    track_denoise: bool = True   # dynamics-adaptive harmonic-track denoiser
    track_denoise_hz: float = 15.0
                                 # slow/fast split frequency of the denoiser
    track_denoise_strength: float = 8.0
                                 # gate threshold in units of the noise floor
    track_denoise_spectral: bool = True
                                 # gate per frame-frequency bin as well
    track_spectral_strength: float = 3.0
                                 # spectral-subtraction factor of that gate
    track_spectral_decimate: int = 4
                                 # frame-axis decimation of the gate's DFTs
    track_lowpass_hz: float = 0.0
                                 # > 0: lowpass each harmonic's aligned complex
                                 # track at this frame-frequency cutoff

    @property
    def fs(self) -> float:
        return self.conf.fs


@dataclasses.dataclass(frozen=True)
class SynthesisOptions:
    """Synthesis configuration (reference: llsm.h -> llsm_soptions)."""

    fs: float = 16000.0          # output sample rate
    noise_seed: int = 0x5eed     # seed of the noise component's torch.Generator
    use_pallas: bool = False     # port: run the hand-written CUDA kernels
                                 # (False: the jnp branches in plain torch)
    noise_idft: str = "matmul"   # band iDFTs as matmuls, or "fft": paired
                                 # inverse FFTs (the reference path)
    pbp_oversample: int = 4      # PbP pulse-spectrum grid oversampling


def _check_fp64(kw: dict) -> None:
    """The kernels are float32: LLSM_FP64=1 refuses them, as the JAX
    package refuses its Mosaic kernels (config.py:291-294, 310-313)."""
    from .fp import FP64
    if FP64 and kw.get("use_pallas"):
        raise ValueError("use_pallas is unavailable under LLSM_FP64=1 "
                         "(the CUDA kernels are float32-only; the float64 "
                         "mode runs the plain branches)")


def create_aoptions(fs: float = 16000.0, **kw) -> AnalysisOptions:
    """Reference-parity constructor (llsm_create_aoptions).  For a rate
    with a non-integral hop the internal rate becomes the nearest rate
    with an integral hop and fs_input records the original one."""
    conf_fields = {f.name for f in dataclasses.fields(ChunkConf)}
    conf_kw = {k: v for k, v in kw.items() if k in conf_fields}
    opt_kw = {k: v for k, v in kw.items() if k not in conf_fields}
    _check_fp64(opt_kw)
    thop = conf_kw.get("thop", ChunkConf.thop)
    fs_input = 0.0
    if abs(thop * fs - round(thop * fs)) > 1e-6:
        fs_internal = max(round(thop * fs), 1) / thop
        fs_input, fs = fs, fs_internal
    if "fnyq" not in conf_kw and fs != 16000.0:
        conf_kw["fnyq"] = fs / 2.0
    conf = ChunkConf(fs=fs, **conf_kw)
    conf.validate()
    return AnalysisOptions(conf=conf, fs_input=fs_input, **opt_kw)


def create_soptions(fs: float = 16000.0, **kw) -> SynthesisOptions:
    """Reference-parity constructor (llsm_create_soptions)."""
    _check_fp64(kw)
    return SynthesisOptions(fs=fs, **kw)
