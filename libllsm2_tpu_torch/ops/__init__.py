"""ops of the PyTorch port (kernels: the hand-written CUDA kernels, in
place of the JAX package's pallas_osc)."""
from . import (f0, filters, harmonics, interp, kernels, lf,  # noqa: F401
               resample, spectral, stft, warp, windows)
