"""libllsm2_tpu_torch: the PyTorch + CUDA port of libllsm2_tpu for NVIDIA
Hopper GPUs.  It imports torch and never jax; the JAX package beside it
is the reference its tests compare against.

Ported so far: the layer-0 round trip analyze -> synthesize with the
track denoiser off (AnalysisOptions(track_denoise=False, use_pallas=True),
SynthesisOptions(use_pallas=True)), its four CUDA kernels
(ops/kernels.py) and the batched pipeline (parallel/corpus.py).
"""

from .config import (AnalysisOptions, ChunkConf, SynthesisOptions,
                     create_aoptions, create_soptions)
from .container import Chunk, chunk_from_numpy, chunk_to_numpy

__version__ = "0.1.0"

__all__ = [
    "AnalysisOptions", "ChunkConf", "SynthesisOptions",
    "create_aoptions", "create_soptions",
    "Chunk", "chunk_from_numpy", "chunk_to_numpy",
    "analyze", "synthesize",
]


def analyze(*args, **kw):
    from .models.layer0 import analyze as _a
    return _a(*args, **kw)


def synthesize(*args, **kw):
    from .models.layer0 import synthesize as _s
    return _s(*args, **kw)
