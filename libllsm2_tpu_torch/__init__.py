"""libllsm2_tpu_torch: the PyTorch + CUDA port of libllsm2_tpu for NVIDIA
Hopper GPUs.  It imports torch and never jax; the JAX package beside it
is the reference its tests compare against.

Ported so far: the layer-0 round trip analyze -> synthesize with every
option of the JAX package (the library default use_pallas=False runs its
jnp branches in plain PyTorch on the card; use_pallas=True the
hand-written kernels: track denoiser, HMPP peak-picking, Gauss-Seidel
passes, chunked framing, hm_kernel="matmul", noise_idft="fft", odd hops,
11.025 kHz through resampling) and its batched form (analyze_batch,
synthesize_batch), the DSP kit (ops/: filters, stft, the chirp-Z
transform, the instantaneous-frequency detector, interpolation), the
corpus runners (parallel/corpus.py: batched_pipeline, run_corpus and
run_corpus_files from WAV files, with the native loader and the F0
tracker of ops/f0.py), the layer-1 codec (models/layer1.py:
chunk_to_layer1 with or without known tract sections, chunk_to_layer0),
the chunk's phase utilities and the parameter-domain edits
(models/edits.py), pulse-by-pulse synthesis (models/pbp.py:
pbp_synthesize), the frame coder and its quantizer (models/coder.py), the
chunk and coded archives (utils/serialize.py) and the quality metrics
(utils/metrics.py), the streaming runtime (runtime/: the native OLA
ring, RTSynthesizer and stream_chunk, the block analyzer RTAnalyzer and
the multi-stream StreamPool, which coder.decode_frames feeds), the
learned models (models/neural.py, vq.py, acoustic.py: nn.Modules trained
with torch.optim, params_from_jax for the JAX package's weights;
models/abs.py: analysis by synthesis; utils/ttsdata.py: the TTS corpus),
the float64 mode (LLSM_FP64=1, fp.py), the CLI (python -m
libllsm2_tpu_torch.cli), the profiler hooks (utils/profiling.py) and
several devices (parallel/: meshes over torch.distributed ranks,
frame-sharded analysis and synthesis, the data-parallel corpus and pool,
tensor-, pipeline- and expert-parallel training, sharded checkpoints),
with all ten CUDA kernels (ops/kernels.py): everything the JAX package
does.  Entry points run on the card: numpy input goes to "cuda" unless
the caller passes device="cpu".
"""

from .config import (AnalysisOptions, ChunkConf, SynthesisOptions,
                     create_aoptions, create_soptions)
from .container import (Chunk, chunk_from_numpy, chunk_to_numpy,
                        create_chunk, cumulative_cycles, phase_propagate,
                        phase_shift, phase_sync)

__version__ = "0.1.0"

__all__ = [
    "AnalysisOptions", "ChunkConf", "SynthesisOptions",
    "create_aoptions", "create_soptions",
    "Chunk", "chunk_from_numpy", "chunk_to_numpy", "create_chunk",
    "cumulative_cycles", "phase_propagate", "phase_shift", "phase_sync",
    "analyze", "synthesize", "analyze_batch", "synthesize_batch",
]


def analyze(*args, **kw):
    from .models.layer0 import analyze as _a
    return _a(*args, **kw)


def synthesize(*args, **kw):
    from .models.layer0 import synthesize as _s
    return _s(*args, **kw)


def analyze_batch(*args, **kw):
    from .models.layer0 import analyze_batch as _a
    return _a(*args, **kw)


def synthesize_batch(*args, **kw):
    from .models.layer0 import synthesize_batch as _s
    return _s(*args, **kw)
