"""Streaming runtime of the PyTorch port (counterpart of
libllsm2_tpu/runtime): the native OLA ring, the streaming synthesizer,
block analysis and the multi-stream serving pool."""
from . import native, rtsynth  # noqa: F401
from .rtsynth import RTSynthesizer, stream_chunk  # noqa: F401
