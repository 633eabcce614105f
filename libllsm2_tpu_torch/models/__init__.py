"""models of the PyTorch port."""
from . import abs, coder, edits, layer0, layer1, pbp  # noqa: F401
from .abs import abs_refine  # noqa: F401
from .layer0 import SynthResult, analyze, synthesize  # noqa: F401
from .layer1 import chunk_to_layer0, chunk_to_layer1  # noqa: F401
from .pbp import pbp_synthesize  # noqa: F401
