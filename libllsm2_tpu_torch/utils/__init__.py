"""Framework-neutral helpers of the PyTorch port."""
from . import (audio, dataio, metrics, plotting,  # noqa: F401
               profiling, serialize, testsig)
