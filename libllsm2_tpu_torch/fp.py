"""Working precision of the PyTorch port (counterpart of libllsm2_tpu.fp).

The port runs in float32; the float64 golden-reference mode of the JAX
package is not ported yet.
"""
import torch

#: real working dtype of the numeric core
FP = torch.float32
#: complex working dtype (spectra, analytic signals)
CP = torch.complex64
