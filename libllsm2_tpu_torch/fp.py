"""Working precision of the PyTorch port (counterpart of libllsm2_tpu.fp).

Set ``LLSM_FP64=1`` in the environment BEFORE importing libllsm2_tpu_torch
to run the numeric core in float64 (the C library's FP_TYPE=double build;
the JAX package's golden-reference mode).  The knob is read once, at
import.  Under it the hand-written kernels, which are float32, are refused
(create_aoptions / create_soptions raise on use_pallas=True, and every
kernel wrapper raises on float64 card tensors), and the plain branches run
in float64 on the tensors' device -- the card by default: unlike the TPU,
the H100 has float64 units.  The cycle track and the noise draw, which
launch kernels under either setting in float32, then run their plain
versions (kernels.sample_cycles_ref; kernels.noise_bins_ref draws JAX's
x64 normals bit for bit).  The default, float32, is unaffected.
"""
import os

import torch

FP64: bool = os.environ.get("LLSM_FP64", "0") not in ("", "0")

#: real working dtype of the numeric core (FP_TYPE analog)
FP = torch.float64 if FP64 else torch.float32
#: complex working dtype (spectra, analytic signals)
CP = torch.complex128 if FP64 else torch.complex64
