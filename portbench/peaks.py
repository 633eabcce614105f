"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit): the yardstick of every roofline share."""

#: float32 operations a second outside the tensor cores
FP32_FLOPS = 67e12
#: HBM3 bytes a second
HBM_BYTES_S = 3.35e12
