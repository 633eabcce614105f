"""The benchmark of libllsm2_tpu_torch on the H100 (see run.py)."""
