"""Process start to window start (host clock): imports, the CUDA
context, the kernel library, the inputs made on the device, warm-up."""


def read(run) -> float:
    return run.setup_s
