"""Kernels in the trace a batch: every kernel launched inside the traced
batches (the port's own and PyTorch's), over their count; the host's
dispatch work grows with it."""


def read(t):
    return t.kernels / t.batches
