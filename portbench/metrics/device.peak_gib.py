"""The card's peak allocated memory over the window
(torch.cuda.max_memory_allocated, reset at the window's start), in GiB."""


def read(t):
    return t.peak_bytes / 2 ** 30 if t.peak_bytes else None
