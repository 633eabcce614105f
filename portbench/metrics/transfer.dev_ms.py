"""Device time a batch of the benchmark's copies of each batch's input to
the card and its audio back to pinned host memory: the kernels, copies
and memsets launched in scope 'portbench.transfer', summed over the
traced batches, in ms a batch."""

SCOPE = 'portbench.transfer'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
