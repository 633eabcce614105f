"""Device time a batch of the cycle tracks (harmonics.sample_cycles) of
the analysis and the synthesis: the kernels, copies and memsets launched
in scope 'llsm.cycles', summed over the traced batches, in ms a batch;
None where it ran nothing."""

SCOPE = 'llsm.cycles'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
