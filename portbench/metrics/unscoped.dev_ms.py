"""Device time a batch of work of a batch in no scope: the F0 refine, the
cycle tracks, the synthesis' harmonic mask, the glue between scopes: the
kernels, copies and memsets launched in scope 'unscoped', summed over
the traced batches, in ms a batch."""

SCOPE = 'unscoped'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
