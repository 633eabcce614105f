"""Device time a batch of the spectral gate's glue (its noise profile,
Winsorizing, moving average, engagement and FIR blend): the kernels,
copies and memsets launched in scope 'llsm.analyze.residual.gate' and in
none of its child scopes, summed over the traced batches, in ms a batch;
None where it ran nothing."""

SCOPE = 'llsm.analyze.residual.gate'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
