"""Device time a batch of the noise analysis' warped periodogram (its band
matrix, window, FFTs and band product): the kernels, copies and memsets
launched in scope 'llsm.analyze.noise.psd', summed over the traced
batches, in ms a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.noise.psd'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
