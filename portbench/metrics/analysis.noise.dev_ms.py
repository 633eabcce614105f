"""Device time a batch of the analysis' noise pass: band envelopes, their
projection, the warped periodogram: the kernels, copies and memsets
launched in scope 'llsm.analyze.noise', summed over the traced batches,
in ms a batch."""

SCOPE = 'llsm.analyze.noise'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
