"""Device time a batch of the noise analysis' envelope projection
(harmonic_analysis at K = Ke): the kernels, copies and memsets launched in
scope 'llsm.analyze.noise.project', summed over the traced batches, in ms
a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.noise.project'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
