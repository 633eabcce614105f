"""Device time a batch of the noise analysis' band envelopes (their FFTs):
the kernels, copies and memsets launched in scope
'llsm.analyze.noise.envelopes', summed over the traced batches, in ms a
batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.noise.envelopes'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
