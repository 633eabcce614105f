"""Device time a batch of the analysis' F0 refine (harmonics.refine_f0)
and the voicing-masked smoothing of its correction: the kernels, copies
and memsets launched in scope 'llsm.analyze.refine', summed over the
traced batches, in ms a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.refine'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
