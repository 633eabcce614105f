"""Device time a batch of the analysis' harmonic pass (layer0._analyze, the
projection): the kernels, copies and memsets launched in scope
'llsm.analyze.harmonic', summed over the traced batches, in ms a batch."""

SCOPE = 'llsm.analyze.harmonic'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
