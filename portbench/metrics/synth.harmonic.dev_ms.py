"""Device time a batch of the synthesis' harmonic part (layer0._synthesize,
the oscillator bank): the kernels, copies and memsets launched in scope
'llsm.synth.harmonic', summed over the traced batches, in ms a batch."""

SCOPE = 'llsm.synth.harmonic'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
