"""Device time a batch of the synthesis' noise part (layer0._synth_noise:
gain, draw, band iDFT, OLA and envelopes): the kernels, copies and
memsets launched in scope 'llsm.synth.noise', summed over the traced
batches, in ms a batch."""

SCOPE = 'llsm.synth.noise'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
