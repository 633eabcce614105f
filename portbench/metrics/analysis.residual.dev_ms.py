"""Device time a batch of the analysis' residual stage: the deconvolution,
the track denoiser and its spectral gate, the residual render: the
kernels, copies and memsets launched in scope 'llsm.analyze.residual',
summed over the traced batches, in ms a batch."""

SCOPE = 'llsm.analyze.residual'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
