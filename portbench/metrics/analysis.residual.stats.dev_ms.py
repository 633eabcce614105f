"""Device time a batch of the track denoiser's first pass (denoise_stats)
and the raw track's power: the kernels, copies and memsets launched in
scope 'llsm.analyze.residual.stats', summed over the traced batches, in ms
a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.residual.stats'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
