"""Device time a batch of the track denoiser's per-utterance floor
statistics (its frame sums): the kernels, copies and memsets launched in
scope 'llsm.analyze.residual.floor', summed over the traced batches, in ms
a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.residual.floor'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
