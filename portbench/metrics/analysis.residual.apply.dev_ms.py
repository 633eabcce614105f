"""Device time a batch of the track denoiser's second pass (denoise_apply)
and its finish (denoise_finish): the kernels, copies and memsets launched
in scope 'llsm.analyze.residual.apply', summed over the traced batches, in
ms a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.residual.apply'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
