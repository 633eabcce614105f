"""Device time a batch of the residual stage's amplitude-track
deconvolution (deconv_full): the kernels, copies and memsets launched in
scope 'llsm.analyze.residual.deconv', summed over the traced batches, in
ms a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.residual.deconv'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
