"""Device time a batch of the spectral gate's transforms (its grouped DFT
products, or FFTs at D = 1): the kernels, copies and memsets launched in
scope 'llsm.analyze.residual.gate.dft', summed over the traced batches, in
ms a batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.residual.gate.dft'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
