"""Device time a batch of the residual render (the residual's oscillator
bank, osc_bank): the kernels, copies and memsets launched in scope
'llsm.analyze.residual.render', summed over the traced batches, in ms a
batch; None where it ran nothing."""

SCOPE = 'llsm.analyze.residual.render'


def read(t):
    s = t.scope_s.get(SCOPE)
    return None if s is None else 1e3 * s / t.batches
