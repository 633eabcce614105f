"""Device time a batch of the analysis' noise stage (envelopes, their
projection, periodogram and the glue between them), whole: the kernels,
copies and memsets launched in scope 'llsm.analyze.noise' or in any scope
under it ('llsm.analyze.noise.*'), summed over the traced batches, in ms a
batch; None where they ran nothing."""

SCOPE = 'llsm.analyze.noise'


def read(t):
    s = [v for k, v in t.scope_s.items()
         if k == SCOPE or k.startswith(SCOPE + '.')]
    return 1e3 * sum(s) / t.batches if s else None
