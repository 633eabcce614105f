"""Device time a batch of the analysis' residual stage (deconvolution,
denoiser, gate, render and the glue between them), whole: the kernels,
copies and memsets launched in scope 'llsm.analyze.residual' or in any
scope under it ('llsm.analyze.residual.*'), summed over the traced
batches, in ms a batch; None where they ran nothing."""

SCOPE = 'llsm.analyze.residual'


def read(t):
    s = [v for k, v in t.scope_s.items()
         if k == SCOPE or k.startswith(SCOPE + '.')]
    return 1e3 * sum(s) / t.batches if s else None
