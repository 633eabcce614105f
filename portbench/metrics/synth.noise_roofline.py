"""Share of its roofline of scope 'llsm.synth.noise' (each frame's band
inverse transforms, its overlap-add and envelope modulation): the least
time the card could take for the traced batches
(work/llsm.synth.noise.py: operations over the float32 peak or bytes
over the memory peak, whichever is longer, counted from the shapes and
the live harmonics, not from kernel names) over the scope's device time,
in %. None where the scope ran nothing."""

SCOPE = 'llsm.synth.noise'


def read(t):
    dev = t.scope_s.get(SCOPE)
    least = t.least_s(SCOPE)
    if not dev or least is None:
        return None
    return 100.0 * least / dev
