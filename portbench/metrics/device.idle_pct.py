"""Share of the traced window (first batch's start to last batch's end) in
which no kernel, copy or memset ran on the card, in %."""


def read(t):
    if t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
