"""Audio seconds of all batches completed in the window over the
window's length (host clock, from the first batch's start to the last
one's end)."""


def read(run) -> float:
    return run.audio_s / run.window_s
