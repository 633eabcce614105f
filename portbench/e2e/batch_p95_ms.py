"""The 95th percentile (linear interpolation) of every batch's latency in
the window: from the start of its input copy to its output on the host,
timed by CUDA events in the stream."""
import numpy as np


def read(run) -> float:
    return float(np.percentile(np.asarray(run.latencies_ms), 95.0))
