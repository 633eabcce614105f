"""Work of the synthesis' harmonic part (scope llsm.synth.harmonic): the
oscillator bank's live harmonics at every sample of each frame's two-hop
segment, counted from the shapes and the batch's F0.

Each frame n has L_n = #{k <= K : k F0_n < min(fnyq, fs_out / 2)} live
harmonics (0 when unvoiced) and a segment of 2 nhop samples.  Evaluating
a harmonic at a sample takes at least a recurrence step and an
accumulation, two multiply-adds, 4 operations.

    ops   = 4 sum_n L_n 2 nhop
    bytes = 4 (2 B nx + 3 B N K)

(the cycle track read and y_sin written once, the amplitudes, phases and
mask [B, N, K] read once, float32).
"""
import torch


def work(info: dict):
    conf = info["conf"]
    f0 = info["f0"].double()
    B, N = f0.shape
    nhop = info["nhop"]
    nx = N * nhop
    K = conf["maxnhar"]
    top = min(conf["fnyq"], info["synth_fs"] / 2.0)
    k = torch.arange(1, K + 1, dtype=torch.float64)
    live = ((f0[..., None] > 0) & (k * f0[..., None] < top)).sum(-1)
    ops = 4.0 * float(live.sum()) * 2 * nhop
    nbytes = 4.0 * (2 * B * nx + 3 * B * N * K)
    return ops, nbytes
