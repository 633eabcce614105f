"""Work of the analysis' harmonic pass (scope llsm.analyze.harmonic): the
projection of every voiced frame's pitch-synchronous window on its live
harmonics, counted from the shapes and the batch's input F0.

With H = ceil(rel_winsize fs / (2 f0_floor)), each frame n's halfwidth
hw_n = clamp(rel_winsize fs / (2 F0_n), 2, H) spans W_n = 2 ceil(hw_n) + 1
samples, and its live harmonics L_n = #{k <= K : k F0_n < fnyq} (0 when
unvoiced).  A sample's contribution to one harmonic is a real sample
times a unit phasor, accumulated: two multiply-adds, 4 operations.

    ops   = 4 sum_n L_n W_n
    bytes = 4 (2 B nx + B N + 3 B N K)

(the signal and its cycle track read once, F0 read once, the amplitudes,
phases and mask [B, N, K] written once, float32).
"""
import math

import torch


def work(info: dict):
    conf = info["conf"]
    f0 = info["f0"].double()
    B, N = f0.shape
    nx = N * info["nhop"]
    fs, K = conf["fs"], conf["maxnhar"]
    H = math.ceil(conf["rel_winsize"] * fs / (2.0 * conf["f0_floor"]))
    voiced = f0 > 0
    f0s = torch.where(voiced, f0, torch.full_like(f0, 100.0))
    hw = torch.clamp(conf["rel_winsize"] * fs / (2.0 * f0s), 2.0, float(H))
    W = 2.0 * torch.ceil(hw) + 1.0
    k = torch.arange(1, K + 1, dtype=torch.float64)
    live = (voiced[..., None] & (k * f0s[..., None] < conf["fnyq"])).sum(-1)
    ops = 4.0 * float((live * W).sum())
    nbytes = 4.0 * (2 * B * nx + B * N + 3 * B * N * K)
    return ops, nbytes
