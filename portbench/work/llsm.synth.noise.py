"""Work of the synthesis' noise part (scope llsm.synth.noise): each
frame's shaped spectrum, its bands' inverse transforms of T = 2 nhop
points, their overlap-add and envelope modulation, from the shapes.

A frame's nbin = nhop + 1 bins are shaped (a complex product, 4
operations a bin); its C bands' real inverse transforms take at least
those of ceil(C / 2) complex FFTs of T points (two real bands a
transform), 5 T log2 T operations each; every output sample of every
band adds its two segments, renders its envelope from the DC and Ke
harmonics (Ke + 1 multiply-adds) and is modulated and summed (3).

    ops   = B N (4 nbin + ceil(C / 2) 5 T log2 T) + B nx C (2 (Ke + 1) + 3)
    bytes = 4 (B N npsd + B N C (1 + 2 Ke) + 2 B nx)

(the PSD, the band DC and envelope harmonics read once, the cycle track
read and y_nos written once, float32; the noise is drawn, not read).
"""
import math


def work(info: dict):
    conf = info["conf"]
    B, N = info["f0"].shape
    nhop = info["nhop"]
    nx = N * nhop
    T = 2 * nhop
    nbin = nhop + 1
    C, Ke, npsd = conf["nchannel"], conf["maxnhar_e"], conf["npsd"]
    ops = B * N * (4 * nbin + math.ceil(C / 2) * 5 * T * math.log2(T)) \
        + B * nx * C * (2 * (Ke + 1) + 3)
    nbytes = 4.0 * (B * N * npsd + B * N * C * (1 + 2 * Ke) + 2 * B * nx)
    return float(ops), nbytes
