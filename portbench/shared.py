"""What the drivers share: the port's options for a configuration,
checked against the configuration as it is run, what the work counts
(work/<scope>.py) read of a batch, and the probe that keeps the harmonic
track the program's analysis hands to its denoiser."""
from __future__ import annotations

import dataclasses
import functools
import importlib
import inspect

#: a chunk's fields, as the port's Chunk and the reference name them
CHUNK_FIELDS = ("f0", "ampl", "phse", "hm_mask", "psd", "edc", "eenv_a",
                "eenv_p")
#: the program's stage whose input the round trip's check judges: the
#: function (module of the port, name) that the analysis hands its
#: deconvolved complex harmonic track to, and the argument that holds it
TRACK_STAGE = ("models.layer0", "_track_denoise", "c_complex")


def port_options(ctx):
    """The port's options from the configuration's call, checked against
    the configuration as it is run (its "resolved" values)."""
    cfg = ctx.cfg
    opt = ctx.port.create_aoptions(**cfg["analysis"])
    sopt = ctx.port.create_soptions(**cfg["synthesis"])
    conf = dataclasses.asdict(opt.conf)
    conf["chanfreq"] = list(conf["chanfreq"])
    got = {"conf": conf,
           "analysis": {k: v for k, v in dataclasses.asdict(opt).items()
                        if k != "conf"},
           "synthesis": dataclasses.asdict(sopt)}
    if got != cfg["resolved"]:
        raise SystemExit(f"{cfg['name']}: the port's options {got} differ "
                         f"from the configuration's {cfg['resolved']}")
    return opt, sopt


def work_info(ctx, f0) -> dict:
    """What work/<scope>.py counts from: the configuration, the hop, the
    synthesis rate and the batch's F0 [B, N] (on the host)."""
    return dict(conf=ctx.cfg["resolved"]["conf"], f0=f0.float().cpu(),
                nhop=ctx.nhop,
                synth_fs=ctx.cfg["resolved"]["synthesis"]["fs"])


def setup(ctx):
    """The set-up both drivers share: the options, the batch's shape and
    audio seconds, an empty pool and the pinned host buffer of a batch's
    audio -> (rows B, frames N)."""
    torch = ctx.torch
    ctx.opt, ctx.sopt = port_options(ctx)
    conf, tr = ctx.cfg["resolved"]["conf"], ctx.traffic
    ctx.nhop = ctx.opt.conf.nhop
    B = ctx.rows = int(tr["rows"])
    N = int(round(tr["seconds_per_row"] / conf["thop"]))
    ctx.audio_s_batch = B * N * conf["thop"]
    ctx.pool, ctx.work_info = [], []
    ctx.y_host = torch.empty((B, N * ctx.nhop), dtype=torch.float32,
                             pin_memory=ctx.device.type == "cuda")
    return B, N


def probe_track(ctx) -> None:
    """Keep in ctx.stage["track"] the harmonic track (re, im) that each
    analysis of the program hands to its track denoiser (TRACK_STAGE), as
    the timed path makes it: the function is wrapped and called as it
    was, and the wrapper keeps a reference to its argument, with no work
    on the device.  A wrapper left by an earlier set-up is replaced."""
    mod = importlib.import_module(f"{ctx.port.__name__}.{TRACK_STAGE[0]}")
    real = inspect.unwrap(getattr(mod, TRACK_STAGE[1]))
    stage = ctx.stage = {}

    @functools.wraps(real)
    def kept(*args, **kw):
        stage["track"] = kw.get(TRACK_STAGE[2])
        return real(*args, **kw)
    setattr(mod, TRACK_STAGE[1], kept)
