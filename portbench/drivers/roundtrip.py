"""Driver of the round trip: a batch of utterances from pinned host memory
through the port's public batch analysis and synthesis, its audio back to
pinned host memory, as a corpus script calls the library.

setup(ctx) makes the pool of batches on the device from the seed (the
contours, then the speech) and keeps them in pinned host memory;
batch(ctx, p) runs pool entry p; compare(ctx, kept) runs the plain
reference on the kept rows' inputs and returns the numbers compared.
"""
from __future__ import annotations

from portbench import shared
from portbench.compare import GATE_FIELD

#: the numbers compared: (name, kind, fields), see compare.py and expected()
COMPARED = (("f0", "rel", ("f0",)),
            ("hm_mask", "exact", ("hm_mask",)),
            ("track", "complex", ("track_re", "track_im")),
            ("ampl", "rel_gated", ("ampl",)),
            ("phse", "polar_gated", ("ampl", "phse")),
            ("psd", "rel", ("psd",)),
            ("edc", "rel", ("edc",)),
            ("eenv_a", "rel", ("eenv_a",)),
            ("eenv_p", "polar", ("eenv_a", "eenv_p")),
            ("y_sin", "rel", ("y_sin",)),
            ("y_nos", "rel", ("y_nos",)))
CHUNK_FIELDS = shared.CHUNK_FIELDS
TRACK_FIELDS = ("track_re", "track_im")


def setup(ctx) -> None:
    B, N = shared.setup(ctx)
    tr, conf = ctx.traffic, ctx.cfg["resolved"]["conf"]
    pin = ctx.device.type == "cuda"
    for i in range(int(tr["pool"])):
        g = ctx.gen.generator(ctx.seed, i, ctx.device)
        f0 = ctx.gen.f0_contours(g, B, N, conf["thop"], tr, conf["f0_floor"],
                                 ctx.device)
        x = ctx.gen.speech(g, f0, conf["fs"], ctx.nhop, tr)
        ctx.pool.append({k: v.cpu().pin_memory() if pin else v.cpu()
                         for k, v in (("x", x), ("f0", f0))})
        ctx.work_info.append(shared.work_info(ctx, f0))
        del x, f0
    shared.probe_track(ctx)


def _track(ctx, chunk) -> tuple:
    """The harmonic track (re, im) that the program's analysis of this
    batch handed to its denoiser (shared.probe_track), or NaN where it
    handed none over at the chunk's shape: a stage that never answers."""
    t = ctx.stage.get("track")
    if t is None or tuple(t[0].shape) != tuple(chunk.ampl.shape):
        nan = ctx.torch.full_like(chunk.ampl, float("nan"))
        return nan, nan
    return t


def batch(ctx, p: int) -> dict:
    """One batch: pool entry p's audio and F0 to the card, analyze_batch,
    synthesize_batch, y back to pinned host memory -> the compared
    outputs (device tensors with a leading batch axis)."""
    record = ctx.torch.profiler.record_function
    entry = ctx.pool[p]
    ctx.stage.clear()
    with record("portbench.transfer"):
        x = entry["x"].to(ctx.device, non_blocking=True)
        f0 = entry["f0"].to(ctx.device, non_blocking=True)
    chunk = ctx.port.analyze_batch(ctx.opt, x, f0)
    res = ctx.port.synthesize_batch(ctx.sopt, chunk)
    with record("portbench.transfer"):
        ctx.y_host.copy_(res.y, non_blocking=True)
    out = {k: getattr(chunk, k) for k in CHUNK_FIELDS}
    out.update(zip(TRACK_FIELDS, _track(ctx, chunk)))
    out.update(y_sin=res.y_sin, y_nos=res.y_nos)
    return out


def expected(ctx, p: int, r: int, judged: dict) -> dict:
    """What the judged side's outputs for row r of pool entry p are held
    to, each stage by the float32 reference on the judged side's own
    output of the stage before it (as a served model's tokens are judged
    on its own prefix): f0 the refine of the row's input; hm_mask, track
    the projection and deconvolution from the judged f0; ampl, phse the
    denoiser on the judged track, with the tracks whose gates it finds
    marginal (gate_marginal); psd, edc, eenv_a, eenv_p the noise analysis
    given the judged f0, ampl, phse and mask; y_sin, y_nos the synthesis
    of the judged chunk."""
    ref, cfg = ctx.ref, ctx.cfg["resolved"]
    conf, opt = ref.Conf.from_dict(cfg["conf"]), cfg["analysis"]
    entry = ctx.pool[p]
    x = entry["x"][r:r + 1].to(ctx.device)
    one = {k: judged[k][None] for k in CHUNK_FIELDS + TRACK_FIELDS}
    report = {}
    with ref.precision(False):
        out = {"f0": ref.refine(conf, opt, x,
                                entry["f0"][r:r + 1].to(ctx.device))}
        out.update(ref.harmonic_track(conf, opt, x, one["f0"]))
        out.update(ref.denoise(conf, opt, one["f0"], one["track_re"],
                               one["track_im"], one["hm_mask"], report))
        out[GATE_FIELD] = ref.gate_marginal(report)
        out.update(ref.analyze_noise(conf, opt, x, one["f0"], one["ampl"],
                                     one["phse"], one["hm_mask"]))
        out["y_sin"], out["y_nos"] = ref.synthesize(
            conf, cfg["synthesis"], {k: one[k] for k in CHUNK_FIELDS})
    return {k: v[0] for k, v in out.items()}


def compare(ctx, kept: list) -> dict:
    """The numbers compared over the kept rows."""
    from portbench import compare as cmp
    return cmp.numbers(COMPARED, [(f, expected(ctx, p, r, f))
                                  for _, p, r, f in kept])
