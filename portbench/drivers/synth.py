"""Driver of synthesis from parameters: a batch of chunks, made on the
device from the seed as a TTS or voice-conversion model would hand them
over, through the port's public batch synthesis, its audio back to
pinned host memory.  Nothing comes from the port's analysis.

setup(ctx) makes the pool of chunks on the device; batch(ctx, p) runs
pool entry p; compare(ctx, kept) runs the plain reference on the kept
rows' parameters and returns the numbers compared.
"""
from __future__ import annotations

from portbench import shared

#: the numbers compared: (name, kind, fields), see compare.py
COMPARED = (("y_sin", "rel", ("y_sin",)),
            ("y_nos", "rel", ("y_nos",)))
FIELDS = shared.CHUNK_FIELDS


def setup(ctx) -> None:
    B, N = shared.setup(ctx)
    tr, conf = ctx.traffic, ctx.cfg["resolved"]["conf"]
    for i in range(int(tr["pool"])):
        g = ctx.gen.generator(ctx.seed, i, ctx.device)
        f0 = ctx.gen.f0_contours(g, B, N, conf["thop"], tr, conf["f0_floor"],
                                 ctx.device)
        fields = ctx.gen.chunk_fields(g, f0, conf, tr)
        ctx.pool.append(ctx.port.Chunk(conf=ctx.opt.conf, **fields))
        ctx.work_info.append(shared.work_info(ctx, f0))


def batch(ctx, p: int) -> dict:
    """One batch: synthesize_batch on pool entry p, y back to pinned host
    memory -> the compared outputs (device tensors)."""
    res = ctx.port.synthesize_batch(ctx.sopt, ctx.pool[p])
    with ctx.torch.profiler.record_function("portbench.transfer"):
        ctx.y_host.copy_(res.y, non_blocking=True)
    return {"y_sin": res.y_sin, "y_nos": res.y_nos}


def expected(ctx, p: int, r: int, judged: dict) -> dict:
    """What the judged side's synthesis of row r of pool entry p is held
    to: the float32 reference's synthesis of the same parameters."""
    ref, cfg = ctx.ref, ctx.cfg["resolved"]
    chunk = {k: getattr(ctx.pool[p], k)[r:r + 1] for k in FIELDS}
    with ref.precision(False):
        y_sin, y_nos = ref.synthesize(ref.Conf.from_dict(cfg["conf"]),
                                      cfg["synthesis"], chunk)
    return {"y_sin": y_sin[0], "y_nos": y_nos[0]}


def compare(ctx, kept: list) -> dict:
    """The numbers compared over the kept rows."""
    from portbench import compare as cmp
    return cmp.numbers(COMPARED, [(f, expected(ctx, p, r, f))
                                  for _, p, r, f in kept])
