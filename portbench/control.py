"""The control of a cell's check: the plain reference, computed with its
matrix products in TF32 (the precision below the configurations' float32
with TF32 off), put in the program's place, so that a run of the cell
through harness.run comes out not correct.

hook(ctx) is a ctx_hook of harness.run: it wraps the port so that every
row that the run's sample can keep (harness.Sample with the run's seed)
comes from the reference in TF32, each stage on the last one's output,
while the rest of each batch is the program's, at the cell's own size
and load.  The benchmark's own runs do not run it; the tests do
(tests/test_portbench_harness.py: on the CPU at a small size, on a card
at the cell's size).
"""
from __future__ import annotations

from portbench import harness, shared


class ControlPort:
    """The port, with the sampled rows of each analysis and synthesis
    replaced by the reference's in TF32."""

    def __init__(self, ctx, rows: list):
        self._ctx, self._port, self._rows = ctx, ctx.port, rows
        cfg = ctx.cfg["resolved"]
        self._conf = ctx.ref.Conf.from_dict(cfg["conf"])
        self._aopt, self._sopt = cfg["analysis"], cfg["synthesis"]

    def __getattr__(self, k):
        return getattr(self._port, k)

    def analyze_batch(self, opt, x, f0, device=None):
        ref, ctx = self._ctx.ref, self._ctx
        ch = self._port.analyze_batch(opt, x, f0, device=device)
        fields = {k: getattr(ch, k).clone() for k in shared.CHUNK_FIELDS}
        track = [t.clone() for t in ctx.stage["track"]]
        with ref.precision(True):
            for r in self._rows:
                out = ref.analyze(self._conf, self._aopt, x[r:r + 1],
                                  f0[r:r + 1])
                for k in fields:
                    fields[k][r] = out[k][0]
                track[0][r], track[1][r] = out["track_re"][0], \
                    out["track_im"][0]
        ctx.stage["track"] = tuple(track)
        return self._port.Chunk(conf=ch.conf, **fields)

    def synthesize_batch(self, sopt, chunk):
        ref = self._ctx.ref
        res = self._port.synthesize_batch(sopt, chunk)
        y_sin, y_nos = res.y_sin.clone(), res.y_nos.clone()
        with ref.precision(True):
            for r in self._rows:
                one = {k: getattr(chunk, k)[r:r + 1]
                       for k in shared.CHUNK_FIELDS}
                a, b = ref.synthesize(self._conf, self._sopt, one)
                y_sin[r], y_nos[r] = a[0], b[0]
        return res._replace(y=y_sin + y_nos, y_sin=y_sin, y_nos=y_nos)


def hook(ctx) -> None:
    """harness.run's ctx_hook: the control in the program's place."""
    s = harness.Sample(ctx.seed, int(ctx.traffic["compare_rows"]), ctx.rows)
    ctx.port = ControlPort(ctx, sorted({s.row(i) for i in range(s.size)}))
