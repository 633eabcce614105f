"""The port's spans (utils/profiling.named_scope) and the benchmark's
readers of them (portbench/metrics/), on the CPU: a profiled round trip
with the speech16k options (the kernels' CPU twins, the spectral gate's
DFT products at D = 4 and its FFTs at D = 1) opens every span inside its
parent and none inside a stage a roofline reads; the benchmark's probe of
the denoiser's track keeps them; each metric reads its span's device ms
a batch, None where it is absent, and the stage totals sum the stage and
its prefix; named_scope enters record_function only under a profiler."""
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import libllsm2_tpu_torch as port
from libllsm2_tpu_torch import create_aoptions, create_soptions
from libllsm2_tpu_torch.models import layer0
from libllsm2_tpu_torch.utils import profiling, testsig

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from portbench import harness, shared  # noqa: E402

torch.set_num_threads(1)

R = "llsm.analyze.residual"
N = "llsm.analyze.noise"
#: each span and its parent (None: a top-level span)
SPANS = {
    "llsm.analyze.refine": None,
    "llsm.cycles": None,
    f"{R}.deconv": R,
    f"{R}.stats": R,
    f"{R}.floor": R,
    f"{R}.apply": R,
    f"{R}.gate": R,
    f"{R}.gate.dft": f"{R}.gate",
    f"{R}.render": R,
    f"{N}.envelopes": N,
    f"{N}.project": N,
    f"{N}.psd": N,
}
#: stages whose roofline counts the whole stage: no span inside them
ROOFLINE_STAGES = ("llsm.analyze.harmonic", "llsm.synth.harmonic",
                   "llsm.synth.noise")


def _round_trip_ranges(decimate: int, probe: bool = False,
                       monkeypatch=None):
    """A profiled analyze_batch -> synthesize_batch of two short rows with
    the speech16k options (npsd and maxnhar cut for the CPU) -> the llsm.*
    ranges [(name, start, end)] and, with probe, the probe's ctx."""
    x0, f00 = testsig.make_test_utterance(duration=0.3, seed=1)
    x1, f01 = testsig.make_test_utterance(duration=0.3, seed=2)
    n = min(len(f00), len(f01))
    opt = create_aoptions(fs=16000.0, f0_floor=70.0, use_pallas=True,
                          npsd=32, maxnhar=24,
                          track_spectral_decimate=decimate)
    sopt = create_soptions(fs=16000.0, use_pallas=True)
    nx = n * opt.conf.nhop
    x = torch.as_tensor(np.stack([x0[:nx], x1[:nx]]))
    f0 = torch.as_tensor(np.stack([f00[:n], f01[:n]]))
    ctx = None
    if probe:
        monkeypatch.setattr(layer0, "_track_denoise", layer0._track_denoise)
        ctx = SimpleNamespace(port=port)
        shared.probe_track(ctx)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        port.synthesize_batch(sopt, port.analyze_batch(opt, x, f0,
                                                       device="cpu"))
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("llsm.")]
    return ranges, ctx


@pytest.fixture(scope="module", params=[4, 1], ids=["D4", "D1"])
def ranges(request):
    return _round_trip_ranges(request.param)[0]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("span", sorted(SPANS))
def test_span_opens_inside_its_parent(ranges, span):
    mine = [r for r in ranges if r[0] == span]
    assert mine, span
    parent = SPANS[span]
    if parent is not None:
        for r in mine:
            assert any(_inside(r, p) for p in ranges if p[0] == parent), r


@pytest.mark.parametrize("stage", ROOFLINE_STAGES)
def test_no_span_inside_a_roofline_stage(ranges, stage):
    outer = [r for r in ranges if r[0] == stage]
    assert outer
    for s in outer:
        assert [r for r in ranges if r != s and _inside(r, s)] == []


def test_gate_dft_runs_twice_a_gate(ranges):
    """The gate's forward transforms and its inverse: two ranges a gate;
    the finish is a second range of apply."""
    count = lambda name: sum(r[0] == name for r in ranges)
    assert count(f"{R}.gate.dft") == 2 * count(f"{R}.gate") == 2
    assert count(f"{R}.apply") == 2


def test_spans_survive_the_track_probe(monkeypatch):
    """shared.probe_track wraps layer0._track_denoise: the denoiser's
    spans still open inside the residual stage and the probe keeps the
    complex track handed to it."""
    ranges, ctx = _round_trip_ranges(4, probe=True, monkeypatch=monkeypatch)
    track = ctx.stage["track"]
    assert track is not None and track[0].shape[0] == 2
    assert torch.is_tensor(track[0]) and torch.is_tensor(track[1])
    for span in (f"{R}.stats", f"{R}.floor", f"{R}.apply", f"{R}.gate",
                 f"{R}.gate.dft"):
        mine = [r for r in ranges if r[0] == span]
        assert mine and all(any(_inside(r, p) for p in ranges
                                if p[0] == SPANS[span]) for r in mine), span


# --------------------------------------------------------------------------
# the benchmark's readers of the spans
# --------------------------------------------------------------------------

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
#: metric -> the scope it reads (totals: the stage)
READS = {
    "analysis.refine.dev_ms": "llsm.analyze.refine",
    "cycles.dev_ms": "llsm.cycles",
    "analysis.residual.deconv.dev_ms": f"{R}.deconv",
    "analysis.residual.stats.dev_ms": f"{R}.stats",
    "analysis.residual.floor.dev_ms": f"{R}.floor",
    "analysis.residual.apply.dev_ms": f"{R}.apply",
    "analysis.residual.gate.dev_ms": f"{R}.gate",
    "analysis.residual.gate_dft.dev_ms": f"{R}.gate.dft",
    "analysis.residual.render.dev_ms": f"{R}.render",
    "analysis.noise.envelopes.dev_ms": f"{N}.envelopes",
    "analysis.noise.project.dev_ms": f"{N}.project",
    "analysis.noise.psd.dev_ms": f"{N}.psd",
}
TOTALS = {"analysis.residual.total_ms": R, "analysis.noise.total_ms": N}


def _summary(scope_s, batches=4):
    return SimpleNamespace(scope_s=scope_s, batches=batches)


@pytest.mark.parametrize("name", sorted(READS))
def test_span_metric_reads_ms_a_batch(name):
    read = harness.reader("metrics", name).read
    scope = READS[name]
    others = {f"{scope}.child": 9.0, R: 5.0, "unscoped": 7.0}
    others.pop(scope, None)
    assert math.isclose(read(_summary({scope: 0.012, **others})), 3.0)
    assert read(_summary(others)) is None


@pytest.mark.parametrize("name", sorted(TOTALS))
def test_stage_total_sums_the_stage_and_its_prefix(name):
    read = harness.reader("metrics", name).read
    stage = TOTALS[name]
    s = {stage: 0.004, f"{stage}.a": 0.002, f"{stage}.a.b": 0.001,
         stage + "x": 5.0, "llsm.analyze.harmonic": 5.0, "unscoped": 5.0}
    assert read(_summary(s, batches=2)) == 1e3 * (0.004 + 0.002 + 0.001) / 2
    assert math.isclose(read(_summary({f"{stage}.a": 0.002}, 2)), 1.0)
    assert read(_summary({"unscoped": 1.0, stage + "x": 1.0})) is None


@pytest.mark.parametrize("name", sorted(READS) + sorted(TOTALS))
def test_span_metric_is_declared(name):
    """Each reader has its per_layer entry: device_trace, moving
    throughput, in the round trips (cycles in every cell)."""
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    rt = ["speech16k.roundtrip", "fullband48k.roundtrip"]
    assert m["source"] == "device_trace" and m["moves"] == "throughput"
    assert m["unit"] == "ms/batch" and m["better"] == "lower"
    assert m["workloads"] == (rt + ["speech16k.synth"]
                              if name == "cycles.dev_ms" else rt)


# --------------------------------------------------------------------------
# named_scope off and on
# --------------------------------------------------------------------------

def test_named_scope_enters_no_record_function_without_a_profiler(
        monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    with profiling.named_scope("llsm.test"):
        pass
    assert entered == []


def test_named_scope_records_under_a_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.named_scope("llsm.test.outer"):
            with profiling.named_scope("llsm.test.inner"):
                torch.ones(4).sum()
    ev = {e.name: e.time_range for e in prof.events()}
    assert {"llsm.test.outer", "llsm.test.inner"} <= set(ev)
    inner, outer = ev["llsm.test.inner"], ev["llsm.test.outer"]
    assert outer.start <= inner.start and inner.end <= outer.end
