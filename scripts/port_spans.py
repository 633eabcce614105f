"""The cost of the port's spans (utils/profiling.named_scope) and what one
traced batch of a benchmark cell shows through them:

1. one span's host cost with CUDA initialized (so its NVTX range too),
   with no profiler and under torch.profiler (CPU and CUDA activities):
   a loop of `reps` empty spans, the median of 5 rounds, in us a span;
   with parent=DIR, DIR's named_scope beside it;
2. for each cell (portbench's, at its size), after its set-up and warm-up
   batches, one batch profiled as portbench/harness.py profiles the
   window's: the llsm.* spans it opened and what they cost it with the
   profiler off and on (count x cost), the device ms by scope
   (portbench/trace.summarize), and each idle gap of the device inside
   the batch put down to the innermost llsm.* span open on the batch's
   host thread at the gap's start, read from the raw Chrome trace (the
   innermost host operation there beside it).

Writes out= (default build/dev/spans.json) and prints a summary.
Imports neither jax nor libllsm2_tpu; the cells need a CUDA card:

    python scripts/port_spans.py [cells=speech16k.roundtrip,...]
        [parent=DIR] [reps=20000] [seed=N] [device=cuda] [out=PATH]
        [rows=R seconds_per_row=S]     (a cut traffic: a CPU rehearsal)
"""
import contextlib
import importlib
import json
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from libllsm2_tpu_torch.utils import profiling  # noqa: E402
from portbench import harness, trace  # noqa: E402

ROUNDS = 5


def span_us(named_scope, reps: int) -> float:
    """Median over ROUNDS of a loop of `reps` empty spans, us a span."""
    out = []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(reps):
            with named_scope("llsm.cost"):
                pass
        out.append(1e6 * (time.perf_counter() - t0) / reps)
    return statistics.median(out)


def activities(cuda: bool) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def span_costs(scopes: dict, reps: int, cuda: bool) -> dict:
    """{label: {"off": us, "on": us}} for each named_scope of scopes."""
    out = {}
    for label, ns in scopes.items():
        off = span_us(ns, reps)
        with torch.profiler.profile(activities=activities(cuda)):
            on = span_us(ns, max(reps // 4, 1))
        out[label] = {"off": off, "on": on}
    return out


def idle_gaps(events: list) -> list:
    """Each idle gap of the device inside the traced batches ->
    [[start offset ms, length ms, innermost llsm.* span open on the
    batch's host thread at the gap's start, innermost host op there]],
    longest first."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    batches = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in xs
                     if e.get("cat") == "user_annotation"
                     and e["name"] == trace.BATCH)
    w0, w1, tid = batches[0][0], max(b[1] for b in batches), batches[0][2]
    spans, host, launch = [], [], {}
    for e in xs:
        cat = e.get("cat")
        if e["tid"] == tid and cat == "user_annotation" \
                and e["name"].startswith("llsm."):
            spans.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if e["tid"] == tid and cat in trace.HOST_CATS \
                and cat != "user_annotation":
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if cat in trace.LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    spans.sort()
    host.sort()
    busy = []
    for e in xs:
        lt = launch.get(e.get("args", {}).get("correlation"))
        if e.get("cat") in trace.DEVICE_CATS and lt is not None \
                and any(b[0] <= lt < b[1] for b in batches):
            busy.append((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)))
    gaps, prev = [], w0
    for s, e in trace._union([b for b in busy if b[1] > b[0]]) + [[w1, w1]]:
        if s > prev:
            gaps.append([1e-3 * (prev - w0), 1e-3 * (s - prev),
                         trace._innermost(spans, prev) or "no llsm span",
                         trace._innermost(host, prev) or "no host op"])
        prev = max(prev, e)
    return sorted(gaps, key=lambda g: -g[1])


def traced_batch(name: str, seed: int, device: str, cut: dict) -> dict:
    """Set up cell `name` as harness.run does, warm it up, profile one
    batch -> its spans, device ms by scope and idle gaps."""
    import libllsm2_tpu_torch as port
    from portbench import gen
    from portbench.reference import llsm_ref as ref
    torch.set_num_threads(harness.THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.resolve(name)
    cell.traffic = dict(cell.traffic, **cut)
    ctx = SimpleNamespace(cfg=cell.config, traffic=cell.traffic, seed=seed,
                          device=torch.device(device), port=port, gen=gen,
                          ref=ref, torch=torch)
    cell.driver.setup(ctx)
    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    npool = len(ctx.pool)
    for j in range(int(cell.traffic["warmup_batches"])):
        cell.driver.batch(ctx, j % npool)
    sync()
    path = os.path.join(tempfile.mkdtemp(prefix="port-spans-"), "t.json")
    prof = torch.profiler.profile(
        activities=activities(cuda),
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                         repeat=1),
        on_trace_ready=lambda p: p.export_chrome_trace(path))
    prof.start()
    for j in range(2):
        with torch.profiler.record_function(trace.BATCH):
            out = cell.driver.batch(ctx, j % npool)
        sync()
        del out
        prof.step()
    prof.stop()
    events = trace.load(path)
    os.remove(path)
    os.rmdir(os.path.dirname(path))
    summ = trace.summarize(events)
    spans = defaultdict(int)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                and e["name"].startswith("llsm."):
            spans[e["name"]] += 1
    gaps = idle_gaps(events)
    by_span = defaultdict(float)
    for g in gaps:
        by_span[g[2]] += g[1]
    del ctx
    if cuda:
        torch.cuda.empty_cache()
    return {"batches": summ["batches"], "window_ms": 1e3 * summ["window_s"],
            "busy_ms": 1e3 * summ["busy_s"],
            "scope_ms": {k: 1e3 * v / summ["batches"]
                         for k, v in sorted(summ["scope_s"].items())},
            "spans": dict(sorted(spans.items())),
            "gap_ms_by_span": dict(sorted(by_span.items(),
                                          key=lambda kv: -kv[1])),
            "gaps": gaps[:25]}


def main():
    kw = dict(a.split("=", 1) for a in sys.argv[1:])
    cells = [c for c in kw.get("cells", "speech16k.roundtrip,"
                               "fullband48k.roundtrip").split(",") if c]
    reps = int(kw.get("reps", 20000))
    seed = int(kw.get("seed", 2 ** 31 + 3217))
    device = kw.get("device", "cuda")
    out_path = kw.get("out", "build/dev/spans.json")
    cut = {k: float(kw[k]) if k == "seconds_per_row" else int(kw[k])
           for k in ("rows", "seconds_per_row") if k in kw}
    cuda = device == "cuda"
    if cuda:
        torch.zeros(1, device="cuda")
    scopes = {"named_scope": profiling.named_scope,
              "nullcontext": lambda name: contextlib.nullcontext()}
    if "parent" in kw:
        sys.path.insert(0, str(REPO / "scripts"))
        import port_harness
        port_harness.load(Path(kw["parent"]).resolve(), "parent_port")
        scopes["parent named_scope"] = importlib.import_module(
            "parent_port.utils.profiling").named_scope
    res = {"device": (torch.cuda.get_device_name(0) if cuda else "cpu"),
           "torch": torch.__version__, "reps": reps,
           "span_us": span_costs(scopes, reps, cuda), "cells": {}}
    cost = res["span_us"]["named_scope"]
    print(json.dumps({"span_us": res["span_us"]}), flush=True)
    for name in cells:
        r = traced_batch(name, seed, device, cut)
        n = sum(r["spans"].values())
        r["span_cost_ms"] = {"count": n, "off": 1e-3 * n * cost["off"],
                             "on": 1e-3 * n * cost["on"]}
        res["cells"][name] = r
        print(json.dumps({name: {k: r[k] for k in (
            "window_ms", "busy_ms", "scope_ms", "spans", "span_cost_ms",
            "gap_ms_by_span")}}), flush=True)
        for g in r["gaps"][:10]:
            print(f"  gap at {g[0]:.3f} ms: {g[1]:.4f} ms, {g[2]}, {g[3]}")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
