"""Reduction of a torch.profiler Chrome trace to the benchmark's per-layer
readings: device time by host scope, kernel counts, the device's busy
share, the longest device operations and the idle gaps by what the host
was doing.

Each device operation (kernel, copy, memset) is tied to the host call that
launched it by its correlation id, and charged to the innermost range of
the benchmark's or the program's own (``portbench.*``, ``llsm.*``) open on
that thread at the launch; one launched inside a batch but in no such
range is "unscoped".  Only batches (the ``portbench.batch`` ranges)
count: the traced window runs from the first one's start to the last
one's end.  An idle gap is labelled by the innermost host operation on
the batches' thread at its midpoint.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

BATCH = "portbench.batch"
SCOPES = ("llsm.", "portbench.")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals):
    """Sorted, merged [start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ranges, t):
    """The innermost (latest-starting) of ranges [(start, end, name)],
    sorted by start, that contains t, or None."""
    for i in range(bisect.bisect_right(ranges, (t, float("inf"), "")) - 1,
                   -1, -1):
        s, e, name = ranges[i]
        if s <= t < e:
            return name
    return None


def summarize(events: list, top: int = 10) -> dict:
    """Per-layer readings of a trace's events (the "traceEvents" list) ->
    dict(batches, window_s, busy_s, scope_s {label: device s}, kernels,
    device_ops [[name, s]], idle_gaps [[host activity, s]])."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    batches = sorted((e["ts"], e["ts"] + e["dur"], e["tid"]) for e in xs
                     if e.get("cat") == "user_annotation"
                     and e["name"] == BATCH)
    if not batches:
        return dict(batches=0)
    w0, w1 = batches[0][0], max(b[1] for b in batches)
    main_tid = batches[0][2]
    ranges = defaultdict(list)      # tid -> [(start, end, name)] scopes
    host = []                       # the main thread's host activity
    launch = {}                     # correlation -> (ts, tid)
    for e in xs:
        cat = e.get("cat")
        if cat == "user_annotation" and e["name"].startswith(SCOPES) \
                and e["name"] != BATCH:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = (e["ts"], e["tid"])
        if cat in HOST_CATS and e["tid"] == main_tid:
            host.append((e["ts"], e["ts"] + e["dur"], e["name"]))
    for r in ranges.values():
        r.sort()
    host.sort()
    in_batch = lambda t: any(b[0] <= t < b[1] for b in batches)
    scope_s = defaultdict(float)
    by_name = defaultdict(float)
    kernels = 0
    busy = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s, d = e["ts"], e["dur"]
        lt = launch.get(e.get("args", {}).get("correlation"))
        if lt is None or not in_batch(lt[0]):
            continue
        label = _innermost(ranges[lt[1]], lt[0]) or "unscoped"
        scope_s[label] += d * 1e-6
        by_name[e["name"]] += d * 1e-6
        kernels += e["cat"] == "kernel"
        busy.append((max(s, w0), min(s + d, w1)))
    merged = _union([b for b in busy if b[1] > b[0]])
    busy_s = sum(e - s for s, e in merged) * 1e-6
    gaps = defaultdict(float)
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            mid = 0.5 * (prev + s)
            gaps[_innermost(host, mid) or "host, outside every op"] += \
                (s - prev) * 1e-6
        prev = max(prev, e)
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return dict(batches=len(batches), window_s=(w1 - w0) * 1e-6,
                busy_s=busy_s, scope_s=dict(scope_s), kernels=kernels,
                device_ops=rank(by_name), idle_gaps=rank(gaps))


def load(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]
