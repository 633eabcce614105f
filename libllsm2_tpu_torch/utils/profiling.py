"""Observability: named scopes, throughput metrics, profiler hooks
(counterpart of libllsm2_tpu.utils.profiling).

named_scope marks a stage for torch.profiler (record_function) and, on
the card, for NVTX (Nsight timelines); device_trace captures a
torch.profiler trace -- host ops, and the card's kernels when CUDA is in
use -- and writes it as a Chrome trace (chrome://tracing, Perfetto).
layer0 marks the JAX package's five stages: llsm.analyze.harmonic /
residual / noise and llsm.synth.harmonic / noise.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass
from typing import Dict, List

import torch


@contextlib.contextmanager
def named_scope(name: str):
    """A named range around a stage: a torch.profiler record_function (a
    no-op cost when no profiler runs) and, while CUDA is initialized, an
    NVTX range."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


@dataclass
class ThroughputMeter:
    """Accumulates processed audio seconds and wall time; reports the
    BASELINE.json metric."""
    audio_sec: float = 0.0
    wall_sec: float = 0.0

    @contextlib.contextmanager
    def measure(self, audio_seconds: float):
        t0 = time.perf_counter()
        yield
        self.wall_sec += time.perf_counter() - t0
        self.audio_sec += audio_seconds

    @property
    def audio_sec_per_sec(self) -> float:
        return self.audio_sec / max(self.wall_sec, 1e-9)

    def report(self) -> str:
        return json.dumps({
            "metric": "audio-sec/sec/gpu",
            "value": round(self.audio_sec_per_sec, 2),
            "audio_sec": round(self.audio_sec, 3),
            "wall_sec": round(self.wall_sec, 4),
        })


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace around a region and write it to
    logdir/trace.json (Chrome trace format), the card's kernels included
    when CUDA is initialized.  Yields the profiler (key_averages(),
    events())."""
    cuda = torch.cuda.is_initialized()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLog:
    """Structured metrics logging (jsonl) for corpus runs."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.rows: List[Dict] = []

    def log(self, **kw) -> None:
        row = dict(ts=time.time(), **kw)
        self.rows.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")
