"""The benchmark's general runner: one cell of BENCHMARK.json, once.

A cell names a configuration (configs/<config>.json), a traffic mix
(traffic/<mix>.json, which names its driver, drivers/<driver>.py), its
correctness limits (limits/<cell>.json) and, through BENCHMARK.json, its
metrics: each end-to-end metric is read by e2e/<name>.py from the
window's record, each per-layer metric by metrics/<name>.py from the
traced slice.  Nothing here names a cell, a configuration or a metric.

A run: set-up (the port, the CUDA context, the inputs made on the device
from the seed, the warm-up of the cell's shapes), then a closed loop of
batches for --seconds (each batch timed from its input copy to its output
on the host by CUDA events in the stream), then the comparison of a
seeded sample of the window's rows with the plain reference, run once
the window has closed and its peak has been read.  With --trace 1 a slice
of the window's first batches is profiled and the per-layer metrics are
read from it.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import random
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

from . import peaks, trace as trace_mod

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "libllsm2_tpu"}
#: host threads of PyTorch's CPU pool: the card does the work, and a pool
#: sized to the host only adds contention on a shared one
THREADS = 2


def load_module(path: Path, name: str):
    """Import the file at path as a module of its own."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def resolve(cell: str, bench: dict | None = None) -> SimpleNamespace:
    """The cell's entry of BENCHMARK.json and the files it is found by."""
    bench = bench or spec()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    traffic = load_json(ROOT / "traffic" / f"{entry['traffic']}.json")
    moved = lambda m: "workloads" not in m or cell in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if moved(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if m["moves"] in names and moved(m)]
    return SimpleNamespace(
        name=cell, entry=entry, config=load_json(REPO / cfg_entry["file"]),
        traffic=traffic,
        driver=load_module(ROOT / "drivers" / f"{traffic['driver']}.py",
                           f"portbench_driver_{traffic['driver']}"),
        limits=load_json(ROOT / "limits" / f"{cell}.json"),
        e2e=e2e, per_layer=per_layer)


def reader(kind: str, name: str):
    """The reader of metric `name`: e2e/<name>.py or metrics/<name>.py."""
    return load_module(ROOT / kind / f"{name}.py",
                       "portbench_" + kind + "_" + name.replace(".", "_"))


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port may not pull in,
    each compared whole (libllsm2_tpu_torch is not libllsm2_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Sample:
    """A seeded sample of `size` (batch, row) pairs over the window's
    batches: slot i holds a row of stratum i (rows offset + i B / size,
    the offset drawn from the seed), from a batch kept by reservoir
    sampling, so every part of a batch is sampled alike; each slot keeps
    its row of every compared output (cloned)."""

    def __init__(self, seed: int, size: int, rows: int):
        self.rng = random.Random(int(seed) ^ 0x5A17)
        self.size, self.rows = min(size, rows), rows
        self.offset = self.rng.randrange(rows)
        self.kept, self.seen = [None] * self.size, 0

    def row(self, slot: int) -> int:
        return (self.offset + slot * self.rows // self.size) % self.rows

    def offer(self, j: int, pool_index: int, fields: dict) -> None:
        """Offer batch j (pool entry pool_index) and its outputs."""
        self.seen += 1
        for slot in range(self.size):
            if self.seen == 1 or self.rng.randrange(self.seen) == 0:
                r = self.row(slot)
                self.kept[slot] = (j, pool_index, r, {
                    k: v[r].clone() for k, v in fields.items()})

    @property
    def rows_kept(self) -> list:
        return [k for k in self.kept if k is not None]


def least_s(cell, ctx, scope: str, pool_indices) -> float | None:
    """The least time the card could take for a scope over the given
    batches: each batch's operations over the float32 peak or its bytes
    over the memory peak, whichever is longer (work/<scope>.py counts
    both from the batch's shapes and live harmonics)."""
    path = ROOT / "work" / f"{scope}.py"
    if not path.is_file():
        return None
    work = load_module(path, "portbench_work_" + scope.replace(".", "_"))
    total = 0.0
    for p in pool_indices:
        ops, nbytes = work.work(ctx.work_info[p])
        total += max(ops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_S)
    return total


def run(cell: SimpleNamespace, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", ctx_hook=None) -> dict:
    """Run one cell once -> the result dict (without printing it).
    t_start: the process's start on the host clock (perf_counter).
    ctx_hook(ctx), if given, may alter the context after set-up (the
    tests' faults)."""
    import torch
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import libllsm2_tpu_torch as port
    from . import gen
    from .reference import llsm_ref as ref
    tr = cell.traffic
    ctx = SimpleNamespace(cfg=cell.config, traffic=tr, seed=seed,
                          device=torch.device(device), port=port, gen=gen,
                          ref=ref, torch=torch)
    cell.driver.setup(ctx)
    if ctx_hook is not None:
        ctx_hook(ctx)
    cuda = ctx.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    npool = len(ctx.pool)
    for j in range(int(tr["warmup_batches"])):
        cell.driver.batch(ctx, j % npool)
    sync()

    sample = Sample(seed, int(tr["compare_rows"]), ctx.rows)
    prof = trace_path = None
    n_traced = int(tr["trace_batches"]) if trace else 0
    if trace:
        trace_path = os.path.join(tempfile.mkdtemp(prefix="portbench-"),
                                  "trace.json")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1,
                                             active=n_traced, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path))
        prof.start()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    # no collector pauses inside the window: what set-up made stays
    gc.collect()
    gc.freeze()
    gc.disable()
    latencies = []
    min_batches = n_traced + 1 if trace else 1
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    j = 0
    while True:
        p = j % npool
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        else:
            h0 = time.perf_counter()
        with torch.profiler.record_function("portbench.batch"):
            fields = cell.driver.batch(ctx, p)
        if cuda:
            ev1.record()
            ev1.synchronize()
            latencies.append(ev0.elapsed_time(ev1))
        else:
            latencies.append(1e3 * (time.perf_counter() - h0))
        sample.offer(j, p, fields)
        del fields
        j += 1
        if prof is not None and j <= n_traced + 1:
            prof.step()
            if j == n_traced + 1:
                prof.stop()
                prof = None
        if time.perf_counter() - t0 >= seconds and j >= min_batches:
            break
    window_s = time.perf_counter() - t0
    gc.enable()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded by the window: {bad}")

    rec = SimpleNamespace(batches=j, audio_s=j * ctx.audio_s_batch,
                          window_s=window_s, latencies_ms=latencies,
                          setup_s=setup_s, peak_bytes=peak)
    metrics = {}
    breakdown = None
    device_extra = {}
    if trace:
        summ = trace_mod.summarize(trace_mod.load(trace_path))
        os.remove(trace_path)
        os.rmdir(os.path.dirname(trace_path))
        traced = [k % npool for k in range(1, n_traced + 1)]
        summ = SimpleNamespace(**summ, peak_bytes=peak, least_s=lambda sc:
                               least_s(cell, ctx, sc, traced))
        for m in cell.per_layer:
            v = reader("metrics", m["name"]).read(summ) \
                if summ.batches else None
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if summ.batches:
            device_extra = {"busy_s": summ.busy_s, "window_s": summ.window_s}
            breakdown = {"device_ops": summ.device_ops,
                         "idle_gaps": summ.idle_gaps}
    else:
        for m in cell.e2e:
            metrics[m["name"]] = {"value": float(
                reader("e2e", m["name"]).read(rec)), "unit": m["unit"]}

    # the comparison, once the window's outputs are freed
    if cuda:
        torch.cuda.empty_cache()
    numbers = cell.driver.compare(ctx, sample.rows_kept)
    limits = cell.limits["numbers"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (set(numbers) == set(limits)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in checks.values())
               and len(sample.rows_kept) == sample.size)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(peak)}
    dev.update(device_extra)
    out = {"correct": bool(correct), "attempted": j, "failed": 0,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
