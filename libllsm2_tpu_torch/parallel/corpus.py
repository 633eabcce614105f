"""Batched corpus processing (counterpart of libllsm2_tpu/parallel/corpus.py;
BASELINE config 5: 1000 mixed-length utterances, padded and bucketed,
analysis + synthesis on one card).

A batch of same-bucket utterances runs as batched tensors on one device.
Mixed lengths are handled by bucketing to a few frame counts, with
length masks for the metrics; a row's result does not depend on its
batch (layer0's row groups), so padding rows change nothing.  With a
mesh (parallel.mesh.make_mesh) the batch is data-parallel over its batch
axis: each rank runs its batch_size / n rows on its own device, and the
SNRs (and, where the caller gets it, the audio) are all-gathered, so
every rank yields the same dicts.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

import numpy as np
import torch

from ..config import AnalysisOptions, SynthesisOptions
from ..fp import FP
from ..models import layer0
from .mesh import BATCH_AXIS, all_gather, shard_batch

# int16 PCM -> float: the float32 value of 1 / 32767, as the JAX package
# multiplies (a Python float equal to it, so no rounding on the way)
PCM16_SCALE = float(np.float32(1.0 / 32767.0))


def is_transient_error(e: BaseException) -> bool:
    """True for failures worth retrying: device-layer and transport errors
    that a second attempt in the same process can clear, never Python bugs.

    - torch.cuda.OutOfMemoryError: the allocator gives the memory back
      (the runner empties its cache before the retry); another process or
      fragmentation may have held it.
    - torch.distributed's DistNetworkError / DistStoreError and OS-level
      ConnectionError, TimeoutError, BrokenPipeError: a peer or store
      dropped.
    A sticky CUDA error (illegal address, launch failure: a RuntimeError
    or torch.AcceleratorError) leaves the CUDA context unusable, so a retry
    in the same process would fail again and hide the first traceback: it
    propagates, as do ValueError, TypeError and every other error."""
    kinds = [torch.cuda.OutOfMemoryError, ConnectionError, TimeoutError,
             BrokenPipeError]
    dist = getattr(torch, "distributed", None)
    for name in ("DistNetworkError", "DistStoreError"):
        kind = getattr(dist, name, None)
        if isinstance(kind, type):
            kinds.append(kind)
    return isinstance(e, tuple(kinds))


def _pipeline(opt: AnalysisOptions, sopt: SynthesisOptions, x, f0, nx_valid,
              x_ref=None):
    """analyze -> synthesize -> masked SNR of a batch: x [B, nx], f0
    [B, N], nx_valid [B] -> (y [B, nx], snr [B] in dB).

    x_ref (optional): clean harmonic reference for the SNR; on noisy
    inputs, comparing y_sin against the noisy x would confound the metric
    with the fixture's own noise floor."""
    chunk = layer0._analyze(opt, x, f0)
    out = layer0._synthesize(sopt, chunk)
    ref = (x if x_ref is None else x_ref).to(FP)
    n = x.shape[-1]
    # exclude the OLA onset/offset transient (~half the largest
    # pitch-synchronous window), shrinking on very short valid spans
    nx_valid = torch.as_tensor(nx_valid, device=x.device)
    margin = torch.clamp(nx_valid // 4,
                         max=int(2.0 * opt.conf.fs / opt.conf.f0_floor))
    ar = torch.arange(n, device=x.device)
    m = ((ar >= margin[:, None]) & (ar < (nx_valid - margin)[:, None])).to(FP)
    err = (ref - out.y_sin[:, :n]) * m
    sig = ref * m
    # the sums over samples in calls of a fixed row count, as layer0 groups
    # its frame sums: PyTorch splits a row's reduction by the number of
    # rows, so a row's SNR would otherwise depend on its batch
    rows = layer0._group_rows(n // opt.conf.nhop)
    row_sums = lambda t: layer0._row_groups(
        lambda a: torch.sum(a, dim=-1), t, rows)
    snr = 10.0 * torch.log10(row_sums(sig ** 2)
                             / torch.clamp(row_sums(err ** 2), min=1e-12))
    return out.y, snr


def batched_pipeline(opt: AnalysisOptions, sopt: SynthesisOptions,
                     x: torch.Tensor, f0: torch.Tensor, nx_valid: torch.Tensor,
                     x_ref: torch.Tensor | None = None, mesh=None):
    """Batched analyze+synthesize: x [B, nx], f0 [B, N], nx_valid [B];
    x_ref [B, nx] (optional) = clean harmonic reference for the SNR.
    Returns (y [B, nx], snr [B], mean_snr).

    mesh: data-parallel over its batch axis.  The inputs are then this
    rank's rows (mesh.shard_batch of the global batch, as the JAX package
    shards them before its call); y stays this rank's rows (no gather, as
    the JAX output keeps its sharding), snr is the global batch's,
    all-gathered, and mean_snr its mean."""
    y, snr = _pipeline(opt, sopt, x, f0, nx_valid, x_ref)
    if mesh is not None:
        snr = all_gather(snr, mesh, BATCH_AXIS)
    return y, snr, torch.mean(snr)


def make_buckets(lengths: Sequence[int], bucket_frames: Sequence[int]
                 ) -> Dict[int, List[int]]:
    """Assign utterance indices to the smallest bucket (in frames) that
    fits; the longest bucket takes any overflow (truncation)."""
    buckets: Dict[int, List[int]] = {b: [] for b in sorted(bucket_frames)}
    bs = sorted(bucket_frames)
    for i, L in enumerate(lengths):
        for b in bs:
            if L <= b:
                buckets[b].append(i)
                break
        else:
            buckets[bs[-1]].append(i)
    return {b: idx for b, idx in buckets.items() if idx}


def _placement(mesh, batch_size: int, device):
    """(device, rows -> this rank's rows on it) of a corpus run."""
    if mesh is None:
        dev = torch.device("cuda" if device is None else device)
        return dev, lambda *a: tuple(torch.as_tensor(v).to(dev) for v in a)
    n = mesh.shape[BATCH_AXIS]
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} does not split over "
                         f"{n} ranks of the batch axis")
    return mesh.device, lambda *a: shard_batch(a, mesh)


def _retrying(fn, max_retries: int):
    """fn() retried up to max_retries times on transient device errors
    (is_transient_error); any other error propagates at once with its
    original traceback."""
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except Exception as e:
            if attempt == max_retries or not is_transient_error(e):
                raise
            if isinstance(e, torch.cuda.OutOfMemoryError):
                torch.cuda.empty_cache()


def run_corpus(opt: AnalysisOptions, sopt: SynthesisOptions,
               signals: Sequence[np.ndarray], f0s: Sequence[np.ndarray],
               bucket_frames: Sequence[int] = (200, 400, 800, 1600),
               batch_size: int = 64, mesh=None,
               checkpoint: dict | None = None, max_retries: int = 1,
               device=None):
    """Analyze+resynthesize a corpus with bucketed padding (config 5).

    Yields per-batch dicts {"bucket", "indices", "snr", "y"}: snr a numpy
    array of the batch's utterances (synced to the host once a batch), y
    the padded batch's output [batch_size, bucket * nhop] on the device.
    `checkpoint` (a mutable dict) records completed (bucket, batch start)
    pairs so an interrupted run resumes without recomputation.  Transient
    per-batch failures (is_transient_error) are retried up to max_retries
    times before re-raising.  The batches run on `device`, the card unless
    the caller passes device="cpu" (no fallback).  mesh: data-parallel
    over its batch axis (batch_size a multiple of its size), each rank on
    mesh.device; every rank must pass the same corpus and yields the same
    dicts, y all-gathered."""
    device, place = _placement(mesh, batch_size, device)
    nhop = opt.conf.nhop
    buckets = make_buckets([len(f) for f in f0s], bucket_frames)
    done = checkpoint.setdefault("done", set()) \
        if checkpoint is not None else set()
    for b, idxs in buckets.items():
        for start in range(0, len(idxs), batch_size):
            key = (b, start)
            if key in done:
                continue
            sel = idxs[start:start + batch_size]
            # pad partial batches to batch_size (padding rows have
            # nx_valid = 0), as the JAX package does for one program shape
            B = batch_size
            x = np.zeros((B, b * nhop), np.float32)
            f0 = np.zeros((B, b), np.float32)
            nxv = np.zeros((B,), np.int32)
            for j, i in enumerate(sel):
                nf = min(len(f0s[i]), b)
                nsamp = min(len(signals[i]), b * nhop)
                x[j, :nsamp] = signals[i][:nsamp]
                f0[j, :nf] = f0s[i][:nf]
                nxv[j] = nsamp
            xj, f0j, nxj = place(x, f0, nxv)
            y, snr, _ = _retrying(
                lambda: batched_pipeline(opt, sopt, xj, f0j, nxj, mesh=mesh),
                max_retries)
            if mesh is not None:
                y = all_gather(y, mesh, BATCH_AXIS)
            done.add(key)
            yield {"bucket": b, "indices": sel,
                   "snr": snr.cpu().numpy()[:len(sel)], "y": y}


def _batched_pipeline_pcm16(opt: AnalysisOptions, sopt: SynthesisOptions,
                            want_audio: bool, x_i16, f0, nx_valid, mesh=None):
    """batched_pipeline on int16 PCM rows: the float conversion happens on
    the device (half the host->device bytes of float rows), exactly as the
    JAX package converts (x * float32(1 / 32767)), and the [B, nx] audio
    is dropped unless requested."""
    x = x_i16.to(FP) * PCM16_SCALE
    y, snr, mean_snr = batched_pipeline(opt, sopt, x, f0, nx_valid,
                                        mesh=mesh)
    return (y if want_audio else None), snr, mean_snr


def run_corpus_files(opt: AnalysisOptions, sopt: SynthesisOptions,
                     paths: Sequence[str],
                     bucket_frames: Sequence[int] = (200, 400, 800, 1600),
                     batch_size: int = 64, mesh=None,
                     checkpoint: dict | None = None, max_retries: int = 1,
                     want_audio: bool = False, f0_suffix: str = ".f0.npy",
                     device=None, timings: list | None = None):
    """File-path front end to the corpus runner (BASELINE config 5 from
    disk).

    - Bucketing reads only RIFF headers (utils.dataio.wav_nsamples).
    - Batches load through the native C++ loader as int16 PCM
      (native/llsm_loader.cpp; scipy if it cannot be built) into pinned
      host memory, assembled by a worker thread one batch ahead, and go to
      the card with non-blocking copies: loading batch k+1 overlaps step k.
      The float conversion happens on the card.
    - F0 comes from `<path minus extension> + f0_suffix` sidecar .npy
      files where present; rows without a sidecar are tracked on the
      device by the built-in pYIN-style tracker (ops.f0.track_batch, the
      rows alone: a row's track does not depend on its batch).
    - checkpoint/resume and transient-retry semantics match run_corpus.

    Yields {"bucket", "indices", "paths", "snr"[, "y", "nx"]} per batch;
    rows are in `paths` order within each bucket.  Set want_audio=True to
    get the resynthesized audio rows (numpy [n, bucket * nhop]) and their
    valid lengths (costs the device->host transfer).  The batches run on
    `device`, the card unless the caller passes device="cpu".  mesh: as
    run_corpus's (each rank tracks and runs its rows; the audio rows
    all-gathered).  timings (optional): a list to which each batch appends
    {"bucket", "rows", "assemble_ms" (the worker's load and assembly),
    "wait_ms" (how long the step loop waited for it), "track_ms" (the
    copy to the device and the tracker), "step_ms" (the pipeline, to the
    batch's SNR on the host)}."""
    from ..ops import f0 as f0mod
    from ..utils import dataio

    device, _ = _placement(mesh, batch_size, device)
    pin = device.type == "cuda"
    nhop = opt.conf.nhop
    lengths = [dataio.wav_nsamples(p) for p in paths]
    buckets = make_buckets([n // nhop for n in lengths], bucket_frames)
    done = checkpoint.setdefault("done", set()) \
        if checkpoint is not None else set()

    plan = []
    for b, idxs in buckets.items():
        for start in range(0, len(idxs), batch_size):
            plan.append((b, start, idxs[start:start + batch_size]))
    plan = [item for item in plan if (item[0], item[1]) not in done]
    if not plan:
        return

    cfg = f0mod.F0Config(fs=opt.conf.fs, nhop=nhop,
                         f0_floor=max(60.0, opt.conf.f0_floor))

    def assemble(item):
        t0 = time.perf_counter()
        b, start, sel = item
        nsamp = b * nhop
        B = batch_size                        # partial batches padded
        xh = torch.zeros((B, nsamp), dtype=torch.int16, pin_memory=pin)
        _, ln, rates = dataio.load_wav_batch(
            [paths[i] for i in sel], nsamp, dtype="int16",
            out=xh.numpy()[:len(sel)])
        bad = [paths[sel[j]] for j in range(len(sel))
               if rates[j] and abs(rates[j] - opt.conf.fs) > 0.5]
        if bad:
            raise ValueError(
                f"sample rate != conf.fs ({opt.conf.fs:g}): {bad[:3]} -- "
                "run_corpus_files loads raw PCM without resampling")
        ln = np.pad(ln, (0, B - len(ln)))
        f0 = np.zeros((B, b), np.float32)
        untracked = []
        for j, i in enumerate(sel):
            sp = os.path.splitext(paths[i])[0] + f0_suffix
            if os.path.exists(sp):
                t = np.load(sp)
                nf = min(len(t), b)
                f0[j, :nf] = t[:nf]
            else:
                untracked.append(j)
        nxv = np.minimum(ln, nsamp).astype(np.int32)
        return xh, f0, untracked, nxv, (time.perf_counter() - t0) * 1e3

    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(assemble, plan[0])
        for k, (b, start, sel) in enumerate(plan):
            t0 = time.perf_counter()
            xh, f0np, untracked, nxv, asm_ms = fut.result()
            t1 = time.perf_counter()
            if k + 1 < len(plan):
                fut = pool.submit(assemble, plan[k + 1])
            nx_all = nxv
            if mesh is not None:          # this rank's rows of the batch
                n = batch_size // mesh.shape[BATCH_AXIS]
                r0 = mesh.index(BATCH_AXIS) * n
                xh, f0np, nxv = xh[r0:r0 + n], f0np[r0:r0 + n], nxv[r0:r0 + n]
                untracked = [j - r0 for j in untracked if r0 <= j < r0 + n]
            xj = xh.to(device, non_blocking=pin)
            f0j = torch.from_numpy(f0np).to(device)
            nxj = torch.from_numpy(nxv).to(device)
            if untracked:
                rows = torch.tensor(untracked, device=device)
                f0j[rows] = f0mod.track_batch(cfg,
                                              xj[rows].to(FP) * PCM16_SCALE)
            t2 = time.perf_counter()
            y, snr, _ = _retrying(
                lambda: _batched_pipeline_pcm16(opt, sopt, bool(want_audio),
                                                xj, f0j, nxj, mesh=mesh),
                max_retries)
            done.add((b, start))
            out = {"bucket": b, "indices": sel,
                   "paths": [paths[i] for i in sel],
                   "snr": snr.cpu().numpy()[:len(sel)]}
            if want_audio:
                if mesh is not None:
                    y = all_gather(y, mesh, BATCH_AXIS)
                out["y"] = y[:len(sel)].cpu().numpy()
                out["nx"] = nx_all[:len(sel)]
            if timings is not None:
                timings.append({"bucket": b, "rows": len(sel),
                                "assemble_ms": asm_ms,
                                "wait_ms": (t1 - t0) * 1e3,
                                "track_ms": (t2 - t1) * 1e3,
                                "step_ms": (time.perf_counter() - t2) * 1e3})
            yield out
