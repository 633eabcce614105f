"""Multi-stream real-time serving of the PyTorch port: N concurrent
synthesis streams rendered by one device dispatch a service tick
(counterpart of libllsm2_tpu/runtime/rtserve.py).

The reference's llsmrt streams one voice; many voices there are many
buffers, each paying its own render.  On a card one stream's [2 nhop]
segments leave it idle, so a StreamPool renders `n_streams x feed_block`
hops in one batched render (and, in PbP mode, every stream's pulses in
one more) and overlap-adds each stream's segments into its own host ring.
Per-stream state is small and on the host; the tick's inputs reach the
card in one copy and its segments come back in one.

Each stream's output equals, bit for bit, a solo RTSynthesizer fed the
same frames with the same derived noise seed (noise_seed + s): the pool
renders its frames in the solo path's groups of feed_block rows and its
pulses in groups of the solo pulse budget (rtsynth's module docstring).

With a mesh (parallel.mesh) the tick's render is data-parallel over the
mesh's first axis: every rank keeps every stream's host state and is fed
the same frames, renders the due streams among its n_streams / n ones
(and its share of the pulse groups), and the rendered rows are
all-gathered, so every rank commits every ring and fetch(s) works for
every stream on every rank.

Latency: feed_block + 1 hops (the service granularity plus one lookahead
frame).

    pool = StreamPool(sopt, conf, n_streams=64)
    pool.feed(s, chunk_or_frames)          # per stream, any granularity
    pool.service()                          # one render, all due streams
    y = pool.fetch(s, pool.readable(s))     # per-stream audio
    pool.end_stream(s)                      # flush the tail; slot reusable
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import ChunkConf, SynthesisOptions
from ..parallel.mesh import all_gather
from .rtsynth import (RTSynthesizer, _pulses_host, _render_frames,
                      _render_host, _render_pulses, _stage)


class StreamPool:
    """N independent streaming voices served by one batched render.

    Args:
      sopt: synthesis options; stream s draws its noise with seed
        sopt.noise_seed + s.
      conf: the chunk conf every stream shares (pools of other confs are
        other StreamPools).
      n_streams: pool width.
      feed_block: hops rendered a stream a service tick.
      capacity_frames, phase_mode, synth_mode: each stream's
        RTSynthesizer's.
      mesh: a parallel.mesh.Mesh: the render is sharded over its first
        axis (n_streams a multiple of its size; each rank renders its
        streams' rows on mesh.device).
      device: where the renders run ("cuda" unless given; mesh.device
        with a mesh).
    """

    def __init__(self, sopt: SynthesisOptions, conf: ChunkConf,
                 n_streams: int, feed_block: int = 16,
                 capacity_frames: int = 256, phase_mode: str = "absolute",
                 synth_mode: str = "harmonic", mesh=None, device=None):
        self.mesh = mesh
        self._ndev, self._rank = 1, 0
        if mesh is not None:
            self._axis = mesh.axis_names[0]
            self._ndev = mesh.shape[self._axis]
            self._rank = mesh.index(self._axis)
            if int(n_streams) % self._ndev:
                raise ValueError(f"n_streams={n_streams} must divide over "
                                 f"{self._ndev} ranks")
            device = mesh.device
        self.conf = conf
        self.n_streams = int(n_streams)
        self.feed_block = int(feed_block)
        if self.n_streams < 1 or self.feed_block < 1:
            raise ValueError("n_streams and feed_block must be >= 1")
        self.streams = []
        for s in range(self.n_streams):
            so = dataclasses.replace(sopt, noise_seed=int(sopt.noise_seed) + s)
            rt = RTSynthesizer(so, conf, capacity_frames=capacity_frames,
                               phase_mode=phase_mode, synth_mode=synth_mode,
                               device=device)
            rt.feed_block = self.feed_block
            self.streams.append(rt)
        self.device = self.streams[0].device
        self._q = [[] for _ in range(self.n_streams)]
        self.dispatches = 0   # batched device renders (observability)

    # -- per-stream I/O ----------------------------------------------------
    def feed(self, s: int, frames) -> None:
        """Queue frames for stream s (a Chunk, a frame dict, or a list of
        either); they render at the next service() tick."""
        self._q[s].extend(self.streams[s]._queue(frames))

    def readable(self, s: int) -> int:
        return self.streams[s].readable()

    def fetch(self, s: int, n: int) -> np.ndarray:
        return self.streams[s].fetch(n)

    def queued(self, s: int) -> int:
        """Frames queued but not yet rendered for stream s."""
        rt = self.streams[s]
        return len(self._q[s]) + (1 if rt._pending is not None else 0)

    # -- the batched tick --------------------------------------------------
    def _due(self, s: int) -> bool:
        """Stream s can render a full feed_block this tick (block frames
        plus one lookahead, counting the held-over pending frame)."""
        rt = self.streams[s]
        need = self.feed_block + (0 if rt._pending is not None else 1)
        return len(self._q[s]) >= need

    def service(self, timings: list | None = None) -> int:
        """Render one feed_block for every due stream in one batched render
        (plus one pulse render in PbP mode) -> the number of streams
        rendered; call again to drain deep queues.  timings: a list that
        gets, for a tick that rendered, the host milliseconds of its
        assembly, its render (the copies included) and its commit."""
        MB = self.feed_block
        t0 = time.perf_counter()
        due = [s for s in range(self.n_streams) if self._due(s)]
        if not due:
            return 0
        per = []   # (rt, queue, ins, M, pulse_jobs)
        for s in due:
            rt = self.streams[s]
            if rt._pending is not None:
                queue = [rt._pending] + self._q[s][:MB]
                self._q[s] = self._q[s][MB:]
            else:
                queue = self._q[s][:MB + 1]
                self._q[s] = self._q[s][MB + 1:]
            per.append((rt, queue) + rt._assemble_group(queue, rt._prev_f0))
        # every due stream's group of MB rows, rendered as the solo path
        # renders it
        ins = {k: np.concatenate([p[2][k] for p in per])
               for k in RTSynthesizer._FIELDS}
        pulse_rows = None
        jobs = [p[4] for p in per]
        if any(jobs):
            # one pulse render on stream 0's spectral grid: refuse a
            # stream whose sopt was changed to another pbp_oversample
            os0 = self.streams[0].sopt.pbp_oversample
            for s, (rt, *_r) in zip(due, per):
                if rt.sopt.pbp_oversample != os0:
                    raise ValueError(
                        f"stream {s} has pbp_oversample="
                        f"{rt.sopt.pbp_oversample} != pool's {os0}; all "
                        "pooled streams must share one spectral grid")
            budget = self.streams[0]._pulse_budget()
            flat = [j for pj in jobs for j in pj]
            # groups of the solo budget, as many as a multiple of the ranks
            groups = -(-len(flat) // budget)
            groups = -(-groups // self._ndev) * self._ndev
            pulse_rows = RTSynthesizer._pack_pulse_jobs(
                self.conf, flat, groups * budget)
        t1 = time.perf_counter()
        segs = self._render(ins, due, MB)
        self.dispatches += 1
        pulses = None
        if pulse_rows is not None:
            pulses = self._pulses(pulse_rows, os0, budget)
            self.dispatches += 1
        t2 = time.perf_counter()
        p0 = 0
        for row, (rt, queue, _, M, pj) in enumerate(per):
            pl = pulses[p0:p0 + len(pj)] if pj else None
            p0 += len(pj)
            rt._commit_group(segs[row * MB:row * MB + M], M, pl, pj)
            rt._prev_f0 = queue[-2]["f0"]
            rt._pending = queue[-1]
            rt._fed = max(rt._fed, rt._i + 1)
        if timings is not None:
            t3 = time.perf_counter()
            timings.append(dict(assemble=(t1 - t0) * 1e3,
                                render=(t2 - t1) * 1e3,
                                commit=(t3 - t2) * 1e3))
        return len(per)

    def _render(self, ins: dict, due, MB: int) -> np.ndarray:
        """The due streams' segments (host), each stream's MB rows rendered
        as the solo path renders them; with a mesh each rank renders its
        own streams' rows and the rows are all-gathered."""
        fields = RTSynthesizer._FIELDS
        if self.mesh is None:
            return _render_host(self.conf, ins, MB, self.device)
        per = self.n_streams // self._ndev
        owner = [s // per for s in due]
        mine = [j for j, r in enumerate(owner) if r == self._rank]
        rows = np.concatenate([np.arange(j * MB, (j + 1) * MB)
                               for j in mine]).astype(np.int64) \
            if mine else np.zeros((0,), np.int64)
        width = per * MB
        out = torch.zeros((width, 2 * self.streams[0].nhop),
                          dtype=torch.float32, device=self.device)
        if mine:
            out[:len(rows)] = _render_frames(self.conf, *_stage(
                [ins[k][rows] for k in fields], self.device), rows=MB)
        gathered = all_gather(out, self.mesh, self._axis).cpu().numpy()
        segs = np.empty((len(due) * MB, gathered.shape[1]), np.float32)
        for r in range(self._ndev):
            js = [j for j, o in enumerate(owner) if o == r]
            for n, j in enumerate(js):
                segs[j * MB:(j + 1) * MB] = gathered[r * width + n * MB:
                                                     r * width + (n + 1) * MB]
        return segs

    def _pulses(self, args, os_: int, budget: int) -> np.ndarray:
        """The pooled pulse rows (host), in groups of `budget` rows; with a
        mesh each rank renders its share of the groups, all-gathered."""
        if self.mesh is None:
            return _pulses_host(self.conf, args, os_, budget, self.device)
        share = len(args[0]) // self._ndev
        r0 = self._rank * share
        mine = _render_pulses(self.conf, *_stage(
            [a[r0:r0 + share] for a in args], self.device), int(os_),
            rows=budget)
        return all_gather(mine, self.mesh, self._axis).cpu().numpy()

    def end_stream(self, s: int) -> None:
        """Flush stream s: render a sub-block remainder (solo renders: the
        tail only) and finalize its ring.  Reset the slot for a new voice
        with reset_stream()."""
        rt = self.streams[s]
        rest = self._q[s]
        self._q[s] = []
        if rest:
            rt.feed_many(rest)
        rt.flush()

    def reset_stream(self, s: int) -> None:
        """Recycle slot s for a new voice (same conf)."""
        self._q[s] = []
        self.streams[s].reset()
