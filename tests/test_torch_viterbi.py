"""The port's Viterbi scan (kernels.viterbi_scan, csrc/viterbi.cu) on the
CPU, where the wrapper runs its plain twin: the twin's paths against the
JAX package's two scans (the F0 tracker's renormalized lax.scan and
backtrace, layer 1's _rd_viterbi) exactly, ties included; the twin against
the two loops it replaced in ops/f0.py and models/layer1.py, bit for bit;
rows alone against their rows in a batch; the FP64 route; the launch
geometry and chip_smoke's operation count by hand.  Inputs are made from
seeds with numpy."""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libllsm2_tpu.models import layer1 as jl1

from libllsm2_tpu_torch.models import layer1 as tl1
from libllsm2_tpu_torch.ops import f0 as tf0
from libllsm2_tpu_torch.ops import kernels
# the JAX tracker's Viterbi (libllsm2_tpu/ops/f0.py:203-222), op for op
from test_torch_f0 import _jax_viterbi

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = lambda a: torch.tensor(np.asarray(a))
LAM = 10.0                      # layer 1's continuity weight (smooth)


def _tracker_lt(S):
    """The tracker's log transitions for S = nbins + 1 states."""
    return tf0._tables(tf0.F0Config(nbins=S - 1), "cpu")["lt"]


def _rd_pen(G, lam=LAM):
    """_rd_viterbi's penalty [G, G] (models/layer1.py), float32."""
    dstep = (torch.log(torch.tensor(tl1.RD_MAX, dtype=torch.float32))
             - torch.log(torch.tensor(tl1.RD_MIN, dtype=torch.float32))) \
        / (G - 1)
    ar = torch.arange(G)
    di = (ar[:, None] - ar[None, :]).to(torch.float32)
    return lam * (di * dstep) ** 2


def _eighths(rng, shape, lo, hi):
    """Uniform values in [lo, hi) rounded to multiples of 1/8: ties many."""
    return (np.round(rng.uniform(lo, hi, shape) * 8.0) / 8.0).astype(
        np.float32)


def _ties(obs, lt, renorm):
    """Steps of the plain recursion (float32, numpy) whose maximum over the
    candidates is reached by more than one source state, in all rows."""
    n = 0
    for row in obs:
        s = row[0] - row[0].max() if renorm else row[0]
        for t in range(1, len(row)):
            cand = s[:, None] + lt
            n += int((cand == cand.max(axis=0)).sum(axis=0).__gt__(1).sum())
            s = cand.max(axis=0) + row[t]
            if renorm:
                s = s - s.max()
    return n


@pytest.mark.parametrize("N", [1, 2, 37, 400])
@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("S", [64, 97])
def test_twin_equals_the_jax_scans_with_ties(S, renorm, N):
    """Scores in multiples of 1/8 (tied candidates, counted at N = 400), 3
    rows, paths equal exactly.  With renorm: the twin against the JAX
    tracker's scan under its transitions for nbins = S - 1, rounded to
    eighths too.  Without: the twin on the voiced-masked scores under
    -pen, and the port's _rd_viterbi, against JAX's _rd_viterbi on the
    same scores and voicing (S grid points, lam 10)."""
    rng = np.random.default_rng(1000 * S + 10 * N + renorm)
    B = 3
    if renorm:
        lt = torch.round(_tracker_lt(S) * 8.0) / 8.0
        obs = _eighths(rng, (B, N, S), -30.0, 0.0)
        got = kernels.viterbi_scan(T(obs), lt, True).numpy()
        for b in range(B):
            ref = _jax_viterbi(jnp.asarray(obs[b]), jnp.asarray(lt.numpy()))
            np.testing.assert_array_equal(got[b], ref)
    else:
        lt = -_rd_pen(S)
        score = _eighths(rng, (B, N, S), 0.0, 1.0)
        voiced = rng.uniform(size=(B, N)) > 0.2
        obs = np.where(voiced[..., None], score, 0.0).astype(np.float32)
        got = kernels.viterbi_scan(T(obs), lt, False).numpy()
        np.testing.assert_array_equal(
            tl1._rd_viterbi(T(score), T(voiced), LAM).numpy(), got)
        for b in range(B):
            ref = jl1._rd_viterbi(jnp.asarray(score[b]),
                                  jnp.asarray(voiced[b]), LAM)
            np.testing.assert_array_equal(got[b], np.asarray(ref))
    if N == 400:
        assert _ties(obs, lt.numpy(), renorm) > 0


# the two loops this kernel replaced (ops/f0.py viterbi and models/
# layer1.py _rd_viterbi before it), as they were, returning their last
# scores beside the path

def _parent_f0_viterbi(logobs, lt):
    B, N, S = logobs.shape
    score = logobs[:, 0] - torch.amax(logobs[:, 0], dim=-1, keepdim=True)
    back = torch.empty((max(N - 1, 0), B, S), dtype=torch.int64,
                       device=logobs.device)
    best = torch.empty((B, S), dtype=torch.float32, device=logobs.device)
    for t in range(1, N):
        torch.max(score[:, :, None] + lt, dim=1, out=(best, back[t - 1]))
        score = best + logobs[:, t]
        score = score - torch.amax(score, dim=-1, keepdim=True)
    last = torch.argmax(score, dim=-1)
    bk = back.to(torch.int16).cpu().numpy()
    path = np.empty((N, B), np.int64)
    path[N - 1] = last.cpu().numpy()
    rows = np.arange(B)
    for t in range(N - 2, -1, -1):
        path[t] = bk[t, rows, path[t + 1]]
    return torch.as_tensor(path.T.copy(), device=logobs.device), score


def _parent_rd_viterbi(score, voiced, lam):
    B, N, G = score.shape
    dev = score.device
    dstep = (torch.log(torch.tensor(tl1.RD_MAX, dtype=torch.float32))
             - torch.log(torch.tensor(tl1.RD_MIN, dtype=torch.float32))) \
        / (G - 1)
    ar = torch.arange(G, device=dev)
    di = (ar[:, None] - ar[None, :]).to(torch.float32)
    pen = lam * (di * dstep.to(dev)) ** 2                   # [G(prev), G]
    obs = torch.where(voiced[..., None], score, torch.zeros_like(score))
    cost = obs[:, 0]
    bp = torch.empty((B, max(N - 1, 0), G), dtype=torch.int64, device=dev)
    for n in range(1, N):
        best, arg = torch.max(cost[:, :, None] - pen, dim=1)
        cost = best + obs[:, n]
        bp[:, n - 1] = arg
    path = torch.empty((B, N), dtype=torch.int64, device=dev)
    g = torch.argmax(cost, dim=-1)
    path[:, N - 1] = g
    for n in range(N - 2, -1, -1):
        g = torch.gather(bp[:, n], 1, g[:, None])[:, 0]
        path[:, n] = g
    return path, cost


def _tracker_logobs(B, duration):
    """The tracker's own observations [B, N, 97] of B noisy bench-like
    utterances (ops/f0.py's front end)."""
    from libllsm2_tpu_torch.utils import testsig
    utt = testsig.make_test_utterances([(i, 0.05 * (i % 2)) for i in
                                        range(B)], duration=duration)
    x = torch.tensor(np.stack([u[0] for u in utt]), dtype=torch.float32)
    return tf0._observations(tf0.F0Config(f0_floor=70.0), x)[0]


@pytest.mark.parametrize("kind", ["tracker", "uniform", "eighths"])
def test_twin_equals_the_loops_it_replaced(kind):
    """The twin against the parent's two loops, copied above: paths and
    last scores equal bit for bit, renormalized under the tracker's
    transitions (its own observations of 3 utterances of 2 s, uniform
    scores, or scores in eighths) and without, under -pen on layer-1-like
    scores with unvoiced runs (uniform or in eighths; the tracker kind
    feeds its observations less their row minimum)."""
    rng = np.random.default_rng(7)
    lt = _tracker_lt(97)
    if kind == "tracker":
        logobs = _tracker_logobs(3, 2.0)
    elif kind == "uniform":
        logobs = T(rng.uniform(-40.0, 0.0, (3, 300, 97)).astype(np.float32))
    else:
        logobs = T(_eighths(rng, (3, 300, 97), -30.0, 0.0))
    path, score = kernels.viterbi_scan(logobs, lt, True, scores=True)
    ref_path, ref_score = _parent_f0_viterbi(logobs, lt)
    assert torch.equal(path, ref_path)
    assert torch.equal(score, ref_score)
    assert torch.equal(tf0.viterbi(logobs, lt), ref_path)

    B, N, _ = logobs.shape
    rd = (logobs[..., :64] - logobs[..., :64].amin(-1, keepdim=True)) / 40.0
    voiced = torch.tensor(rng.uniform(size=(B, N)) > 0.15)
    voiced[0, N // 3:N // 2] = False
    obs = torch.where(voiced[..., None], rd, torch.zeros_like(rd))
    path, score = kernels.viterbi_scan(obs, -_rd_pen(64), False, scores=True)
    ref_path, ref_score = _parent_rd_viterbi(rd, voiced, LAM)
    assert torch.equal(path, ref_path)
    assert torch.equal(score, ref_score)
    assert torch.equal(tl1._rd_viterbi(rd, voiced, LAM), ref_path)


@pytest.mark.parametrize("renorm", [True, False])
def test_rows_alone_equal_their_rows_in_a_batch(renorm):
    """Rows 0, 2 and 4 of a 5-row batch alone (a batch of one) give the
    same path and last scores as in the batch, bit for bit."""
    rng = np.random.default_rng(3 + renorm)
    obs = T(_eighths(rng, (5, 211, 97), -20.0, 0.0))
    lt = _tracker_lt(97) if renorm else -_rd_pen(97)
    path, score = kernels.viterbi_scan(obs, lt, renorm, scores=True)
    for r in (0, 2, 4):
        p, s = kernels.viterbi_scan(obs[r:r + 1], lt, renorm, scores=True)
        assert torch.equal(p[0], path[r]) and torch.equal(s[0], score[r])


def test_cpu_tensors_take_the_twin_and_launch_nothing():
    """On CPU tensors the wrapper, f0.viterbi and _rd_viterbi run the twin
    and count no launch; the twin refuses zero frames."""
    rng = np.random.default_rng(5)
    obs = T(rng.uniform(-5, 0, (2, 30, 97)).astype(np.float32))
    lt = _tracker_lt(97)
    before = dict(kernels.LAUNCHES)
    assert torch.equal(tf0.viterbi(obs, lt),
                       kernels.viterbi_scan_ref(obs, lt, True))
    voiced = torch.ones((2, 30), dtype=torch.bool)
    assert tl1._rd_viterbi(obs[..., :64], voiced, LAM).shape == (2, 30)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError):
        kernels.viterbi_scan(obs[:, :0], lt, True)


FP64_ROUTE = textwrap.dedent("""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from libllsm2_tpu.models import layer1 as jl1
    from libllsm2_tpu_torch import fp
    from libllsm2_tpu_torch.models import layer1 as tl1
    from libllsm2_tpu_torch.ops import f0 as tf0
    from libllsm2_tpu_torch.ops import kernels
    from test_torch_f0 import _jax_viterbi

    assert fp.FP64 and jnp.zeros(1).dtype == jnp.float64

    def refuse(*a, **k):
        raise AssertionError("the FP64 route reached the kernel's wrapper")
    kernels.viterbi_scan = refuse
    rng = np.random.default_rng(2)
    logobs = rng.uniform(-30.0, 0.0, (2, 120, 97))
    lt = tf0._tables(tf0.F0Config(), "cpu")["lt"]
    got = tf0.viterbi(torch.tensor(logobs), lt).numpy()
    for b in range(2):
        ref = _jax_viterbi(jnp.asarray(logobs[b]), jnp.asarray(lt.numpy()))
        assert np.array_equal(got[b], ref), b
    score = rng.uniform(0.0, 1.0, (2, 120, 64))
    voiced = rng.uniform(size=(2, 120)) > 0.2
    got = tl1._rd_viterbi(torch.tensor(score), torch.tensor(voiced),
                          10.0).numpy()
    for b in range(2):
        ref = jl1._rd_viterbi(jnp.asarray(score[b]), jnp.asarray(voiced[b]),
                              10.0)
        assert np.asarray(ref).dtype.kind == "i"
        assert np.array_equal(got[b], np.asarray(ref)), b
    path, last = kernels.viterbi_scan_ref(torch.tensor(logobs), lt, True,
                                          scores=True)
    assert last.dtype == torch.float64
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES
    print("FP64-VITERBI-OK")
""")


def test_fp64_routes_to_the_twin():
    """Under LLSM_FP64=1 (a subprocess: the knob is read at import),
    f0.viterbi and _rd_viterbi take the twin explicitly, never the
    kernel's wrapper (which would refuse float64), in float64, and their
    paths equal the JAX package's float64 scans."""
    env = dict(os.environ, LLSM_FP64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO,
                                                              "tests")]))
    out = subprocess.run([sys.executable, "-c", FP64_ROUTE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert "FP64-VITERBI-OK" in out.stdout, out.stderr[-3000:]


@pytest.mark.parametrize("N,S,geometry", [
    # (P, C, threads, lt mode, backpointers in shared memory, bytes, bytes a
    # backpointer): 4 (2 P C + 64 + 16 S) score, maxima and ring bytes,
    # then lt in mode 1, then the backpointers
    (1600, 97, (2, 52, 224, 0, True, 7296 + 1599 * 97, 1)),
    (1600, 64, (2, 32, 128, 0, True, 4864 + 1599 * 64, 1)),
    (1, 97, (2, 52, 224, 0, True, 7296, 1)),
    (2, 2, (2, 4, 32, 0, True, 448 + 2, 1)),
    (100, 12, (2, 8, 32, 0, True, 1152 + 99 * 12, 1)),     # each C in
    (100, 24, (2, 16, 64, 0, True, 2048 + 99 * 24, 1)),    # registers
    (100, 120, (2, 64, 256, 0, True, 8960 + 99 * 120, 1)),
    (6000, 97, (2, 52, 224, 0, False, 7296, 1)),   # 582 KB: device memory
    (2, 200, (4, 64, 800, 1, True, 15104 + 160000 + 200, 1)),  # lt in shared
    (400, 200, (4, 64, 800, 1, False, 15104 + 160000, 1)),     # bp in HBM
    (2, 256, (4, 64, 1024, 2, True, 18688 + 256, 1)),  # lt 256 KB: HBM
    (1200, 256, (4, 64, 1024, 2, False, 18688, 1)),    # neither fits
    # 257 to 2048 states (mode 4, the grid kernel): C = S rounded up to 8,
    # the uint16 backpointers in device memory at any N; threads and bytes
    # are the grid's (_viterbi_grid)
    (300, 257, (1, 264, None, 4, False, None, 2)),
    (3200, 257, (1, 264, None, 4, False, None, 2)),
    (2, 512, (1, 512, None, 4, False, None, 2)),
    (1600, 1025, (1, 1032, None, 4, False, None, 2)),
    (1, 2048, (1, 2048, None, 4, False, None, 2)),
    # past 2048 states (mode 5, the stream kernel): C = S rounded up to 8,
    # the uint16 backpointers in device memory at any N; threads and bytes
    # are the grid's (_viterbi_stream)
    (2, 2049, (1, 2056, None, 5, False, None, 2)),
    (300, 2049, (1, 2056, None, 5, False, None, 2)),
    (20, 4000, (1, 4000, None, 5, False, None, 2)),
    (1, 29024, (1, 29024, None, 5, False, None, 2)),    # the most states
])
def test_viterbi_geometry_by_hand(N, S, geometry):
    """kernels._viterbi_geometry: 2 lanes a state and lt's column slice
    in registers up to S = 128 (mode 0; 52 slots a lane for the tracker's
    97 states), past it 4 lanes and lt in shared memory where S^2
    floats fit in the H100's 232448 bytes (mode 1), else in device memory
    (2); from 257 to 2048 states the grid kernel (mode 4: groups of 8
    source states, its grid from _viterbi_grid); past 2048 the stream
    kernel (mode 5: groups of 8, its grid from _viterbi_stream), up to
    _VITERBI_MAX_STATES = 29024; the backpointers in shared memory where
    they fit beside the rest, uint16 in device memory past 256 states."""
    assert kernels._viterbi_geometry(N, S) == geometry
    grids = {4: lambda B: kernels._viterbi_grid(B, S)[4],
             5: lambda B: kernels._viterbi_stream(B, S)[7]}
    for smem in ([geometry[5]] if geometry[3] not in grids else
                 [grids[geometry[3]](B) for B in (1, 64)]):
        assert smem <= kernels._SMEM_MAX
    assert kernels._VITERBI_MAX_STATES == 29024


@pytest.mark.parametrize("B,S,grid", [
    # (warps, row warps, slices, row blocks, bytes): 2 row warps and 4 row
    # blocks make one pass of 64 rows; 8 warps, so 4 parts of the source
    # states; the parts' maxima 4 x 16 x 16 x 8 bytes
    (64, 257, (8, 2, 17, 4, 4 * 32 * 268 + 4 * 16 * 16 * 8)),
    (64, 385, (8, 2, 25, 4, 4 * 32 * 396 + 4 * 16 * 16 * 8)),
    (64, 512, (8, 2, 32, 4, 4 * 32 * 516 + 4 * 16 * 16 * 8)),
    # 65 slices leave 2 row blocks: 4 row warps make one pass; 16 warps
    (64, 1025, (16, 4, 65, 2, 4 * 48 * 1036 + 4 * 32 * 16 * 8)),
    (128, 1025, (16, 4, 65, 2, 4 * 48 * 1036 + 4 * 32 * 16 * 8)),
    # a row alone: one row warp, 8 parts
    (1, 1025, (8, 1, 65, 1, 4 * 24 * 1036 + 8 * 8 * 16 * 8)),
    (1, 257, (8, 1, 17, 1, 4 * 24 * 268 + 8 * 8 * 16 * 8)),
    # 128 slices: one row block; 2 row warps' rows would overflow
    (64, 2048, (8, 1, 128, 1, 4 * 24 * 2052 + 8 * 8 * 16 * 8)),
])
def test_viterbi_grid_by_hand(B, S, grid):
    """kernels._viterbi_grid: 16 destination states a block, at most one
    block an SM (132), the fewest passes over the row groups a step with
    the fewest row warps, the other warps parts of the source states."""
    assert kernels._viterbi_grid(B, S) == grid
    assert grid[4] <= kernels._SMEM_MAX
    assert grid[2] * grid[3] <= 132
    with pytest.raises(ValueError, match="SMs"):
        kernels._viterbi_grid(B, 2048, sms=114)


@pytest.mark.parametrize("B,S,grid", [
    # (warps, dest warps, row warps, rows a thread, slices, row blocks,
    # chunk, bytes): 129 slices of 32 states leave one row block, 4 row
    # warps of 16 rows take 64 rows in one pass, the other 4 warps' worth
    # are 4 parts; chunks of 256: 2 x 4 (256 x 32 + 64 x 260) bytes
    (64, 4097, (16, 1, 4, 4, 129, 1, 256, 8 * (256 * 32 + 64 * 260))),
    # 65 slices leave 2 row blocks: 2 row warps, 8 parts, chunks of 256
    (64, 2049, (16, 1, 2, 4, 65, 2, 256, 8 * (256 * 32 + 32 * 260))),
    # 257 32-state slices would pass 132: 64 states a slice; chunks of 256
    # would overflow
    (64, 8193, (16, 2, 4, 4, 129, 1, 128, 8 * (128 * 64 + 64 * 132))),
    # a row alone: a row a thread (4 a warp), 16 parts, chunks of 512
    (1, 2049, (16, 1, 1, 1, 65, 1, 512, 8 * (512 * 32 + 4 * 516))),
    # the most states: 224 a slice, 2 parts; chunks of 128 would overflow
    (1, 29024, (14, 7, 1, 1, 130, 1, 64, 8 * (64 * 224 + 4 * 68))),
    (64, 29024, (14, 7, 2, 4, 130, 1, 64, 8 * (64 * 224 + 32 * 68))),
])
def test_viterbi_stream_by_hand(B, S, grid):
    """kernels._viterbi_stream: the fewest dest warps whose slices are at
    most one block an SM, the fewest passes over the row groups with the
    fewest row warps, the other warps (16 in all) parts of the source
    states, chunks of 4 groups a part (at least 256 states) halved until
    the buffers fit."""
    assert kernels._viterbi_stream(B, S) == grid
    with pytest.raises(ValueError, match="dest warps"):
        kernels._viterbi_stream(B, 29024, sms=10)


@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("S", [2049, 2050, 2055, 3000, 4097, 8193, 12000,
                               20000, 29024])
def test_viterbi_stream_geometry_covers_every_state(B, S):
    """Every destination state falls in exactly one slice of one block
    (dest warps x 8 lanes x 4 destinations) and every row in exactly one
    row group of one row block; the blocks are at most one an SM; the
    shared bytes (two chunk buffers, or the parts' maxima over them) are
    within _SMEM_MAX; the chunks cover the source states (S rounded up to
    8) in ascending order, each a whole number of groups of 8 for each
    part, and each part's groups p, p + P, ... of a chunk cover it once."""
    warps, dw, rw, ra, slices, rb, kc, nbytes = kernels._viterbi_stream(B, S)
    J, rows = 32 * dw, 4 * ra * rw
    parts = warps // (dw * rw)
    assert warps <= 16 and warps == dw * rw * parts
    assert parts & (parts - 1) == 0 and ra in (1, 4)
    owner = torch.zeros(slices * J, dtype=torch.int64)
    for blk in range(slices):
        for w in range(dw):
            for lj in range(8):
                for d in range(4):
                    owner[blk * J + 32 * w + 4 * lj + d] += 1
    assert torch.equal(owner[:S], torch.ones(S, dtype=torch.int64))
    assert slices * J - S < J
    groups = -(-B // rows)
    seen = torch.zeros(groups * rows, dtype=torch.int64)
    for y in range(rb):
        for rg in range(y, groups, rb):
            for w in range(rw):
                for lr in range(4):
                    for a in range(ra):
                        seen[rg * rows + w * 4 * ra + lr + 4 * a] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    assert slices * rb <= 132
    bufs = 8 * (kc * J + rows * (kc + 4))
    assert nbytes == max(bufs, 8 * parts * rows * J)
    assert nbytes <= kernels._SMEM_MAX
    C = -(-S // 8) * 8
    assert kc % (8 * parts) == 0
    order = []
    for c0 in range(0, C, kc):
        n = min(kc, C - c0)
        assert n % 8 == 0
        mine = sorted(g for p in range(parts) for g in range(8 * p, n,
                                                             8 * parts))
        assert mine == list(range(0, n, 8))
        order += list(range(c0, c0 + n))
    assert order == list(range(C))


def _merge(va, ia, vb, ib):
    """viterbi.cu's take_max: b where vb > va, or vb == va and ib < ia."""
    take = (vb > va) | ((vb == va) & (ib < ia))
    return torch.where(take, vb, va), torch.where(take, ib, ia)


def _butterfly(v, i, lanes):
    """Lanes (axis 1) merged by xor 1, 2, 4, ... as __shfl_xor_sync does;
    every lane must end with the same (value, index)."""
    off = 1
    while off < lanes:
        perm = torch.arange(lanes) ^ off
        v, i = _merge(v, i, v[:, perm], i[:, perm])
        off *= 2
    assert torch.equal(v, v[:, :1].expand_as(v))
    assert torch.equal(i, i[:, :1].expand_as(i))
    return v[:, 0], i[:, 0]


def _grid_order_scan(obs, lt, renorm, parts):
    """A plain-torch model of viterbi_grid_kernel's order (lt mode 4),
    float32: the source states in groups of 8 (the scores padded to C = S
    rounded up to 8 with -inf, lt with zero rows); part p of `parts` takes
    the groups p, p + parts, ... in ascending order, each group's maximum
    taken by the part's running best where it is greater (a strict >; the
    best group starts at the part's first), then the first state of the
    best group whose candidate equals that maximum (value and index); the
    parts merged in order by (value, then lowest index); with renorm the
    previous raw scores less their maximum at read time -> (path, last
    scores) as _kernel_order_scan."""
    B, N, S = obs.shape
    C = -(-S // 8) * 8
    G = C // 8
    lt_pad = torch.zeros((C, S), dtype=torch.float32)
    lt_pad[:S] = lt
    pad = torch.full((B, C - S), -float("inf"))
    renormed = lambda r: r - torch.amax(r, -1, keepdim=True) if renorm else r
    raw, back = obs[:, 0], []
    for t in range(1, N):
        grp = (torch.cat([renormed(raw), pad], 1)[:, :, None]
               + lt_pad).reshape(B, G, 8, S)
        gmax = torch.amax(grp, 2)                              # [B, G, S]
        merged = None
        for p in range(parts):
            best = torch.full((B, S), -float("inf"))
            bg = torch.full((B, S), p, dtype=torch.int64)
            for g in range(p, G, parts):
                take = gmax[:, g] > best
                best = torch.where(take, gmax[:, g], best)
                bg = torch.where(take, g, bg)
            if p < G:
                sel = torch.gather(grp, 1, bg[:, None, None, :].expand(
                    B, 1, 8, S))[:, 0]                         # [B, 8, S]
                e = torch.argmax((sel == best[:, None]).to(torch.int8), 1)
                best = torch.gather(sel, 1, e[:, None])[:, 0]
                idx = 8 * bg + e
            else:                                   # a part with no group
                idx = torch.full((B, S), 8 * p, dtype=torch.int64)
            merged = (best, idx) if merged is None else _merge(*merged, best,
                                                               idx)
        best, arg = merged
        assert int(arg.max()) < S
        back.append(arg)
        raw = best + obs[:, t]
    return _final_and_backtrace(renormed(raw), back)


def _stream_order_scan(obs, lt, renorm, parts, chunk):
    """A plain-torch model of viterbi_stream_kernel's order (lt mode 5),
    float32: the source states (padded to C = S rounded up to 8 with -inf
    scores and zero lt rows) taken chunk by chunk in ascending order, and
    in each chunk part p of `parts` its groups of 8 states p, p + parts,
    ... (chunk-local, ascending), each group's maximum taken by the part's
    running best where it is greater (a strict >), the running (best, first
    group) carried from chunk to chunk (a part with no group: -inf at 8 p);
    the parts merged in order by (value, then lowest group); then the
    first state of the winning group whose candidate equals the maximum,
    its value that candidate's; with renorm the previous raw scores less
    their maximum at read time -> (path, last scores) as
    _kernel_order_scan."""
    B, N, S = obs.shape
    C = -(-S // 8) * 8
    lt_pad = torch.zeros((C, S), dtype=torch.float32)
    lt_pad[:S] = lt
    pad = torch.full((B, C - S), -float("inf"))
    renormed = lambda r: r - torch.amax(r, -1, keepdims=True) if renorm else r
    raw, back = obs[:, 0], []
    for t in range(1, N):
        sc = torch.cat([renormed(raw), pad], 1)                # [B, C]
        best = [torch.full((B, S), -float("inf")) for _ in range(parts)]
        grp = [torch.full((B, S), 8 * p, dtype=torch.int64)
               for p in range(parts)]
        for c0 in range(0, C, chunk):
            n = min(chunk, C - c0)
            gmax = torch.amax((sc[:, c0:c0 + n, None] + lt_pad[c0:c0 + n])
                              .reshape(B, n // 8, 8, S), 2)
            for p in range(parts):
                for g in range(8 * p, n, 8 * parts):
                    take = gmax[:, g // 8] > best[p]
                    best[p] = torch.where(take, gmax[:, g // 8], best[p])
                    grp[p] = torch.where(take, c0 + g, grp[p])
        # the parts merged in order by (value, then lowest group), then the
        # first state of the winning group that reaches its maximum
        bv, g0 = best[0], grp[0]
        for p in range(1, parts):
            bv, g0 = _merge(bv, g0, best[p], grp[p])
        idx = g0[:, None, :] + torch.arange(8)[None, :, None]
        cand = (torch.gather(sc[:, :, None].expand(B, C, S), 1, idx)
                + torch.gather(lt_pad[None].expand(B, C, S), 1, idx))
        e = torch.argmax((cand == bv[:, None]).to(torch.int8), 1)
        merged = (torch.gather(cand, 1, e[:, None])[:, 0], g0 + e)
        bv, arg = merged
        assert int(arg.max()) < S
        back.append(arg)
        raw = bv + obs[:, t]
    return _final_and_backtrace(renormed(raw), back)


def _final_and_backtrace(final, back):
    """viterbi.cu's final argmax (lane l of warp 0 the states l, l + 32,
    ... in ascending order, then 32 lanes by xor) and the backtrace along
    back -> (path, final)."""
    B, S = final.shape
    N = len(back) + 1
    lanes = torch.full((B, 32 * -(-S // 32)), -float("inf"))
    lanes[:, :S] = final
    lanes = lanes.reshape(B, -1, 32)
    lv, lj = lanes[:, 0], torch.arange(32).expand(B, 32).clone()
    lj[:, S:] = 1 << 30
    for r in range(1, lanes.shape[1]):
        take = lanes[:, r] > lv
        lv = torch.where(take, lanes[:, r], lv)
        lj = torch.where(take, 32 * r + torch.arange(32), lj)
    _, g = _butterfly(lv, lj, 32)
    path = torch.empty((B, N), dtype=torch.int64)
    path[:, N - 1] = g
    for t in range(N - 2, -1, -1):
        g = torch.gather(back[t], 1, g[:, None])[:, 0]
        path[:, t] = g
    return path, final


def _kernel_order_scan(obs, lt, renorm, P):
    """A plain-torch model of viterbi.cu's order, float32: lane p of a
    destination covers the source states i = 4 (m P + p) + e (m < C / 4,
    e < 4; the scores padded to P C with -inf, lt with zero rows), each e
    a partial maximum over ascending m with a strict >, the partials
    merged (0, 1), (2, 3), then the pair, then the P lanes by xor; with
    renorm the previous raw scores less their maximum at read time; the
    final argmax as warp 0 takes it (lane l the states l, l + 32, ... in
    ascending order, then 32 lanes by xor); then the backtrace.  C is the
    kernel's where P is the kernel's P at S, else the least multiple of 4
    with P C >= S.  Where S takes the grid kernel (lt mode 4: 257 to 2048
    states), its model with P parts of the source states
    (_grid_order_scan).  -> (path [B, N], last scores [B, S])."""
    B, N, S = obs.shape
    geo = kernels._viterbi_geometry(N, S)
    if geo[3] == 4:
        return _grid_order_scan(obs, lt, renorm, P)
    C = geo[1] if geo[0] == P else -(-S // (4 * P)) * 4
    M, SP = C // 4, P * C
    lt_pad = torch.zeros((SP, S), dtype=torch.float32)
    lt_pad[:S] = lt
    p_of = torch.arange(P)[None, :, None, None]
    e_of = torch.arange(4)[None, None, :, None]
    pad = torch.full((B, SP - S), -float("inf"))
    renormed = lambda r: r - torch.amax(r, -1, keepdim=True) if renorm else r
    raw, back = obs[:, 0], []
    for t in range(1, N):
        cand = (torch.cat([renormed(raw), pad], 1)[:, :, None]
                + lt_pad).reshape(B, M, P, 4, S)
        bv, bm = cand[:, 0], torch.zeros((B, P, 4, S), dtype=torch.int64)
        for mm in range(1, M):
            take = cand[:, mm] > bv
            bv = torch.where(take, cand[:, mm], bv)
            bm = torch.where(take, mm, bm)
        bi = 4 * (bm * P + p_of) + e_of
        v01 = _merge(bv[:, :, 0], bi[:, :, 0], bv[:, :, 1], bi[:, :, 1])
        v23 = _merge(bv[:, :, 2], bi[:, :, 2], bv[:, :, 3], bi[:, :, 3])
        best, arg = _butterfly(*_merge(*v01, *v23), P)
        assert int(arg.max()) < S
        back.append(arg)
        raw = best + obs[:, t]
    return _final_and_backtrace(renormed(raw), back)


def _order_inputs(S, renorm, seed, B=2, N=40):
    """Scores in eighths (ties) with -inf entries (10%; every frame keeps
    finite ones) and all-tied rows: with renorm obs in [-12, 0) whose frames
    8-11 are one constant each and lt in eighths with -inf off its
    diagonal (10%); without, layer 1's scores in [0, 1) with -inf entries,
    voicing with an unvoiced stretch (frames 10-19: all-zero rows once
    masked) -> (obs, lt, score, voiced), score and voiced None with
    renorm."""
    rng = np.random.default_rng(seed)
    if renorm:
        obs = _eighths(rng, (B, N, S), -12.0, 0.0)
        obs[:, 8:12] = obs[:, 8:12, :1]
        obs[rng.uniform(size=obs.shape) < 0.1] = -np.inf
        obs[:, :, 0] = np.where(np.isinf(obs[:, :, 0]), -1.0, obs[:, :, 0])
        lt = _eighths(rng, (S, S), -4.0, 0.0)
        off = (rng.uniform(size=(S, S)) < 0.1) & ~np.eye(S, dtype=bool)
        lt[off] = -np.inf
        return T(obs), T(lt), None, None
    score = _eighths(rng, (B, N, S), 0.0, 1.0)
    score[rng.uniform(size=score.shape) < 0.1] = -np.inf
    score[:, :, 0] = np.where(np.isinf(score[:, :, 0]), 0.5, score[:, :, 0])
    voiced = rng.uniform(size=(B, N)) > 0.2
    voiced[:, 10:20] = False
    obs = np.where(voiced[..., None], score, 0.0).astype(np.float32)
    return T(obs), -_rd_pen(S), T(score), T(voiced)


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("S", [2, 64, 97, 256, 257, 385, 512, 1025])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_kernel_order_equals_the_twin_and_the_jax_scans(P, S, renorm):
    """The model of viterbi.cu's lane and partial order above, at P lanes
    a state (from 257 states the grid kernel's: groups of 8 source states
    in P parts, as _viterbi_grid takes 8 parts for a row alone and 4 for
    64 rows; 385 the tracker's at nbins 384), on scores in eighths with
    ties, -inf entries and all-tied rows (57 groups at 1025 states, so
    each part's groups interleave): paths and last scores equal
    kernels.viterbi_scan_ref's bit for
    bit, and its paths the JAX package's (the tracker's renormalized scan
    under the same lt; _rd_viterbi on the same scores and voicing, lt =
    -pen); without renorm also under an lt in eighths with -inf entries,
    as the tracker's inputs, against the twin."""
    obs, lt, score, voiced = _order_inputs(S, renorm, 100 * S + 10 * P
                                           + renorm)
    path, final = _kernel_order_scan(obs, lt, renorm, P)
    ref_path, ref_final = kernels.viterbi_scan_ref(obs, lt, renorm,
                                                   scores=True)
    assert torch.isfinite(ref_final).any(-1).all()
    assert torch.equal(path, ref_path) and torch.equal(final, ref_final)
    for b in range(obs.shape[0]):
        if renorm:
            ref = _jax_viterbi(jnp.asarray(obs[b].numpy()),
                               jnp.asarray(lt.numpy()))
        else:
            ref = np.asarray(jl1._rd_viterbi(jnp.asarray(score[b].numpy()),
                                             jnp.asarray(voiced[b].numpy()),
                                             LAM))
        np.testing.assert_array_equal(path[b].numpy(), ref)
    if not renorm:
        tracker_obs, tracker_lt, _, _ = _order_inputs(S, True, S + P)
        path, final = _kernel_order_scan(tracker_obs, tracker_lt, False, P)
        ref_path, ref_final = kernels.viterbi_scan_ref(
            tracker_obs, tracker_lt, False, scores=True)
        assert torch.equal(path, ref_path) and torch.equal(final, ref_final)
    if S > 2:
        assert _ties(obs.numpy(), lt.numpy(), renorm) > 0


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("S", [2049, 4097])
@pytest.mark.parametrize("rows", [1, 64])
def test_stream_order_equals_the_twin_and_the_jax_scans(rows, S, renorm):
    """The model of viterbi_stream_kernel's chunked order above, with the
    parts and chunk _viterbi_stream takes for a row alone (16 parts,
    chunks of 512) and for 64 rows (8 parts of 256-state chunks at 2049
    states, 4 of 128 at 4097), on scores in eighths with ties, -inf
    entries and all-tied rows over a few frames: paths and last scores
    equal kernels.viterbi_scan_ref's bit for bit, and its paths the JAX
    package's (the tracker's renormalized scan; _rd_viterbi on the same
    scores and voicing)."""
    warps, dw, rw, _, _, _, chunk, _ = kernels._viterbi_stream(rows, S)
    parts = warps // (dw * rw)
    obs, lt, score, voiced = _order_inputs(S, renorm, S + rows + renorm,
                                           N=12)
    path, final = _stream_order_scan(obs, lt, renorm, parts, chunk)
    ref_path, ref_final = kernels.viterbi_scan_ref(obs, lt, renorm,
                                                   scores=True)
    assert torch.equal(path, ref_path) and torch.equal(final, ref_final)
    for b in range(obs.shape[0]):
        if renorm:
            ref = _jax_viterbi(jnp.asarray(obs[b].numpy()),
                               jnp.asarray(lt.numpy()))
        else:
            ref = np.asarray(jl1._rd_viterbi(jnp.asarray(score[b].numpy()),
                                             jnp.asarray(voiced[b].numpy()),
                                             LAM))
        np.testing.assert_array_equal(path[b].numpy(), ref)
    assert _ties(obs.numpy(), lt.numpy(), renorm) > 0


def test_tracker_at_2048_bins_gives_the_jax_path():
    """The F0 tracker at nbins = 2048 (2049 states: the stream kernel's
    range on the card): the port's Viterbi (f0.viterbi, the twin on the
    CPU) on the JAX tracker's own observations and transitions gives the
    JAX scan's path exactly, on two utterances at once (one with an
    unvoiced tail)."""
    from libllsm2_tpu.ops import f0 as jf0
    from test_torch_f0 import _jax_front_end, _utt
    cfg = jf0.F0Config(nbins=2048)
    los, paths = [], []
    for seed, kw in ((0, {}), (1, dict(noise_level=0.1,
                                       unvoiced_tail_frac=0.3))):
        x, _ = _utt(0.4, seed, **kw)
        _, lo, lt = _jax_front_end(cfg, x)
        los.append(lo)
        paths.append(_jax_viterbi(jnp.asarray(lo), lt))
    lt_t = tf0._tables(tf0.F0Config(nbins=2048), "cpu")["lt"]
    assert lt_t.shape == (2049, 2049)
    got = tf0.viterbi(T(np.stack(los)), lt_t).numpy()
    np.testing.assert_array_equal(got, np.stack(paths))
    assert (got == 2048).any() and (got < 2048).any()


def test_chip_smoke_counts_viterbi_by_hand():
    """chip_smoke.kernel_ops for viterbi_scan: B (N - 1) S^2 x 2 (an add
    and a compare a candidate), 2 x 99 x 97^2 x 2 at [2, 100, 97] and 0
    at N = 1; kernel_bytes: obs, lt and the path once, and the uint8
    backpointers, 2 x 99 x 97 bytes."""
    import chip_smoke
    obs, lt = torch.zeros(2, 100, 97), torch.zeros(97, 97)
    assert chip_smoke.kernel_ops(torch, "viterbi_scan", (obs, lt, True),
                                 {}) == 2 * 99 * 97 * 97 * 2
    assert chip_smoke.kernel_ops(torch, "viterbi_scan",
                                 (obs[:, :1], lt, True), {}) == 0
    path = torch.zeros(2, 100, dtype=torch.int64)
    assert chip_smoke.kernel_bytes(torch, "viterbi_scan", (obs, lt, True),
                                   {}, path) \
        == 4 * 2 * 100 * 97 + 4 * 97 * 97 + 8 * 2 * 100 + 2 * 99 * 97
