"""Device meshes over torch.distributed ranks, and their collectives
(counterpart of libllsm2_tpu/parallel/mesh.py).

The JAX package runs one process over many devices and lets GSPMD or
shard_map place the work on a jax.sharding.Mesh.  The port runs one
process a rank under torch.distributed: every rank calls the same
function with the same arguments and computes its share (SPMD).  A
`Mesh` here is this rank's view of a grid of ranks: the grid's shape by
axis name (``mesh.shape[FRAME_AXIS]``, as in JAX), this rank's coordinate
on each axis, and one process group an axis (the ranks that differ from
this one on that axis alone).  Every rank creates every group, in the
same order, as ``dist.new_group`` requires.

The collectives are written once, here, over a mesh axis, under the names
of the JAX primitives they replace: all_gather, psum / pmean, all_to_all
and ppermute, and pvary (JAX's marking of a replicated value as varying
over an axis; Megatron's "f").  Each is a torch.autograd.Function with the
transpose JAX gives its primitive under shard_map's replication tracking:
psum's is the identity (its output is replicated: every rank holds the
global value and counts it once), pvary's is a psum, all_gather's takes
this rank's slice of the replicated cotangent, all_to_all's swaps its
split and concat axes, ppermute's is the inverse permutation.

Transport: the tensors go to the backend as they are.  Gloo's documented
CUDA collectives are all_reduce and broadcast (recent versions also take
CUDA tensors for all_gather and all_to_all: they did on the H100's
PyTorch); where gloo refuses a CUDA tensor, the collective stages it
through pinned host memory (the compute stream synchronized before the
copy out, the result copied back to the card) and remembers the refusal
(`gloo_cuda`).  That is a transport, not a fallback: the compute stays
on the card.  Each mesh counts the bytes its collectives move at this
rank (`moved`, by primitive: the bytes a rank sends plus the bytes it
receives) and the bytes staged through the host (`staged`), and keeps a
log of each call (`log`: primitive, axis, bytes of the result).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BATCH_AXIS = "batch"
FRAME_AXIS = "frame"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"


def local_device(device=None) -> torch.device:
    """This rank's device: `device` when given, else
    cuda:(local rank % device count), the local rank from torchrun's
    LOCAL_RANK or, without it, the global rank."""
    if device is not None:
        return torch.device(device)
    rank = int(os.environ.get("LOCAL_RANK",
                              dist.get_rank() if dist.is_initialized() else 0))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "ranks on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


class Mesh:
    """This rank's view of a grid of ranks (row-major over `axis_names`, as
    the JAX package reshapes its device list).

    shape: {axis: size}; coords: {axis: this rank's index}; device: where
    this rank's tensors live; backend: the process group's backend, or
    None for a one-process mesh (every axis of size 1, every collective
    the identity)."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int],
                 device=None):
        self.axis_names = tuple(axis_names)
        n = int(np.prod(sizes))
        world = dist.get_world_size() if dist.is_initialized() else 1
        if n != world:
            raise ValueError(
                f"a mesh of {n} ranks in a world of {world}: the port runs "
                "one rank a device (initialize_multihost, or torchrun "
                "--nproc-per-node N)")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              map(int, sizes)))
        rank = dist.get_rank() if dist.is_initialized() else 0
        grid = np.arange(n).reshape(tuple(sizes))
        pos = np.argwhere(grid == rank)[0]
        self.coords = dict(zip(self.axis_names, map(int, pos)))
        self.backend = dist.get_backend() if dist.is_initialized() else None
        self.device = local_device(device)
        self.groups = {}
        for i, ax in enumerate(self.axis_names):
            mine = None
            if world > 1:
                # every line of the grid along axis i is a group; every
                # rank creates all of them, in the same order
                lines = np.moveaxis(grid, i, -1).reshape(-1, sizes[i])
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if rank in line:
                        mine = g
            self.groups[ax] = mine
        self.moved: Dict[str, int] = {}
        self.staged = 0
        self.log = []
        self.gloo_cuda: Dict[str, bool] = {}

    def index(self, axis: str) -> int:
        """This rank's coordinate on `axis` (JAX's lax.axis_index)."""
        return self.coords[axis]

    def reset_counts(self) -> None:
        self.moved, self.staged, self.log = {}, 0, []

    def _count(self, op: str, axis: str, sent: int, received: int) -> None:
        self.moved[op] = self.moved.get(op, 0) + sent + received
        self.log.append((op, axis, received))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, coords={self.coords}, "
                f"backend={self.backend}, device={self.device})")


def make_mesh(n_devices: Optional[int] = None, frame_parallel: int = 1,
              device=None) -> Mesh:
    """Mesh (batch, frame) over the world's ranks; frame_parallel > 1
    carves a frame-parallel axis for sharding the frames of single long
    utterances (parallel.seqparallel)."""
    n = _world(n_devices)
    if n % frame_parallel:
        raise ValueError(f"{n} ranks do not split into frame_parallel="
                         f"{frame_parallel}")
    return Mesh((BATCH_AXIS, FRAME_AXIS), (n // frame_parallel,
                                           frame_parallel), device)


def make_tp_mesh(n_devices: Optional[int] = None, model_parallel: int = 2,
                 device=None) -> Mesh:
    """Mesh (batch, model) for tensor-parallel training of the neural frame
    model (models.neural): data parallelism over the batch axis, the hidden
    dimension sharded over the model axis (neural.tp_param_specs)."""
    n = _world(n_devices)
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel}")
    return Mesh((BATCH_AXIS, MODEL_AXIS), (n // model_parallel,
                                           model_parallel), device)


def make_pipe_mesh(n_stages: Optional[int] = None, device=None) -> Mesh:
    """1-D ("pipe",) mesh for pipeline-parallel training
    (parallel.pipeline): each rank holds one contiguous stage."""
    return Mesh((PIPE_AXIS,), (_world(n_stages),), device)


def make_expert_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """1-D ("expert",) mesh for expert-parallel MoE training
    (parallel.expert): tokens and experts sharded over the same axis."""
    return Mesh((EXPERT_AXIS,), (_world(n_devices),), device)


def _world(n: Optional[int]) -> int:
    return (dist.get_world_size() if dist.is_initialized() else 1) \
        if n is None else int(n)


def batch_sharding(mesh: Mesh) -> dict:
    """Layout of [B, ...] arrays, {dim: the mesh axis it splits over}: the
    batch over the batch axis (the JAX package's NamedSharding(mesh,
    P("batch")))."""
    return {0: BATCH_AXIS}


def batch_frame_sharding(mesh: Mesh) -> dict:
    """Layout of [B, N, ...] arrays: batch x frame split."""
    return {0: BATCH_AXIS, 1: FRAME_AXIS}


def replicated(mesh: Mesh) -> dict:
    """Layout of arrays every rank holds whole."""
    return {}


def local_block(v, mesh: Mesh, layout: dict):
    """This rank's block of v (a tensor or numpy array) under `layout`
    ({dim: axis}, each dim split evenly over its mesh axis)."""
    for dim, axis in layout.items():
        n, i = mesh.shape[axis], mesh.index(axis)
        if v.shape[dim] % n:
            raise ValueError(f"{v.shape[dim]} entries of dim {dim} do not "
                             f"split over {n} ranks")
        r = v.shape[dim] // n
        v = v[(slice(None),) * dim + (slice(i * r, (i + 1) * r),)]
    return v


def shard_rows(v, mesh: Mesh, axis: Optional[str] = None):
    """This rank's block of rows of v (a tensor or numpy array, leading axis
    split evenly over `axis`, by default batch_sharding's), as a tensor on
    the mesh's device."""
    layout = batch_sharding(mesh) if axis is None else {0: axis}
    return torch.as_tensor(local_block(v, mesh, layout)).to(mesh.device)


def shard_stacked(local, params, specs: dict, mesh: Mesh) -> None:
    """Set local's stacked parameters (attribute group_leaf) to this rank's
    block of params' under specs; the rest stays as loaded."""
    with torch.no_grad():
        for group, leaves in specs.items():
            for leaf, spec in (leaves or {}).items():
                if spec is not None:
                    name = f"{group}_{leaf}"
                    v = local_block(getattr(params, name).detach(), mesh,
                                    {spec[0]: spec[1]})
                    setattr(local, name, torch.nn.Parameter(v.clone()))


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every [B, ...] leaf of a tree (tuples, lists,
    dicts of tensors or numpy arrays): the counterpart of the JAX
    package's placement with the batch axis sharded."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(v, mesh) for v in tree)
    if tree is None:
        return None
    return shard_rows(tree, mesh)


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------

def _refused(e: RuntimeError) -> bool:
    """A gloo collective that will not take this device's tensors (its
    check fails before any communication, alike on every rank)."""
    return "device" in str(e).lower()


def _transport(mesh: Mesh, op: str, run, *ts):
    """run(*ts) -> the collective's output.  Under gloo a CUDA tensor that
    gloo refuses for op is staged through pinned host memory instead (the
    compute stream synchronized before the copy out, the result copied
    back to the card); the refusal is remembered on the mesh
    (`gloo_cuda`: op -> True where gloo took the CUDA tensors)."""
    dev = ts[0].device
    gloo_cuda = mesh.backend == "gloo" and dev.type == "cuda"
    if gloo_cuda and mesh.gloo_cuda.get(op) is False:
        out = run(*(_to_host(mesh, t) for t in ts))
        mesh.staged += out.numel() * out.element_size()
        return out.to(dev, non_blocking=True)
    try:
        out = run(*ts)
    except RuntimeError as e:
        if not (gloo_cuda and _refused(e)):
            raise
        mesh.gloo_cuda[op] = False
        return _transport(mesh, op, run, *ts)
    if gloo_cuda:
        mesh.gloo_cuda[op] = True
    return out


def _to_host(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    # the compute stream finishes t before the copy out
    torch.cuda.current_stream(t.device).synchronize()
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    mesh.staged += t.numel() * t.element_size()
    return h


def _real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


def _raw_all_gather(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """[S, *t.shape]: every rank's t along `axis`, in axis order."""
    n = mesh.shape[axis]
    if n == 1:
        return t[None].clone()
    src = _real(t.contiguous())
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor

    def run(a):
        out = a.new_empty((n * a.numel(),))
        gather(out, a.reshape(-1), group=mesh.groups[axis])
        return out

    out = _transport(mesh, "all_gather", run, src)
    out = out.reshape((n,) + tuple(src.shape))
    nb = src.numel() * src.element_size()
    mesh._count("all_gather", axis, nb * (n - 1), nb * n)
    return torch.view_as_complex(out) if t.is_complex() else out


def _raw_all_reduce(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    n = mesh.shape[axis]
    if n == 1:
        return t.clone()

    def run(a):
        out = a.clone()
        dist.all_reduce(out, group=mesh.groups[axis])
        return out

    out = _transport(mesh, "all_reduce", run, _real(t).contiguous())
    nb = out.numel() * out.element_size()
    mesh._count("psum", axis, nb, nb)
    return torch.view_as_complex(out) if t.is_complex() else out


def _raw_all_to_all(mesh: Mesh, axis: str, t: torch.Tensor,
                    send: Sequence[int], recv: Sequence[int]) -> torch.Tensor:
    """Flat all_to_all: this rank sends t's flat elements in chunks of
    send[j] to rank j of the axis and receives recv[j] from each -> the
    received elements, concatenated in axis order (flat)."""
    src = _real(t.contiguous()).reshape(-1)
    k = 2 if t.is_complex() else 1
    send = [k * s for s in send]
    recv = [k * r for r in recv]

    def run(a):
        out = a.new_empty((sum(recv),))
        dist.all_to_all_single(out, a, output_split_sizes=list(recv),
                               input_split_sizes=list(send),
                               group=mesh.groups[axis])
        return out

    out = _transport(mesh, "all_to_all", run, src)
    me = mesh.index(axis)
    es = src.element_size()
    mesh._count("all_to_all", axis, (sum(send) - send[me]) * es,
                (sum(recv) - recv[me]) * es)
    return torch.view_as_complex(out.reshape(-1, 2)) if t.is_complex() \
        else out


# ---------------------------------------------------------------------------
# the collectives (autograd Functions, JAX's transposes)
# ---------------------------------------------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.len = x.shape[dim]
        g = _raw_all_gather(mesh, axis, x)            # [S, ...]
        g = torch.movedim(g, 0, dim)
        return g.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 1:])

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.len, ctx.len), None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _raw_all_reduce(mesh, axis, x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Pvary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(ctx.mesh, ctx.axis, g), None, None


def _all_to_all_fwd(mesh, axis, x, split_dim, concat_dim):
    n = mesh.shape[axis]
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: axis {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    if n == 1:
        return x.clone()
    # chunk j of split_dim goes to rank j: lay the chunks out first
    xs = x.reshape(x.shape[:split_dim] + (n, x.shape[split_dim] // n)
                   + x.shape[split_dim + 1:])
    xs = torch.movedim(xs, split_dim, 0).contiguous()     # [n, ...chunk]
    chunk = xs.shape[1:]
    c = int(np.prod(chunk))
    out = _raw_all_to_all(mesh, axis, xs, [c] * n, [c] * n).reshape(
        (n,) + tuple(chunk))
    # the received chunks, in source order, concatenated on concat_dim
    out = torch.movedim(out, 0, concat_dim)
    shape = list(chunk)
    shape[concat_dim] *= n
    return out.reshape(shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return _all_to_all_fwd(mesh, axis, x, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (_all_to_all_fwd(mesh, axis, g.contiguous(), concat_dim,
                                split_dim), None, None, None, None)


def _ppermute_fwd(mesh, axis, x, perm):
    n = mesh.shape[axis]
    me = mesh.index(axis)
    dst = {s: d for s, d in perm}
    src = {d: s for s, d in perm}
    if len(dst) != len(perm) or len(src) != len(perm):
        raise ValueError(f"ppermute: {perm} is not a permutation")
    if n == 1:
        return x.clone() if src.get(0) == 0 else torch.zeros_like(x)
    c = x.numel()
    send = [c if dst.get(me) == j else 0 for j in range(n)]
    recv = [c if src.get(me) == j else 0 for j in range(n)]
    out = _raw_all_to_all(mesh, axis, x if me in dst else x.reshape(-1)[:0],
                          send, recv)
    if me not in src:             # no source: zeros, as lax.ppermute
        return torch.zeros_like(x)
    return out.reshape(x.shape)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, tuple((d, s) for s, d in perm))
        return _ppermute_fwd(mesh, axis, x, perm)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, inv = ctx.args
        return _ppermute_fwd(mesh, axis, g.contiguous(), inv), None, None, \
            None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str,
               dim: int = 0) -> torch.Tensor:
    """lax.all_gather(x, axis, axis=dim, tiled=True): every rank's x along
    the mesh axis, concatenated on `dim` in axis order."""
    return _AllGather.apply(x, mesh, axis, dim % x.dim())


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """lax.psum over the mesh axis."""
    return _Psum.apply(x, mesh, axis)


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """lax.pmean over the mesh axis."""
    return psum(x, mesh, axis) / mesh.shape[axis]


def pvary(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """A replicated value entering per-rank computation (lax.pvary;
    Megatron's f): the identity forward, its gradient summed over the
    axis."""
    return _Pvary.apply(x, mesh, axis)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True): chunk j
    of x's split_dim goes to rank j; the chunks received are concatenated
    on concat_dim in source order."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """lax.ppermute: x goes from rank s to rank d for each (s, d) in perm
    (coordinates on the axis); a rank no pair sends to gets zeros."""
    return _Ppermute.apply(x, mesh, axis, tuple(map(tuple, perm)))


def all_reduce_grads(params, mesh: Mesh, axis: str) -> None:
    """Sum each parameter's gradient over the mesh axis in place (the data-
    parallel gradient: every rank's loss counts its own rows), one
    collective for all of them."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads or mesh.shape[axis] == 1:
        return
    flat = _raw_all_reduce(mesh, axis, torch.cat([g.reshape(-1)
                                                  for g in grads]))
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
