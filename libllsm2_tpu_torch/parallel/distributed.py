"""Multi-process initialization (counterpart of
libllsm2_tpu/parallel/distributed.py).

The port runs one process a rank under torch.distributed.  Launch the
ranks with ``torchrun --nproc-per-node N script.py`` (which exports RANK,
WORLD_SIZE, MASTER_ADDR and friends) and call initialize_multihost() with
no arguments, or start them yourself and give each its rendezvous:

    initialize_multihost("tcp://localhost:29500", num_processes=4,
                         process_id=rank)

then build meshes (global_mesh, or parallel.mesh.make_*_mesh).

Backend rule (choose_backend): "nccl" when every local rank has a card of
its own; "gloo" on the CPU and for ranks that share a card (NCCL refuses
two ranks of one communicator on one device).
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist


def choose_backend(local_ranks: int | None = None) -> str:
    """"nccl" when there is a card for each of the host's `local_ranks`
    (torchrun's LOCAL_WORLD_SIZE by default), else "gloo"."""
    if not torch.cuda.is_available():
        return "gloo"
    if local_ranks is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", 1)))
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         timeout_s: float = 600.0) -> None:
    """Wire this process into the cluster (idempotent: a no-op once
    torch.distributed is initialized).

    coordinator_address: "host:port", "tcp://host:port" or
    "file:///path" (a FileStore); with it, num_processes and process_id
    are required and a failure raises -- an explicit cluster spec never
    becomes a silent single-process run.  With no address, torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) is used when
    present; without it this is a single-process run and nothing happens.
    The backend is choose_backend's (num_processes ranks on this host
    with an explicit address); timeout_s bounds every collective's
    wait."""
    if dist.is_initialized():
        return
    kw = dict(timeout=timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        addr = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(choose_backend(num_processes),
                                init_method=addr, world_size=num_processes,
                                rank=process_id, **kw)
        return
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(choose_backend(), init_method="env://",
                                **kw)


def global_mesh(frame_parallel: int = 1, device=None):
    """Mesh (batch, frame) over every rank of the cluster (call after
    initialize_multihost)."""
    from .mesh import make_mesh
    return make_mesh(None, frame_parallel=frame_parallel, device=device)
