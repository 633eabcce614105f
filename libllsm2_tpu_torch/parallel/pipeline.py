"""Pipeline-parallel training of the neural frame model's residual trunk
(counterpart of libllsm2_tpu/parallel/pipeline.py).

A GPipe schedule over a 1-D ("pipe",) mesh of ranks: each rank holds one
contiguous stage of the trunk (n_blocks / n_stages stacked residual
blocks); activations hop to the next stage with ppermute.  The backward
pass needs no hand-written schedule: autograd runs back through the
collectives, ppermute's gradient being the inverse permutation (the
reverse pipeline).

Model: entry dense (dims -> hidden, replicated; computed on every stage)
-> n_blocks residual blocks (hidden -> hidden, the pipelined trunk) ->
exit dense (hidden -> dims, replicated).  The boundary layers are tiny:
redundant compute beats a pipeline bubble.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models import neural
from ..models.neural import _fp32_matmul, dense, gelu
from .mesh import PIPE_AXIS, Mesh, ppermute, psum, pvary, shard_stacked


@dataclasses.dataclass(frozen=True)
class TrunkConfig:
    dims: int                 # coder vector size (in == out)
    hidden: int = 128
    n_blocks: int = 8         # residual trunk length; n_stages must divide it
    n_micro: int = 4          # microbatches a step; the batch must divide
    lr: float = 1e-3
    compute_dtype: Any = torch.float32


class Trunk(nn.Module):
    """entry, blocks_w [n, hidden, hidden] (nn.Linear's [out, in] layout),
    blocks_b [n, hidden], exit; a pipeline stage holds its slice of the
    blocks (stage, n_stages)."""

    def __init__(self, cfg: TrunkConfig, gen: torch.Generator):
        super().__init__()
        blocks = [neural._linear(cfg.hidden, cfg.hidden, gen)
                  for _ in range(cfg.n_blocks)]
        self.entry = neural._linear(cfg.dims, cfg.hidden, gen)
        self.exit = neural._linear(cfg.hidden, cfg.dims, gen)
        self.blocks_w = nn.Parameter(torch.stack([b.weight.detach()
                                                  for b in blocks]))
        self.blocks_b = nn.Parameter(torch.stack([b.bias.detach()
                                                  for b in blocks]))
        self.cfg = cfg
        self.mesh = None

    def apply_blocks(self, h: torch.Tensor) -> torch.Tensor:
        """The blocks this module holds, in order."""
        dt = self.cfg.compute_dtype
        rnd = lambda t: t.to(dt).to(torch.float32)
        for w, b in zip(self.blocks_w, self.blocks_b):
            h = h + gelu(F.linear(rnd(h), rnd(w), b))
        return h


def init_trunk_params(cfg: TrunkConfig, gen: torch.Generator,
                      device="cuda") -> Trunk:
    return Trunk(cfg, gen).to(device)


def params_from_jax(cfg: TrunkConfig, params, device="cuda") -> Trunk:
    """The JAX package's init_trunk_params pytree (numpy leaves) as the
    port's module on `device`."""
    model = Trunk(cfg, torch.Generator().manual_seed(0))
    neural.load_linear(model.entry, params["entry"])
    neural.load_linear(model.exit, params["exit"])
    with torch.no_grad():
        model.blocks_w.copy_(torch.tensor(np.asarray(
            params["blocks"]["w"]).transpose(0, 2, 1)))
        model.blocks_b.copy_(torch.tensor(np.asarray(params["blocks"]["b"])))
    return model.to(device)


def forward_reference(cfg: TrunkConfig, params: Trunk, x: torch.Tensor):
    """One-process forward (the pipeline's equality oracle)."""
    dt = cfg.compute_dtype
    with _fp32_matmul():
        h = gelu(dense(params.entry, x, dt))
        return dense(params.exit, params.apply_blocks(h), dt)


def pp_param_shardings(mesh: Mesh) -> dict:
    """The trunk's layout on a ("pipe",) mesh in the JAX package's tree
    ({group: {leaf: (dim, axis) or None}}, as neural.tp_param_specs): the
    blocks' stacked leading axis splits into stages; the boundary layers
    replicate (None)."""
    staged = (0, PIPE_AXIS)
    return {"entry": {"w": None, "b": None},
            "blocks": {"w": staged, "b": staged},
            "exit": {"w": None, "b": None}}


def shard_params_pp(params: Trunk, mesh: Mesh) -> Trunk:
    """This rank's stage of the trunk on mesh.device under
    pp_param_shardings: its contiguous n_blocks / n_stages blocks, the
    boundary layers replicated (make the optimizer from the result)."""
    cfg = params.cfg
    S = mesh.shape[PIPE_AXIS]
    if cfg.n_blocks % S:
        raise ValueError(f"{cfg.n_blocks} blocks do not split over {S} "
                         "stages")
    stage = Trunk(cfg, torch.Generator().manual_seed(0))
    stage.load_state_dict(params.state_dict())
    shard_stacked(stage, params, pp_param_shardings(mesh), mesh)
    stage = stage.to(mesh.device)
    stage.mesh = mesh
    return stage


def pp_forward(cfg: TrunkConfig, params: Trunk, x: torch.Tensor,
               mesh: Mesh) -> torch.Tensor:
    """Pipelined forward over the ("pipe",) mesh: x [B, dims] the same on
    every rank (replicated) -> [B, dims] on every rank, equal to
    forward_reference to float tolerance.

    The GPipe schedule: M + S - 1 ticks; stage 0 takes microbatch t,
    every stage applies its blocks to what arrived, and ppermute ships the
    result one stage down.  The last stage's outputs (valid from tick
    S - 1 on) are psum-broadcast, so the exit layer and the loss run
    replicated.  Every rank calls every collective, and every collective's
    output stays in the graph (torch.where, not a Python branch), so the
    backward pass calls the same collectives in the same order on every
    rank."""
    S, s = mesh.shape[PIPE_AXIS], mesh.index(PIPE_AXIS)
    M = cfg.n_micro
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by n_micro {M}")
    dt = cfg.compute_dtype
    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == S - 1, device=x.device)
    perm = [(i, i + 1) for i in range(S - 1)]
    with _fp32_matmul():
        h = gelu(dense(params.entry, x.reshape(M, B // M, -1), dt))
        # the replicated entry output enters per-stage computation
        h = pvary(h, mesh, PIPE_AXIS)
        recv = torch.zeros_like(h[0])
        outs = []
        for t in range(M + S - 1):
            xt = h[t] if t < M else torch.zeros_like(h[0])
            out = params.apply_blocks(torch.where(first, xt, recv))
            outs.append(out)
            if t < M + S - 2:
                recv = ppermute(out, mesh, PIPE_AXIS, perm)
        res = torch.stack(outs[S - 1:])                    # [M, B/M, hidden]
        res = psum(torch.where(last, res, torch.zeros_like(res)), mesh,
                   PIPE_AXIS)
        return dense(params.exit, res, dt).reshape(B, -1)


def make_optimizer(cfg: TrunkConfig, params: Trunk) -> torch.optim.AdamW:
    """optax.adamw(cfg.lr, weight_decay=1e-5), as neural.make_optimizer."""
    return neural.make_optimizer(cfg, params)


def train_step_pp(cfg: TrunkConfig, params: Trunk, opt_state, batch,
                  mesh: Mesh):
    """One pipeline-parallel training step (reconstruction MSE) ->
    (params, opt_state, loss before the update).  params from
    shard_params_pp; batch [B, dims], the same on every rank."""
    loss = neural.optimizer_step(
        opt_state, lambda: torch.mean((pp_forward(cfg, params, batch, mesh)
                                       - batch) ** 2))
    return params, opt_state, loss.detach()
