"""Expert-parallel Mixture-of-Experts layer for the neural frame model
(counterpart of libllsm2_tpu/parallel/expert.py).

Tokens are data-sharded over the same 1-D ("expert",) mesh axis the
experts are sharded over; routing is Switch-style top-1 with capacity,
dispatch and return ride all_to_all, and every routing step is a one-hot
product (the JAX package's layout, so the two agree slot for slot).

Model: entry dense (dims -> hidden) -> MoE residual block (hidden ->
hidden through one of n_experts expert FFNs, top-1 gated; tokens over an
expert's capacity pass through the residual identity) -> exit dense
(hidden -> dims).  Training adds the Switch load-balancing auxiliary
loss.
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
from .mesh import (EXPERT_AXIS, Mesh, all_reduce_grads, all_to_all, pmean,
                   psum, shard_stacked)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dims: int
    hidden: int = 64
    n_experts: int = 8
    capacity_factor: float = 2.0   # per (source shard, expert) slots:
                                   # C = ceil(cf * n_local / n_experts)
    aux_weight: float = 1e-2       # Switch load-balance loss weight
    lr: float = 1e-3
    compute_dtype: Any = torch.float32


class MoE(nn.Module):
    """entry, gate [hidden, E], experts_w [E, hidden, hidden] ([out, in]),
    experts_b [E, hidden], exit; an expert-parallel rank holds its slice
    of the experts."""

    def __init__(self, cfg: MoEConfig, gen: torch.Generator):
        super().__init__()
        experts = [neural._linear(cfg.hidden, cfg.hidden, gen)
                   for _ in range(cfg.n_experts)]
        self.entry = neural._linear(cfg.dims, cfg.hidden, gen)
        self.gate = nn.Parameter(torch.randn((cfg.hidden, cfg.n_experts),
                                             generator=gen) * 0.02)
        self.exit = neural._linear(cfg.hidden, cfg.dims, gen)
        self.experts_w = nn.Parameter(torch.stack([e.weight.detach()
                                                   for e in experts]))
        self.experts_b = nn.Parameter(torch.stack([e.bias.detach()
                                                   for e in experts]))
        self.cfg = cfg


def init_moe_params(cfg: MoEConfig, gen: torch.Generator,
                    device="cuda") -> MoE:
    return MoE(cfg, gen).to(device)


def params_from_jax(cfg: MoEConfig, params, device="cuda") -> MoE:
    """The JAX package's init_moe_params pytree (numpy leaves) as the
    port's module on `device`."""
    model = MoE(cfg, torch.Generator().manual_seed(0))
    neural.load_linear(model.entry, params["entry"])
    neural.load_linear(model.exit, params["exit"])
    with torch.no_grad():
        model.gate.copy_(torch.tensor(np.asarray(params["gate"])))
        model.experts_w.copy_(torch.tensor(np.asarray(
            params["experts"]["w"]).transpose(0, 2, 1)))
        model.experts_b.copy_(torch.tensor(np.asarray(
            params["experts"]["b"])))
    return model.to(device)


def _route(cfg: MoEConfig, gate_w, h, capacity: int):
    """Top-1 routing with per-(shard, expert) capacity -> (dispatch
    [n, E, C] one-hot, gate weight [n], the Switch aux terms: the fraction
    of tokens an expert and its mean gate probability, [E] each).  A
    token's slot in its expert is its rank among the expert's tokens, from
    a cumulative sum of the one-hot matrix."""
    E = cfg.n_experts
    probs = torch.softmax(h.to(torch.float32) @ gate_w, dim=-1)    # [n, E]
    onehot = F.one_hot(torch.argmax(probs, dim=-1), E).to(torch.float32)
    gw = torch.sum(probs * onehot, dim=-1)
    pos = torch.sum(torch.cumsum(onehot, dim=0) * onehot,
                    dim=-1).to(torch.int64) - 1
    keep = ((pos >= 0) & (pos < capacity)).to(torch.float32)
    slot = (pos[:, None] == torch.arange(capacity, device=h.device)).to(
        torch.float32)                      # jax.nn.one_hot: zeros off range
    dispatch = (onehot * keep[:, None])[:, :, None] * slot[:, None, :]
    return dispatch, gw, torch.mean(onehot, dim=0), torch.mean(probs, dim=0)


def _experts(cfg: MoEConfig, w, b, slots):
    """Each expert's FFN on its token slots: w [k, h, h], b [k, h], slots
    [k, ..., h]."""
    dt = cfg.compute_dtype
    rnd = lambda t: t.to(dt).to(torch.float32)
    return torch.stack([gelu(F.linear(rnd(s), rnd(wi), bi))
                        for wi, bi, s in zip(w, b, slots)])


def moe_forward_reference(cfg: MoEConfig, params: MoE, x, capacity: int):
    """One-process dense evaluation: every expert on every slot through the
    same one-hot dispatch algebra (the EP equality oracle)."""
    dt = cfg.compute_dtype
    with _fp32_matmul():
        h = gelu(dense(params.entry, x, dt))
        dispatch, gw, _, _ = _route(cfg, params.gate, h, capacity)
        slots = torch.einsum("nec,nh->ech", dispatch, h)
        y = _experts(cfg, params.experts_w, params.experts_b, slots)
        h = h + torch.einsum("nec,ech->nh", dispatch, y) * gw[:, None]
        return dense(params.exit, h, dt)


def ep_param_shardings(cfg: MoEConfig, mesh: Mesh) -> dict:
    """The MoE's layout on an ("expert",) mesh in the JAX package's tree
    ({group: {leaf: (dim, axis) or None}}, as neural.tp_param_specs):
    experts split on their stacked leading axis, everything else
    replicated (None)."""
    split = (0, EXPERT_AXIS)
    return {"entry": {"w": None, "b": None}, "gate": None,
            "experts": {"w": split, "b": split},
            "exit": {"w": None, "b": None}}


def shard_params_ep(cfg: MoEConfig, params: MoE, mesh: Mesh) -> MoE:
    """This rank's experts (n_experts / n a rank, contiguous) and the
    replicated rest under ep_param_shardings, on mesh.device (make the
    optimizer from the result)."""
    n = mesh.shape[EXPERT_AXIS]
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over {n} "
                         "ranks")
    local = MoE(cfg, torch.Generator().manual_seed(0))
    local.load_state_dict(params.state_dict())
    shard_stacked(local, params, ep_param_shardings(cfg, mesh), mesh)
    return local.to(mesh.device)


def _capacity(cfg: MoEConfig, n_local: int) -> int:
    return max(1, int(-(-cfg.capacity_factor * n_local // cfg.n_experts)))


def moe_forward_ep(cfg: MoEConfig, params: MoE, x, mesh: Mesh,
                   capacity=None):
    """Expert-parallel forward over the ("expert",) mesh: x [n_local, dims]
    this rank's tokens, params from shard_params_ep -> (y [n_local, dims],
    the aux loss, already the global mean).  The capacity comes from the
    local token count.  Dispatch and return are all_to_all over the
    (source shard, local expert) layout."""
    n = mesh.shape[EXPERT_AXIS]
    E, k = cfg.n_experts, cfg.n_experts // n
    if capacity is None:
        capacity = _capacity(cfg, x.shape[0])
    dt = cfg.compute_dtype
    with _fp32_matmul():
        h = gelu(dense(params.entry, x, dt))
        dispatch, gw, frac, mean_prob = _route(cfg, params.gate, h, capacity)
        slots = torch.einsum("nec,nh->ech", dispatch, h)        # [E, C, h]
        # each rank keeps its k experts' slots from EVERY source shard
        recv = all_to_all(slots, mesh, EXPERT_AXIS, 0, 0)       # [n k, C, h]
        recv = recv.reshape(n, k, capacity, -1).transpose(0, 1)
        y = _experts(cfg, params.experts_w, params.experts_b, recv)
        y = y.transpose(0, 1).reshape(E, capacity, -1)
        back = all_to_all(y, mesh, EXPERT_AXIS, 0, 0)           # [E, C, h]
        h = h + torch.einsum("nec,ech->nh", dispatch, back) * gw[:, None]
        out = dense(params.exit, h, dt)
    aux = E * torch.sum(pmean(frac, mesh, EXPERT_AXIS)
                        * pmean(mean_prob, mesh, EXPERT_AXIS))
    return out, aux


def make_optimizer(cfg: MoEConfig, params: MoE) -> torch.optim.AdamW:
    """optax.adamw(cfg.lr, weight_decay=1e-5), as neural.make_optimizer."""
    return neural.make_optimizer(cfg, params)


def train_step_ep(cfg: MoEConfig, params: MoE, opt_state, batch,
                  mesh: Mesh):
    """One expert-parallel training step (reconstruction MSE over the whole
    batch + the Switch aux loss) -> (params, opt_state, loss before the
    update).  params from shard_params_ep; batch this rank's [n_local,
    dims] tokens.  The replicated layers' gradients are summed over the
    axis (each rank's tokens give their part); each expert's comes back
    through the all_to_all from every rank's tokens."""
    opt_state.zero_grad(set_to_none=True)
    with _fp32_matmul():
        pred, aux = moe_forward_ep(cfg, params, batch, mesh)
        n = torch.tensor(float(batch.numel()), device=batch.device)
        mse = psum(torch.sum((pred - batch) ** 2), mesh, EXPERT_AXIS) \
            / psum(n, mesh, EXPERT_AXIS)
        loss = mse + cfg.aux_weight * aux
        loss.backward()
    all_reduce_grads([params.entry.weight, params.entry.bias, params.gate,
                      params.exit.weight, params.exit.bias], mesh,
                     EXPERT_AXIS)
    opt_state.step()
    return params, opt_state, loss.detach()
