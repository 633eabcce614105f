"""Neural frame model on LLSM coder vectors (counterpart of
libllsm2_tpu.models.neural).

A residual MLP autoencoder over coder vectors (a frame compressor,
denoiser, or the decoder head of an acoustic model), trained with
torch.optim.AdamW -- the port's training workload (the analysis /
synthesis pipeline being its inference workload).

The network is an nn.Module whose layers keep the JAX pytree's names
(enc_in, enc_res.i, enc_out, dec_in, dec_res.i, dec_out).  Mixed precision
as in the JAX package: every product rounds its OPERANDS to
cfg.compute_dtype (bfloat16) and accumulates and returns float32
(jnp.dot(..., preferred_element_type=float32)); a bfloat16 torch.matmul or
autocast would round the result too.  float32 master weights.  Products
run without TF32 (ops/f0._fp32_matmul).  The functions below keep the JAX
signatures, params / opt_state being the module and its optimizer:

    params = init_params(cfg, torch.Generator().manual_seed(0))
    opt_state = make_optimizer(cfg, params)
    params, opt_state, loss = train_step(cfg, params, opt_state, batch)

Several devices (parallel.mesh): train_step(..., mesh=) is data-parallel
over the mesh's batch axis (each rank passes its rows; the loss is the
global batch's, its numerator and count all-reduced, and the gradients
all-reduced, so the replicated parameters stay equal on every rank).
shard_params_tp(cfg, params, mesh) keeps this rank's slices of a
Megatron-style tensor-parallel layout over the mesh's model axis
(tp_param_specs): the row-parallel products all-reduce their partial
sums, and train_step on the sharded module is tensor- and data-parallel.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.f0 import _fp32_matmul
from ..parallel.mesh import (BATCH_AXIS, MODEL_AXIS, all_gather,
                             all_reduce_grads, psum, pvary)


@dataclasses.dataclass(frozen=True)
class AEConfig:
    dims: int                 # coder vector size
    hidden: int = 256
    latent: int = 32
    depth: int = 2            # residual blocks per side
    lr: float = 1e-3
    compute_dtype: Any = torch.bfloat16


def _linear(fan_in: int, fan_out: int, gen: torch.Generator) -> nn.Linear:
    """He-normal weight (std sqrt(2 / fan_in)), zero bias, drawn on the
    host from `gen` (the same init on every device)."""
    layer = nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        layer.weight.copy_(torch.randn((fan_out, fan_in), generator=gen)
                           * np.sqrt(2.0 / fan_in))
        layer.bias.zero_()
    return layer


def dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """x @ W + b with x and W rounded to `dtype`, the product and its sum
    in float32 (JAX: jnp.dot(x.astype(dtype), w.astype(dtype),
    preferred_element_type=float32) + b)."""
    rnd = lambda t: t.to(dtype).to(torch.float32)
    return F.linear(rnd(x), rnd(layer.weight), layer.bias)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh form (torch's default is erf)."""
    return F.gelu(x, approximate="tanh")


class AutoEncoder(nn.Module):
    """The residual MLP autoencoder of AEConfig."""

    def __init__(self, cfg: AEConfig, gen: torch.Generator):
        super().__init__()
        h = cfg.hidden
        self.enc_in = _linear(cfg.dims, h, gen)
        self.enc_out = _linear(h, cfg.latent, gen)
        self.dec_in = _linear(cfg.latent, h, gen)
        self.dec_out = _linear(h, cfg.dims, gen)
        self.enc_res = nn.ModuleList(_linear(h, h, gen)
                                     for _ in range(cfg.depth))
        self.dec_res = nn.ModuleList(_linear(h, h, gen)
                                     for _ in range(cfg.depth))
        self.cfg = cfg

    def _side(self, first, blocks, last, x):
        dt = self.cfg.compute_dtype
        h = gelu(dense(first, x, dt))
        for blk in blocks:
            h = h + gelu(dense(blk, h, dt))
        return dense(last, h, dt)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._side(self.enc_in, self.enc_res, self.enc_out, x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self._side(self.dec_in, self.dec_res, self.dec_out, z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def init_params(cfg: AEConfig, gen: torch.Generator,
                device="cuda") -> AutoEncoder:
    """The autoencoder, drawn from `gen` and placed on `device` (the card
    by default; "cpu" for the CPU)."""
    return AutoEncoder(cfg, gen).to(device)


def encode(cfg: AEConfig, params: AutoEncoder, x):
    with _fp32_matmul():
        return params.encode(x)


def decode(cfg: AEConfig, params: AutoEncoder, z):
    with _fp32_matmul():
        return params.decode(z)


def forward(cfg: AEConfig, params: AutoEncoder, x):
    with _fp32_matmul():
        return params(x)


def _global_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of t over this rank's rows, and with a mesh over every
    rank's (each rank's rows counted once: averaging the ranks' own means
    would weigh their counts wrongly)."""
    s = torch.sum(t)
    return s if mesh is None else psum(s, mesh, BATCH_AXIS)


def global_mean(t: torch.Tensor, mesh=None) -> torch.Tensor:
    """torch.mean(t) over the whole batch (t this rank's rows with a mesh)."""
    if mesh is None:
        return torch.mean(t)
    n = torch.tensor(float(t.numel()), dtype=t.dtype, device=t.device)
    return _global_sum(t, mesh) / _global_sum(n, mesh)


def masked_mse(err: torch.Tensor, mask, dims: int, mesh=None) -> torch.Tensor:
    """Mean of err [..., dims] over the frames where mask [...] is set (with
    a mesh: over the whole batch's frames)."""
    if mask is None:
        return global_mean(err, mesh)
    count = _global_sum(mask.detach(), mesh) * dims
    return _global_sum(err * mask[..., None], mesh) / torch.clamp(count,
                                                                  min=1.0)


def loss_fn(cfg: AEConfig, params: AutoEncoder, batch, mask=None,
            mesh=None):
    """Masked MSE in the normalized coder space; batch [B, N, dims] or
    [B, dims] (this rank's rows with a mesh)."""
    pred = forward(cfg, params, batch)
    return masked_mse((pred - batch) ** 2, mask, batch.shape[-1], mesh)


def make_optimizer(cfg, params: nn.Module) -> torch.optim.AdamW:
    """optax.adamw(cfg.lr, weight_decay=1e-5): every parameter decays,
    biases (and embedding, codebook) included; b1, b2 and eps are torch's
    defaults (0.9, 0.999, 1e-8 outside the root), as optax's."""
    return torch.optim.AdamW(params.parameters(), lr=cfg.lr,
                             weight_decay=1e-5)


def optimizer_step(opt_state: torch.optim.Optimizer, loss_of,
                   mesh=None) -> torch.Tensor:
    """One update: the gradient of loss_of() (products without TF32; with
    a mesh, summed over its batch axis: loss_of() is then the global loss,
    each rank's gradient its own rows' part), then the optimizer's step;
    returns the loss before the update."""
    opt_state.zero_grad(set_to_none=True)
    with _fp32_matmul():
        out = loss_of()
        (out[0] if isinstance(out, tuple) else out).backward()
    if mesh is not None:
        all_reduce_grads([p for g in opt_state.param_groups
                          for p in g["params"]], mesh, BATCH_AXIS)
    opt_state.step()
    return out


def train_step(cfg: AEConfig, params: AutoEncoder, opt_state, batch,
               mask=None, mesh=None):
    """One training step on `batch` (on the module's device) -> (params,
    opt_state, loss before the update); params and opt_state update in
    place and are returned for the JAX package's call shape.  mesh:
    data-parallel over its batch axis (batch and mask this rank's rows;
    the loss the global batch's); a module from shard_params_tp is also
    tensor-parallel over its model axis."""
    loss = optimizer_step(opt_state,
                          lambda: loss_fn(cfg, params, batch, mask, mesh),
                          mesh)
    return params, opt_state, loss.detach()


def tp_param_specs(cfg: AEConfig):
    """Megatron-style tensor-parallel layout over a (batch, model) mesh
    (parallel.mesh.make_tp_mesh), as the JAX package's PartitionSpecs:
    {module name: {"weight": (dim, axis) or None, "bias": ...}} on
    nn.Linear's [out, in] weight.  Column-parallel entry layers (enc_in,
    dec_in) shard the hidden OUT dimension, their bias with it;
    row-parallel residual and exit layers shard the hidden IN dimension,
    their partial sums all-reduced over the model axis, their bias
    replicated (None)."""
    col = {"weight": (0, MODEL_AXIS), "bias": (0, MODEL_AXIS)}
    row = {"weight": (1, MODEL_AXIS), "bias": None}
    specs = {"enc_in": col, "enc_out": row, "dec_in": col, "dec_out": row}
    for i in range(cfg.depth):
        specs[f"enc_res.{i}"] = row
        specs[f"dec_res.{i}"] = row
    return specs


class TPAutoEncoder(nn.Module):
    """This rank's slices of an AutoEncoder under tp_param_specs, and the
    tensor-parallel forward: the column-parallel entry takes the replicated
    input through pvary (its gradient summed over the model axis) and its
    hidden shards are all-gathered into the residual stream; each row-parallel product takes
    this rank's slice of the stream (pvary: its gradient summed over the
    model axis) and all-reduces its partial sum (psum), Megatron's f/g
    pair."""

    def __init__(self, cfg: AEConfig, model: AutoEncoder, mesh):
        super().__init__()
        self.cfg, self.mesh = cfg, mesh
        m, i = mesh.shape[MODEL_AXIS], mesh.index(MODEL_AXIS)
        if cfg.hidden % m:
            raise ValueError(f"hidden {cfg.hidden} does not split over {m} "
                             "ranks of the model axis")
        self.width = cfg.hidden // m
        self.cols = slice(i * self.width, (i + 1) * self.width)
        specs = tp_param_specs(cfg)
        for name, spec in specs.items():
            src = model.get_submodule(name)
            layer = nn.Linear(1, 1)
            for pname in ("weight", "bias"):
                v = getattr(src, pname).detach()
                if spec[pname] is not None:
                    v = v.narrow(spec[pname][0], i * self.width, self.width)
                setattr(layer, pname, nn.Parameter(v.clone().to(
                    mesh.device)))
            self.add_module(name.replace(".", "_"), layer)

    def _row(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.compute_dtype
        rnd = lambda t: t.to(dt).to(torch.float32)
        hs = pvary(h, self.mesh, MODEL_AXIS)[..., self.cols]
        part = F.linear(rnd(hs), rnd(layer.weight))
        return psum(part, self.mesh, MODEL_AXIS) + layer.bias

    def _side(self, first: str, res: str, last: str, x):
        dt = self.cfg.compute_dtype
        # the replicated input enters the column-parallel product (f)
        x = pvary(x, self.mesh, MODEL_AXIS)
        h = all_gather(gelu(dense(getattr(self, first), x, dt)), self.mesh,
                       MODEL_AXIS, dim=-1)
        for i in range(self.cfg.depth):
            h = h + gelu(self._row(getattr(self, f"{res}_{i}"), h))
        return self._row(getattr(self, last), h)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self._side("enc_in", "enc_res", "enc_out", x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self._side("dec_in", "dec_res", "dec_out", z)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.decode(self.encode(x))


def shard_params_tp(cfg: AEConfig, params: AutoEncoder, mesh) -> TPAutoEncoder:
    """This rank's slices of `params` under tp_param_specs on mesh.device
    (make the optimizer from the result, as the JAX package shards before
    optimizer.init)."""
    return TPAutoEncoder(cfg, params, mesh)


def load_linear(layer: nn.Linear, p) -> None:
    """A JAX dense {"w": [in, out], "b": [out]} into an nn.Linear
    (weight [out, in])."""
    with torch.no_grad():
        layer.weight.copy_(torch.tensor(np.asarray(p["w"]).T))
        layer.bias.copy_(torch.tensor(np.asarray(p["b"])))


def params_from_jax(cfg: AEConfig, params, device="cuda") -> AutoEncoder:
    """The JAX package's init_params pytree (numpy leaves) as the port's
    module on `device`."""
    model = AutoEncoder(cfg, torch.Generator().manual_seed(0))
    for name in ("enc_in", "enc_out", "dec_in", "dec_out"):
        load_linear(getattr(model, name), params[name])
    for i in range(cfg.depth):
        load_linear(model.enc_res[i], params[f"enc_res{i}"])
        load_linear(model.dec_res[i], params[f"dec_res{i}"])
    return model.to(device)


class Normalizer:
    """Per-dimension standardization of coder vectors (host-side)."""

    def __init__(self, vectors):
        v = np.asarray(vectors).reshape(-1, vectors.shape[-1])
        self.mean = v.mean(axis=0)
        self.std = v.std(axis=0) + 1e-6

    def fwd(self, v):
        return (v - self.mean) / self.std

    def inv(self, v):
        return v * self.std + self.mean
