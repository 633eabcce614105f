"""Discrete neural speech codec: product VQ-VAE over LLSM coder vectors
(counterpart of libllsm2_tpu.models.vq).

The models.neural residual-MLP autoencoder compresses a coder vector to a
small latent, which a product quantizer (G groups x S codes) snaps to its
nearest codebook entries: one frame becomes G small integers (G *
log2(S) bits), and the tokens round-trip through the decoder back to
coder vectors that coder.decode_frames can render.  Training uses the
straight-through estimator with codebook + commitment losses (van den
Oord et al.'s VQ-VAE objective), torch.optim.AdamW, bfloat16 operands
with float32 products as models.neural.

The nearest-code search is one float32 product (no TF32: near-ties may
still flip a few tokens between the card and the CPU, whose sums run in
other orders); torch.argmin keeps the first of tied codes, as jnp.argmin.
The code lookup is a gather, equal to the JAX package's one-hot product.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from ..ops.f0 import _fp32_matmul
from . import neural


@dataclasses.dataclass(frozen=True)
class VQConfig:
    dims: int                   # coder vector size
    hidden: int = 128
    latent: int = 32
    depth: int = 2
    groups: int = 4             # product-quantization groups
    codebook: int = 256         # codes per group
    beta: float = 0.25          # commitment loss weight
    lr: float = 1e-3
    compute_dtype: Any = torch.bfloat16

    @property
    def ae(self) -> neural.AEConfig:
        return neural.AEConfig(dims=self.dims, hidden=self.hidden,
                               latent=self.latent, depth=self.depth,
                               lr=self.lr,
                               compute_dtype=self.compute_dtype)

    @property
    def sub(self) -> int:
        assert self.latent % self.groups == 0
        return self.latent // self.groups

    @property
    def bits_per_frame(self) -> int:
        return self.groups * int(math.log2(self.codebook))


class VQModel(nn.Module):
    """The autoencoder `ae` and the codebooks [G, S, sub]."""

    def __init__(self, cfg: VQConfig, gen: torch.Generator):
        super().__init__()
        self.ae = neural.AutoEncoder(cfg.ae, gen)
        # unit-scale init: encoder outputs are O(1) after the gelu stack;
        # dead codes are handled by the commitment pull
        self.codebook = nn.Parameter(torch.randn(
            (cfg.groups, cfg.codebook, cfg.sub), generator=gen) * 0.5)


def init_params(cfg: VQConfig, gen: torch.Generator,
                device="cuda") -> VQModel:
    return VQModel(cfg, gen).to(device)


def _lookup(codebook: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """codebook [G, S, d], idx [..., G] -> [..., G, d]."""
    g = torch.arange(codebook.shape[0], device=idx.device)
    return codebook[g, idx]


def _nearest(cfg: VQConfig, codebook, z):
    """z [..., latent] -> (indices [..., G] int32, zq [..., latent]).
    Distance by the expanded form, so the inner term is one product."""
    zs = z.reshape(z.shape[:-1] + (cfg.groups, cfg.sub))
    with _fp32_matmul():
        dots = torch.einsum("...gd,gsd->...gs", zs, codebook)
    c2 = torch.sum(codebook ** 2, dim=-1)                # [G, S]
    d2 = c2 - 2.0 * dots                                 # ||z||^2 constant
    idx = torch.argmin(d2, dim=-1)                       # [..., G]
    zq = _lookup(codebook, idx)
    return idx.to(torch.int32), zq.reshape(z.shape)


def forward(cfg: VQConfig, params: VQModel, x, mesh=None):
    """x [..., dims] (normalized coder space) -> (recon, commit, codebk);
    with a mesh x is this rank's rows and the two means the whole
    batch's."""
    z = neural.encode(cfg.ae, params.ae, x)
    _, zq = _nearest(cfg, params.codebook, z)
    commit = neural.global_mean((z - zq.detach()) ** 2, mesh)
    codebk = neural.global_mean((z.detach() - zq) ** 2, mesh)
    z_st = z + (zq - z).detach()                         # straight-through
    recon = neural.decode(cfg.ae, params.ae, z_st)
    return recon, commit, codebk


def loss_fn(cfg: VQConfig, params: VQModel, batch, mask=None, mesh=None):
    recon, commit, codebk = forward(cfg, params, batch, mesh)
    rec = neural.masked_mse((recon - batch) ** 2, mask, cfg.dims, mesh)
    return rec + cfg.beta * commit + codebk, rec


def make_optimizer(cfg: VQConfig, params: VQModel) -> torch.optim.AdamW:
    return neural.make_optimizer(cfg, params)


def train_step(cfg: VQConfig, params: VQModel, opt_state, batch,
               mask=None, mesh=None):
    """One step -> (params, opt_state, reconstruction loss before the
    update); params and opt_state update in place.  mesh: data-parallel
    over its batch axis, as neural.train_step."""
    _, rec = neural.optimizer_step(
        opt_state, lambda: loss_fn(cfg, params, batch, mask, mesh), mesh)
    return params, opt_state, rec.detach()


@torch.no_grad()
def encode_tokens(cfg: VQConfig, params: VQModel, x) -> torch.Tensor:
    """Normalized coder vectors [..., dims] -> tokens [..., groups]
    int32 (the LM-facing representation)."""
    z = neural.encode(cfg.ae, params.ae, x)
    idx, _ = _nearest(cfg, params.codebook, z)
    return idx


@torch.no_grad()
def decode_tokens(cfg: VQConfig, params: VQModel, idx) -> torch.Tensor:
    """Tokens [..., groups] -> normalized coder vectors [..., dims]
    (denormalize with the fitted neural.Normalizer, then render via
    coder.decode / decode_frames)."""
    idx = torch.as_tensor(idx, device=params.codebook.device).long()
    zq = _lookup(params.codebook, idx)
    zq = zq.reshape(zq.shape[:-2] + (cfg.latent,))
    return neural.decode(cfg.ae, params.ae, zq)


def params_from_jax(cfg: VQConfig, params, device="cuda") -> VQModel:
    """The JAX package's init_params pytree (numpy leaves) as the port's
    module on `device`."""
    model = VQModel(cfg, torch.Generator().manual_seed(0))
    model.ae = neural.params_from_jax(cfg.ae, params["ae"], device="cpu")
    with torch.no_grad():
        model.codebook.copy_(torch.tensor(np.asarray(params["codebook"])))
    return model.to(device)
