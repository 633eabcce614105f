"""Phoneme-conditioned acoustic model over LLSM coder vectors
(counterpart of libllsm2_tpu.models.acoustic).

Phone identity + position features in, coder vectors out, trained like
models.neural and served through coder.decode_frames -> RTSynthesizer /
StreamPool.  An nn.Module: an embedding table, an input layer, a stack of
residual dilated kernel-3 convolutions (nn.Conv1d, dilation d, padding d)
and an output layer; bfloat16 operands with float32 products as
models.neural.

Tap order: the JAX package applies its taps (-d, 0, +d) to _shift(h, off),
so its tap 0 reads h[i + d] and tap 2 reads h[i - d]; Conv1d's kernel
index k reads x[i + (k - 1) d], the reverse.  params_from_jax puts JAX tap
t at kernel index 2 - t.  The JAX one-hot embedding product equals a
lookup of the bfloat16-rounded table.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.f0 import _fp32_matmul
from . import neural


@dataclasses.dataclass(frozen=True)
class AcousticConfig:
    dims: int                       # coder vector size (model output)
    n_phones: int
    n_feats: int = 2                # continuous per-frame features
    embed: int = 32
    hidden: int = 64
    dilations: Tuple[int, ...] = (1, 2, 4, 8)   # kernel-3 blocks
    lr: float = 3e-3
    compute_dtype: Any = torch.bfloat16


class AcousticModel(nn.Module):
    """embed [n_phones, embed], inp, convs[i] (Conv1d hidden -> hidden,
    kernel 3, dilation cfg.dilations[i]), out."""

    def __init__(self, cfg: AcousticConfig, gen: torch.Generator):
        super().__init__()
        h = cfg.hidden
        self.inp = neural._linear(cfg.embed + cfg.n_feats, h, gen)
        self.out = neural._linear(h, cfg.dims, gen)
        self.convs = nn.ModuleList()
        for d in cfg.dilations:
            conv = nn.Conv1d(h, h, 3, dilation=d, padding=d)
            with torch.no_grad():
                # each tap a He-normal [h, h] dense / sqrt(3)
                conv.weight.copy_(torch.randn((h, h, 3), generator=gen)
                                  * (np.sqrt(2.0 / h) / np.sqrt(3.0)))
                conv.bias.zero_()
            self.convs.append(conv)
        self.embed = nn.Parameter(
            torch.randn((cfg.n_phones, cfg.embed), generator=gen) * 0.3)
        self.cfg = cfg

    def forward(self, ids: torch.Tensor, feats: torch.Tensor):
        dt = self.cfg.compute_dtype
        rnd = lambda t: t.to(dt).to(torch.float32)
        emb = rnd(self.embed)[ids.long()]
        h = torch.cat([emb, feats.to(torch.float32)], dim=-1)
        h = neural.gelu(neural.dense(self.inp, h, dt))
        for conv in self.convs:
            y = F.conv1d(rnd(h).transpose(1, 2), rnd(conv.weight), conv.bias,
                         padding=conv.padding, dilation=conv.dilation)
            h = h + neural.gelu(y.transpose(1, 2))
        return neural.dense(self.out, h, dt)


def init_params(cfg: AcousticConfig, gen: torch.Generator,
                device="cuda") -> AcousticModel:
    return AcousticModel(cfg, gen).to(device)


def forward(cfg: AcousticConfig, params: AcousticModel, ids, feats):
    """ids [B, N] int, feats [B, N, n_feats] -> [B, N, dims] (normalized
    coder space)."""
    with _fp32_matmul():
        return params(ids, feats)


def loss_fn(cfg: AcousticConfig, params: AcousticModel, batch,
            dim_weights=None, mesh=None):
    """Masked MSE in normalized coder space.  batch = (ids, feats,
    targets, mask); dim_weights [dims] optionally emphasizes slots
    (e.g. F0) whose errors matter more downstream.  mesh: batch holds
    this rank's rows; the loss is the whole batch's (neural.masked_mse)."""
    ids, feats, targets, mask = batch
    err = (forward(cfg, params, ids, feats) - targets) ** 2
    if dim_weights is not None:
        err = err * dim_weights
    return neural.masked_mse(err, mask, cfg.dims, mesh)


def make_optimizer(cfg: AcousticConfig,
                   params: AcousticModel) -> torch.optim.AdamW:
    return neural.make_optimizer(cfg, params)


def train_step(cfg: AcousticConfig, params: AcousticModel, opt_state, batch,
               dim_weights=None, mesh=None):
    """One step on `batch` (tensors on the module's device) -> (params,
    opt_state, loss before the update).  mesh: data-parallel over its
    batch axis, as neural.train_step."""
    loss = neural.optimizer_step(
        opt_state, lambda: loss_fn(cfg, params, batch, dim_weights, mesh),
        mesh)
    return params, opt_state, loss.detach()


@torch.no_grad()
def predict_vectors(cfg: AcousticConfig, params: AcousticModel, ids, feats,
                    norm, unvoiced_below: float = 0.0) -> np.ndarray:
    """Model output denormalized back to raw coder vectors (numpy; norm is
    a models.neural.Normalizer fitted on targets); ids and feats, numpy or
    tensors, go to the module's device.

    unvoiced_below: regression noise puts small positive values in the
    F0 slot on unvoiced frames; snapping anything below the analysis
    floor to exactly 0 restores the voiced/unvoiced decision before the
    vectors hit coder.decode_frames (slot 0 = "f0" in
    coder.CoderConfig.layout)."""
    dev = params.embed.device
    pred = forward(cfg, params, torch.as_tensor(ids, device=dev),
                   torch.as_tensor(feats, device=dev))
    pred = norm.inv(pred.cpu().numpy())
    if unvoiced_below > 0.0:
        f0 = pred[..., 0]
        pred[..., 0] = np.where(f0 >= unvoiced_below, f0, 0.0)
    return pred.astype(np.float32)


def params_from_jax(cfg: AcousticConfig, params,
                    device="cuda") -> AcousticModel:
    """The JAX package's init_params pytree (numpy leaves) as the port's
    module on `device`: JAX tap t ([in, out], applied to _shift(h, (-d, 0,
    d)[t])) becomes Conv1d kernel index 2 - t ([out, in])."""
    model = AcousticModel(cfg, torch.Generator().manual_seed(0))
    neural.load_linear(model.inp, params["in"])
    neural.load_linear(model.out, params["out"])
    with torch.no_grad():
        model.embed.copy_(torch.tensor(np.asarray(params["embed"])))
        for i, conv in enumerate(model.convs):
            w = np.asarray(params[f"conv{i}"]["w"])         # [3, in, out]
            conv.weight.copy_(torch.as_tensor(
                np.ascontiguousarray(w[::-1].transpose(2, 1, 0))))
            conv.bias.copy_(torch.tensor(
                np.asarray(params[f"conv{i}"]["b"])))
    return model.to(device)
