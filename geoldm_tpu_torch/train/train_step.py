"""Train step and eval NLL (port of ``geoldm_tpu/train/train_step.py:38-144``).

A step: loss = mean(nll - log p(N)), backward (through the block kernels on
the card), adaptive clip, AMSGrad update, EMA. With a sequence-parallel model
(``parallel.sp``) every rank of an SP group runs the same step on the same
batch and noise; after the backward the gradients of the EGNN blocks'
weights, of which each rank holds its slab's share, are summed over the SP
group. Under data parallelism (``parallel.sharding``) each data rank holds
B/D rows of the global batch and draws its rows of the global draws
(``sharding.GlobalNoise``); after the SP sum every gradient and the loss are
averaged over the data ranks, before the clip, so the clip, AMSGrad and the
EMA see the global-batch gradient and every replica takes the same update.
Every random draw (the encoder's eps, t, the diffusion eps) comes from the
noise source the caller passes. Batches are dicts of tensors on the model's device: x [B,N,3],
h_cat [B,N,C], h_int [B,N,0/1], node_mask [B,N,1], log_pN [B] and, for a
conditional model, context [B,N,ctx].
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List, Optional

import torch
from torch import nn

from geoldm_tpu_torch.config import ModelConfig
from geoldm_tpu_torch.models import factory
from geoldm_tpu_torch.ops import com
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.parallel import sp as sp_mod
from geoldm_tpu_torch.train import optim as optim_mod


@dataclass
class TrainState:
    model: nn.Module
    ema_model: nn.Module  # the model itself when ema_decay == 0
    optimizer: torch.optim.Optimizer
    clip: Optional[optim_mod.AdaptiveGradClip]
    params: List[nn.Parameter]  # the trainable ones
    sp_group: Optional[sharding.RankGroup] = None
    sp_params: List[nn.Parameter] = field(default_factory=list)  # summed over the SP ranks
    step: int = 0  # train steps taken (JAX's TrainState.step)
    dp_group: Optional[sharding.RankGroup] = None  # gradients averaged over the data ranks


def create_train_state(model: nn.Module, model_cfg: ModelConfig, lr: float,
                       weight_decay: float = 1e-12, clip_grad: bool = True,
                       ema_decay: float = 0.9999,
                       dp_group: Optional[sharding.RankGroup] = None) -> TrainState:
    """The train state of ``model``; with ``dp_group`` (this rank's data
    ranks) each step averages the gradients over them."""
    mask = optim_mod.trainable_mask(model, model_cfg.kind, model_cfg.trainable_ae)
    optimizer = optim_mod.make_optimizer(model, mask, lr, weight_decay)
    ema_model = model
    if ema_decay > 0:
        ema_model = copy.deepcopy(model).requires_grad_(False)
    device = next(model.parameters()).device
    clip = optim_mod.AdaptiveGradClip(device) if clip_grad else None
    params = [p for name, p in model.named_parameters() if mask[name]]
    sp_params = [p for p in sp_mod.block_parameters(model) if p.requires_grad]
    return TrainState(model, ema_model, optimizer, clip, params, sp_mod.model_group(model),
                      sp_params, dp_group=dp_group)


def context_keep(noise: com.Noise, context: torch.Tensor, context_dropout: float
                 ) -> torch.Tensor:
    """[B, 1, 1] keep mask of classifier-free guidance training: 0 (the
    all-zero null context) with probability ``context_dropout`` per
    molecule, drawn from the step's generator before the loss's draws, as
    JAX draws it (``geoldm_tpu/train/train_step.py:67-80``; the streams
    differ). A data rank's ``sharding.GlobalNoise`` draws the global mask
    and keeps its rows. Another noise source needs the mask passed in."""
    shape = (context.shape[0], 1, 1)
    if isinstance(noise, torch.Generator):
        u = torch.rand(shape, generator=noise, device=context.device)
    elif isinstance(noise, sharding.GlobalNoise):
        u = noise.rand(shape).to(context.device)
    else:
        raise ValueError("context_dropout draws its keep mask from a torch.Generator; pass "
                         "keep= with another noise source")
    return (u < 1.0 - context_dropout).to(context.dtype)


def make_train_step(model_cfg: ModelConfig, ema_decay: float, compute_dtype=None,
                    context_dropout: float = 0.0):
    """train_step(state, batch, noise, keep=None) -> {"loss", "grad_norm"}
    (tensors on the device, not synchronised). ``compute_dtype`` (a name or
    spec of ``nn.core``, as JAX's ``make_train_step``): the loss and its
    gradient in it; bf16 runs the bf16 forward and backward kernels. With
    ``context_dropout`` > 0 a batch's context is multiplied by a per-molecule
    keep mask, ``keep`` [B,1,1] or else ``context_keep``'s draw. With the
    state's ``dp_group`` the batch is this rank's rows of the global batch,
    ``noise`` its ``sharding.GlobalNoise``, and the returned loss the
    global mean."""
    nll_fn = factory.model_nll_fn(model_cfg, training=True, compute_dtype=compute_dtype)

    def train_step(state: TrainState, batch: dict, noise: com.Noise,
                   keep: Optional[torch.Tensor] = None) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        context = batch.get("context")
        if context is not None and context_dropout > 0:
            if keep is None:
                keep = context_keep(noise, context, context_dropout)
            context = context * keep
        nll = nll_fn(state.model, noise, batch["x"], batch["h_cat"], batch["h_int"],
                     batch["node_mask"], context)
        loss = (nll - batch["log_pN"]).mean()
        loss.backward()
        if state.sp_params:
            sharding.reduce_grads(state.sp_params, state.sp_group)
        if state.dp_group is not None:
            (loss,) = sharding.reduce_grads(state.params, state.dp_group, loss, mean=True)
        grads = [p.grad for p in state.params if p.grad is not None]
        if state.clip is not None:
            grad_norm = state.clip(grads)
        else:
            grad_norm = optim_mod.global_norm(grads)
        state.optimizer.step()
        if ema_decay > 0:
            optim_mod.ema_update(state.ema_model, state.model, ema_decay)
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm}

    return train_step


def make_eval_nll(model_cfg: ModelConfig, compute_dtype=None):
    """eval_nll(model, batch, noise) -> mean NLL minus log p(N) (the
    t0_always two-pass estimator), under no_grad, in ``compute_dtype``. An
    optional ``weight`` entry ([B], 0/1) makes it the weighted mean, as JAX's
    (``geoldm_tpu/train/train_step.py:120-139``): uneven tail batches are
    padded with repeated molecules of weight 0 (an all-zero mask would NaN
    the latent model's per-graph reductions, and NaN * 0 = NaN)."""
    nll_fn = factory.model_nll_fn(model_cfg, training=False, compute_dtype=compute_dtype)

    @torch.no_grad()
    def eval_nll(model: nn.Module, batch: dict, noise: com.Noise) -> torch.Tensor:
        nll = nll_fn(model, noise, batch["x"], batch["h_cat"], batch["h_int"],
                     batch["node_mask"], batch.get("context"))
        nll = nll - batch["log_pN"]
        w = batch.get("weight")
        if w is None:
            return nll.mean()
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)

    return eval_nll
