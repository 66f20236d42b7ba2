"""Optimizer stack (port of ``geoldm_tpu/train/optim.py``): AMSGrad with
PyTorch's bias-correction placement, decoupled weight decay 1e-12, adaptive
gradient clipping, the trainable mask and the EMA.

The reference trains with ``AdamW(amsgrad=True, weight_decay=1e-12)``
(qm9/models.py:169-175), which is the chain the JAX package rebuilt in optax
(``scale_by_amsgrad_torch`` + ``add_decayed_weights`` + ``scale(-lr)``), so
the port uses ``torch.optim.AdamW`` itself; ``tests/test_torch_port_train.py``
holds it to the JAX chain. On the card the train step runs the clip's norm
and scale, AdamW's step and the EMA as one fused step of three launches
(``ops.fused_optim``), over AdamW's own state; the functions here are its
plain version, which the CPU runs. The clip keeps its ring buffer on the
device and never synchronises with the host; checkpoints save it (``state_dict``), so a
resumed run clips against the same history. Under tensor parallelism the
global norm adds the squares of this rank's shards of the hidden-width
gradients over the model ranks to those of the replicated gradients, each
counted once, so the norm, the ring buffer and the clip's scale are one
rank's on every rank.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn


class AdaptiveGradClip:
    """Clip the global gradient norm at 1.5 * mean + 2 * std of the last
    ``max_len`` recorded norms, the buffer seeded with ``init_value``; each
    step records min(norm, threshold), so one spike cannot poison the
    threshold (reference utils.py:30-66; optim.py:28-66)."""

    def __init__(self, device, max_len: int = 50, init_value: float = 3000.0):
        self.norms = torch.zeros(max_len, dtype=torch.float32, device=device)
        self.norms[0] = init_value
        self.count = 1
        self.head = 1

    def __call__(self, grads: List[torch.Tensor], shards: Sequence[torch.Tensor] = (),
                 grp=None) -> torch.Tensor:
        """Scale ``grads`` in place; returns their global norm before the clip.
        Under TP, ``grads`` are the replicated gradients and ``shards`` this
        rank's shards of the sharded ones, over the model ranks ``grp``."""
        grad_norm = global_norm(grads, shards, grp)
        valid = self.norms[:self.count]
        mean = valid.sum() / self.count
        std = torch.sqrt(torch.clamp(((valid - mean) ** 2).sum() / self.count, min=0.0))
        max_grad_norm = 1.5 * mean + 2.0 * std
        scale = torch.clamp(max_grad_norm / (grad_norm + 1e-12), max=1.0)
        torch._foreach_mul_(list(grads) + list(shards), scale)
        self.norms[self.head % self.norms.shape[0]] = torch.minimum(grad_norm, max_grad_norm)
        self.advance()
        return grad_norm

    def advance(self) -> None:
        """Count the norm just written at ``head`` (by this clip or by the
        fused optimizer step's threshold kernel, ``ops.fused_optim``)."""
        self.count = min(self.count + 1, self.norms.shape[0])
        self.head += 1

    def state_dict(self) -> dict:
        """The ring buffer and its counters (JAX's ``AdaptiveClipState``)."""
        return {"norms": self.norms.detach().cpu().clone(), "count": self.count,
                "head": self.head}

    def load_state_dict(self, state: dict) -> None:
        norms = torch.as_tensor(state["norms"], dtype=torch.float32)
        if norms.shape != self.norms.shape:
            raise ValueError(f"clip ring buffer of {tuple(norms.shape)}, this clip keeps "
                             f"{tuple(self.norms.shape)}")
        self.norms.copy_(norms)
        self.count, self.head = int(state["count"]), int(state["head"])


def global_norm(tensors: List[torch.Tensor], shards: Sequence[torch.Tensor] = (),
                grp=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm) of
    ``tensors`` and, under TP, of the whole tensors whose rows ``shards``
    are on this model rank of ``grp``: their squares are summed over the
    model ranks, the replicated ``tensors`` counted once."""
    sq = sum((t * t).sum() for t in tensors)
    if shards:
        from geoldm_tpu_torch.parallel.sharding import all_reduce

        sq = sq + all_reduce(sum((t * t).sum() for t in shards).reshape(1), grp).reshape(())
    return torch.sqrt(sq)


def trainable_mask(model: nn.Module, model_kind: str, trainable_ae: bool) -> Dict[str, bool]:
    """Parameter name -> trainable. The VAE is frozen for latent diffusion
    unless ``trainable_ae`` (and even then the encoder gets no gradient: its
    latent is detached) (optim.py:161-170)."""
    freeze_vae = model_kind == "latent_diffusion" and not trainable_ae
    return {name: not (freeze_vae and name.startswith("vae."))
            for name, _ in model.named_parameters()}


def make_optimizer(model: nn.Module, mask: Dict[str, bool], lr: float = 1e-4,
                   weight_decay: float = 1e-12, params: Optional[list] = None
                   ) -> torch.optim.Optimizer:
    """AMSGrad (torch semantics) with decoupled weight decay over the
    trainable parameters, or over ``params`` (what this rank owns of them,
    in the model's order) when given; the frozen ones stop requiring
    gradients."""
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
    return torch.optim.AdamW(trainable if params is None else params, lr=lr,
                             weight_decay=weight_decay, amsgrad=True)


@torch.no_grad()
def ema_update(ema, model, decay: float) -> None:
    """Polyak averaging e = e * decay + p * (1 - decay) of every parameter
    (reference equivariant_diffusion/utils.py:5-18). ``ema`` and ``model``
    are modules, or lists of tensors in the same order (under TP, this
    rank's shards and the replicated parameters)."""
    ema = list(ema.parameters()) if isinstance(ema, nn.Module) else list(ema)
    src = list(model.parameters()) if isinstance(model, nn.Module) else list(model)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, src, alpha=1.0 - decay)
