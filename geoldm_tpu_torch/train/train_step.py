"""Train step and eval NLL (port of ``geoldm_tpu/train/train_step.py:38-144``).

A step: loss = mean(nll - log p(N)), backward (through the block kernels on
the card), adaptive clip, AMSGrad update, EMA (the last three on the card
in the three launches of ``ops.fused_optim``, on the CPU as plain PyTorch).
With a sequence-parallel model (``parallel.sp``) every rank of an SP group
runs the same step on the same batch and noise; after the backward the
gradients of the EGNN blocks' weights, of which each rank holds its slab's
share, are summed over the SP group. Under data parallelism
(``parallel.sharding``) each data rank holds B/D rows of the global batch
and draws its rows of the global draws (``sharding.GlobalNoise``); after
the SP sum every gradient and the loss are averaged over the data ranks,
before the clip, so the clip, AMSGrad and the EMA see the global-batch
gradient and every replica takes the same update.
Under tensor parallelism (``--tp T``, ``parallel.sharding``) the T model
ranks of a data row run the same forward and backward on the same rows with
the full weights; each then cuts every hidden-width gradient to its own rows
(the rows of a sharded parameter that this rank owns, with their AMSGrad
moments and EMA), and only these shards and the replicated gradients are
averaged over the data ranks, clipped with the norm over the model ranks
(``optim.global_norm``) and stepped; the updated shards are then gathered
into the full weights. Nothing is summed over the model ranks: each already
holds the whole gradient, and a sum would scale it by T.
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
from geoldm_tpu_torch.ops import com, fused_optim
from geoldm_tpu_torch.parallel import sharding
from geoldm_tpu_torch.parallel import sp as sp_mod
from geoldm_tpu_torch.train import optim as optim_mod
from geoldm_tpu_torch.utils import spans


@dataclass
class TrainState:
    model: nn.Module
    ema_model: Optional[nn.Module]  # the model itself when ema_decay == 0; None under TP
    optimizer: torch.optim.Optimizer
    clip: Optional[optim_mod.AdaptiveGradClip]
    params: List[nn.Parameter]  # what AdamW steps: the trainable ones (their shards under TP)
    sp_group: Optional[sharding.RankGroup] = None
    sp_params: List[nn.Parameter] = field(default_factory=list)  # summed over the SP ranks
    step: int = 0  # train steps taken (JAX's TrainState.step)
    dp_group: Optional[sharding.RankGroup] = None  # gradients averaged over the data ranks
    model_group: Optional[sharding.RankGroup] = None  # TP: hidden-width leaves sharded over it
    # TP: per parameter of the model, whether it is sharded (``sharding.tp_sharded``)
    sharded: List[bool] = field(default_factory=list)
    # TP: (full parameter, the shard AdamW steps: its rows, sharing its storage)
    shards: List[tuple] = field(default_factory=list)
    # TP with EMA: per parameter of the model, the EMA this rank keeps (its
    # rows of a sharded one)
    ema_params: List[torch.Tensor] = field(default_factory=list)
    # On the card: the fused optimizer step and its tables, built at the
    # first step and again once AdamW's state is replaced (a load); the EMA
    # and the parameters are loaded in place
    fused: Optional[fused_optim.FusedStep] = None


def create_train_state(model: nn.Module, model_cfg: ModelConfig, lr: float,
                       weight_decay: float = 1e-12, clip_grad: bool = True,
                       ema_decay: float = 0.9999,
                       dp_group: Optional[sharding.RankGroup] = None,
                       model_group: Optional[sharding.RankGroup] = None,
                       hidden_nf: Optional[int] = None) -> TrainState:
    """The train state of ``model``; with ``dp_group`` (this rank's data
    ranks) each step averages the gradients over them; with ``model_group``
    (this rank's model ranks, T > 1) every parameter JAX's rule shards at
    ``hidden_nf`` is owned a 1/T row block a rank: AdamW steps the block,
    the EMA keeps only it, and the full weights are gathered after each
    step."""
    mask = optim_mod.trainable_mask(model, model_cfg.kind, model_cfg.trainable_ae)
    named = list(model.named_parameters())
    tp = model_group.size if model_group is not None else 1
    sharded = [sharding.tp_sharded(p, hidden_nf, tp) for _, p in named]
    own = [sharding.own_shard(p.detach(), model_group) if sh else p
           for (_, p), sh in zip(named, sharded)]
    params, shards = [], []
    for (name, p), sh, o in zip(named, sharded, own):
        if mask[name]:
            params.append(nn.Parameter(o) if sh else p)
            if sh:
                shards.append((p, params[-1]))
    optimizer = optim_mod.make_optimizer(model, mask, lr, weight_decay, params=params)
    ema_model, ema_params = model, []
    if ema_decay > 0 and not any(sharded):
        ema_model = copy.deepcopy(model).requires_grad_(False)
    elif ema_decay > 0:
        ema_model, ema_params = None, [o.detach().clone() for o in own]
    device = next(model.parameters()).device
    clip = optim_mod.AdaptiveGradClip(device) if clip_grad else None
    sp_params = [p for p in sp_mod.block_parameters(model) if p.requires_grad]
    return TrainState(model, ema_model, optimizer, clip, params, sp_mod.model_group(model),
                      sp_params, dp_group=dp_group,
                      model_group=model_group if any(sharded) else None,
                      sharded=sharded if any(sharded) else [], shards=shards,
                      ema_params=ema_params)


def owned(state: TrainState) -> List[torch.Tensor]:
    """Under TP, per parameter of the model, what this rank owns of it: its
    rows of a sharded one (a view), else the parameter."""
    return [sharding.own_shard(p.detach(), state.model_group) if sh else p
            for p, sh in zip(state.model.parameters(), state.sharded)]


@torch.no_grad()
def ema_module(state: TrainState) -> nn.Module:
    """The EMA model to evaluate and sample with. Under TP a new module
    holding the EMA gathered over the model ranks (a collective: every rank
    calls it); otherwise ``state.ema_model``."""
    if not state.ema_params:
        return state.ema_model
    ema = copy.deepcopy(state.model).requires_grad_(False)
    for p, e in zip(ema.parameters(), _full_ema(state)):
        p.copy_(e)
    return ema


def _full_ema(state: TrainState) -> List[torch.Tensor]:
    """The EMA of every parameter, the sharded ones gathered (a collective)."""
    mine = [e for e, sh in zip(state.ema_params, state.sharded) if sh]
    full = iter(sharding.gather_shards(mine, state.model_group))
    return [next(full) if sh else e for e, sh in zip(state.ema_params, state.sharded)]


def ema_state_dict(state: TrainState) -> dict:
    """A CPU copy of the EMA model's state dict (the model's buffers, the
    EMA of every parameter; gathered under TP, a collective)."""
    if not state.ema_params:
        return {k: v.detach().cpu().clone() for k, v in state.ema_model.state_dict().items()}
    out = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    for (name, _), e in zip(state.model.named_parameters(), _full_ema(state)):
        out[name] = e.cpu().clone()
    return out


def _ema_pairs(state: TrainState, ema_decay: float) -> tuple:
    """(EMA tensors, what each averages) per parameter of the model: under
    TP this rank's EMA rows and owned rows; none without EMA."""
    if ema_decay <= 0:
        return [], []
    if state.ema_params:
        return state.ema_params, owned(state)
    return list(state.ema_model.parameters()), list(state.model.parameters())


def _fused_step(state: TrainState, ema_decay: float) -> fused_optim.FusedStep:
    """The state's fused optimizer step, built on first use and again once
    AdamW's state was replaced (``load_optimizer_state``) or the EMA's decay
    differs."""
    if state.ema_model is state.model:  # built without EMA: nothing to average
        ema_decay = 0.0
    if (state.fused is None or not state.fused.current(state.optimizer)
            or state.fused.ema_decay != max(ema_decay, 0.0)):
        mine = {id(s) for _, s in state.shards}
        grp = state.model_group
        state.fused = fused_optim.FusedStep(
            state.optimizer, [id(p) in mine for p in state.params],
            *_ema_pairs(state, ema_decay), ema_decay, state.clip,
            reduce=(lambda t: sharding.all_reduce(t, grp)) if mine else None)
    return state.fused


def _shard_index(state: TrainState) -> List[int]:
    """The indices in AdamW's state of the parameters it steps as shards."""
    ids = {id(s) for _, s in state.shards}
    return [i for i, p in enumerate(state.params) if id(p) in ids]


def optimizer_state_dict(state: TrainState) -> dict:
    """AdamW's state dict as one rank holds it: under TP the moments of
    every sharded parameter gathered over the model ranks (one collective),
    keyed by the full model's parameter order as on one rank."""
    sd = state.optimizer.state_dict()
    if state.model_group is None:
        return sd
    sd = {"state": {i: dict(e) for i, e in sd["state"].items()},
          "param_groups": sd["param_groups"]}
    keys = [(i, k) for i in _shard_index(state) if i in sd["state"]
            for k, v in sorted(sd["state"][i].items()) if torch.is_tensor(v) and v.dim() >= 1]
    full = sharding.gather_shards([sd["state"][i][k] for i, k in keys], state.model_group)
    for (i, k), t in zip(keys, full):
        sd["state"][i][k] = t
    return sd


def load_optimizer_state(state: TrainState, sd: dict) -> None:
    """Load a one-rank AdamW state dict (``optimizer_state_dict``'s shape);
    under TP each rank keeps its rows of the sharded parameters' moments."""
    if state.model_group is not None:
        sd = {"state": {i: dict(e) for i, e in sd["state"].items()},
              "param_groups": sd["param_groups"]}
        for i in _shard_index(state):
            for k, v in sd["state"].get(i, {}).items():
                if torch.is_tensor(v) and v.dim() >= 1:
                    sd["state"][i][k] = sharding.own_shard(v, state.model_group).clone()
    state.optimizer.load_state_dict(sd)


@torch.no_grad()
def load_ema_state_dict(state: TrainState, sd: dict) -> None:
    """Load a full EMA state dict; under TP each rank keeps its rows of the
    sharded parameters."""
    if not state.ema_params:
        state.ema_model.load_state_dict(sd, strict=True)
        return
    names = [n for n, _ in state.model.named_parameters()]
    missing = set(state.model.state_dict()) ^ set(sd)
    if missing:
        raise ValueError(f"EMA state dict keys differ from the model's: {sorted(missing)[:5]}")
    for name, e, sh in zip(names, state.ema_params, state.sharded):
        v = sd[name].to(e.device)
        e.copy_(sharding.own_shard(v, state.model_group) if sh else v)


def state_elements(state: TrainState) -> dict:
    """Elements of optimizer state (AMSGrad's three moments) and of EMA
    state this rank holds: under TP the replicated ones plus 1/T of the
    sharded ones."""
    optim = sum(v.numel() for e in state.optimizer.state.values() for v in e.values()
                if torch.is_tensor(v) and v.dim() >= 1)
    if state.ema_params:
        ema = sum(e.numel() for e in state.ema_params)
    else:
        ema = 0 if state.ema_model is state.model else sum(
            p.numel() for p in state.ema_model.parameters())
    return {"optim": optim, "ema": ema}


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
    global mean. After the gradient sums the optimizer tail (clip, AMSGrad,
    EMA) runs on the card as ``ops.fused_optim``'s three launches, on the
    CPU as its plain version. Under a profiler a step is a ``train.step``
    span (``utils.spans``, id the step number) holding ``train.zero_grad``,
    ``train.forward``, ``train.backward``, ``train.grad_reduce`` (each SP or
    DP gradient sum), ``train.clip`` and ``train.optimizer``, and on the CPU
    ``train.ema``; on the card ``train.clip`` holds the norm and threshold
    launches, ``train.optimizer`` the update, which moves the EMA too (no
    ``train.ema``), and the counter ``train.fused_optimizer`` adds 1 a
    step."""
    nll_fn = factory.model_nll_fn(model_cfg, training=True, compute_dtype=compute_dtype)

    def train_step(state: TrainState, batch: dict, noise: com.Noise,
                   keep: Optional[torch.Tensor] = None) -> dict:
        k = state.step
        with spans.span("train.step", k):
            with spans.span("train.zero_grad", k):
                state.optimizer.zero_grad(set_to_none=True)
                for p, _ in state.shards:
                    p.grad = None
            with spans.span("train.forward", k):
                context = batch.get("context")
                if context is not None and context_dropout > 0:
                    if keep is None:
                        keep = context_keep(noise, context, context_dropout)
                    context = context * keep
                nll = nll_fn(state.model, noise, batch["x"], batch["h_cat"], batch["h_int"],
                             batch["node_mask"], context)
                loss = (nll - batch["log_pN"]).mean()
            with spans.span("train.backward", k):
                loss.backward()
            if state.sp_params:
                with spans.span("train.grad_reduce", k):
                    sharding.reduce_grads(state.sp_params, state.sp_group)
            for p, shard in state.shards:  # TP: this rank's rows, a view
                shard.grad = None if p.grad is None else sharding.own_shard(p.grad,
                                                                            state.model_group)
            if state.dp_group is not None:
                with spans.span("train.grad_reduce", k):
                    (loss,) = sharding.reduce_grads(state.params, state.dp_group, loss,
                                                    mean=True)
            if state.params[0].is_cuda:
                fused = _fused_step(state, ema_decay)
                with spans.span("train.clip", k):
                    grad_norm = fused.clip_norm()
                with spans.span("train.optimizer", k):
                    fused.update()
                spans.count("train.fused_optimizer", 1)
            else:
                with spans.span("train.clip", k):
                    mine = {id(s) for _, s in state.shards}
                    grads = [p.grad for p in state.params
                             if p.grad is not None and id(p) not in mine]
                    shard_grads = [s.grad for _, s in state.shards if s.grad is not None]
                    if state.clip is not None:
                        grad_norm = state.clip(grads, shard_grads, state.model_group)
                    else:
                        grad_norm = optim_mod.global_norm(grads, shard_grads,
                                                          state.model_group)
                with spans.span("train.optimizer", k):
                    state.optimizer.step()
                with spans.span("train.ema", k):
                    if ema_decay > 0 and state.ema_params:
                        optim_mod.ema_update(state.ema_params, owned(state), ema_decay)
                    elif ema_decay > 0:
                        optim_mod.ema_update(state.ema_model, state.model, ema_decay)
            if state.shards:
                sharding.gather_shards([s.detach() for _, s in state.shards],
                                       state.model_group,
                                       out=[p.detach() for p, _ in state.shards])
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
