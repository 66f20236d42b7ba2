"""Model factories (port of ``geoldm_tpu/models/factory.py:29-354``): build
the frozen config tree of each model kind (the plain E(n) diffusion model,
the first-stage VAE, the latent diffusion model), then the ``nn.Module`` on a
device, the NLL function that trains it and the sampler of a generative
kind.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from geoldm_tpu_torch.config import (
    DiffusionConfig,
    DynamicsConfig,
    EGNNConfig,
    ModelConfig,
    VAEConfig,
)
from geoldm_tpu_torch.diffusion import latent as ldm
from geoldm_tpu_torch.diffusion import schedules as S
from geoldm_tpu_torch.diffusion import vae as vae_mod
from geoldm_tpu_torch.diffusion import vdm
from geoldm_tpu_torch.diffusion.latent import EnLatentDiffusion
from geoldm_tpu_torch.nn.egnn import init_parameters
from geoldm_tpu_torch.utils.device import resolve_device


def _egnn_cfg(in_node_nf: int, out_node_nf: int, nf: int, n_layers: int, *,
              attention: bool = True, tanh: bool = True, norm_constant: float = 1.0,
              inv_sublayers: int = 1, sin_embedding: bool = False,
              normalization_factor: float = 1.0, aggregation_method: str = "sum",
              remat: bool = False) -> EGNNConfig:
    return EGNNConfig(
        in_node_nf=in_node_nf, out_node_nf=out_node_nf, hidden_nf=nf, n_layers=n_layers,
        inv_sublayers=inv_sublayers, attention=attention, tanh=tanh, coords_range=15.0,
        norm_constant=norm_constant, sin_embedding=sin_embedding,
        normalization_factor=normalization_factor, aggregation_method=aggregation_method,
        remat=remat,
    )


def make_diffusion_model_config(
    dataset_info, *, include_charges: bool = True, condition_time: bool = True,
    context_node_nf: int = 0, context_indicator: bool = False, nf: int = 256,
    n_layers: int = 9, attention: bool = True, tanh: bool = True,
    norm_constant: float = 1.0, inv_sublayers: int = 1, sin_embedding: bool = False,
    normalization_factor: float = 1.0, aggregation_method: str = "sum",
    remat: bool = False, diffusion_steps: int = 1000, noise_schedule: str = "polynomial_2",
    noise_precision: float = 1e-5, loss_type: str = "l2",
    normalize_factors: Tuple[float, float, float] = (1.0, 4.0, 10.0),
    model: str = "egnn_dynamics",
) -> ModelConfig:
    """The plain E(n) diffusion model over (x, h), kind 'diffusion'
    (reference qm9/models.py:12-51; factory.py:61-126). The defaults are
    EDM's QM9 recipe. ``gnn_dynamics`` takes [x, h] and returns [vel, h]:
    3 more input and output channels."""
    if context_indicator:
        context_node_nf += 1
    in_node_nf = len(dataset_info["atom_decoder"]) + int(include_charges)
    dyn_in = in_node_nf + int(condition_time)
    extra = 3 if model == "gnn_dynamics" else 0
    egnn = _egnn_cfg(
        dyn_in + context_node_nf + extra, dyn_in + context_node_nf + extra, nf, n_layers,
        attention=attention, tanh=tanh, norm_constant=norm_constant,
        inv_sublayers=inv_sublayers, sin_embedding=sin_embedding,
        normalization_factor=normalization_factor, aggregation_method=aggregation_method,
        remat=remat)
    dynamics = DynamicsConfig(in_node_nf=in_node_nf, context_node_nf=context_node_nf, n_dims=3,
                              condition_time=condition_time, mode=model, egnn=egnn)
    diffusion = DiffusionConfig(
        in_node_nf=in_node_nf, n_dims=3, timesteps=diffusion_steps,
        noise_schedule=noise_schedule, noise_precision=noise_precision, loss_type=loss_type,
        norm_values=tuple(normalize_factors), include_charges=include_charges)
    return ModelConfig(kind="diffusion", diffusion=diffusion, dynamics=dynamics,
                       context_indicator=context_indicator)


def make_vae_config(dataset_info, *, include_charges: bool = True, context_node_nf: int = 0,
                    context_indicator: bool = False, nf: int = 256, n_layers: int = 9,
                    latent_nf: int = 1, kl_weight: float = 0.01, attention: bool = True,
                    tanh: bool = True, norm_constant: float = 1.0, inv_sublayers: int = 1,
                    sin_embedding: bool = False, normalization_factor: float = 1.0,
                    aggregation_method: str = "sum", remat: bool = False) -> ModelConfig:
    """First-stage VAE; the encoder always has one layer
    (reference: qm9/models.py:69-77)."""
    if context_indicator:
        context_node_nf += 1
    in_node_nf = len(dataset_info["atom_decoder"]) + int(include_charges)
    common = dict(attention=attention, tanh=tanh, norm_constant=norm_constant,
                  inv_sublayers=inv_sublayers, sin_embedding=sin_embedding,
                  normalization_factor=normalization_factor,
                  aggregation_method=aggregation_method, remat=remat)
    vae = VAEConfig(
        in_node_nf=in_node_nf, latent_nf=latent_nf, n_dims=3, kl_weight=kl_weight,
        include_charges=include_charges,
        encoder_egnn=_egnn_cfg(in_node_nf + context_node_nf, nf, nf, 1, **common),
        decoder_egnn=_egnn_cfg(latent_nf + context_node_nf, in_node_nf, nf, n_layers, **common),
        context_node_nf=context_node_nf,
    )
    return ModelConfig(kind="vae", vae=vae, context_indicator=context_indicator)


def make_latent_diffusion_config(
    dataset_info, *, include_charges: bool = True, condition_time: bool = True,
    context_node_nf: int = 0, context_indicator: bool = False, nf: int = 256,
    n_layers: int = 9, latent_nf: int = 1, kl_weight: float = 0.01,
    trainable_ae: bool = False, attention: bool = True, tanh: bool = True,
    norm_constant: float = 1.0, inv_sublayers: int = 1, sin_embedding: bool = False,
    normalization_factor: float = 1.0, aggregation_method: str = "sum",
    remat: bool = False, diffusion_steps: int = 1000, noise_schedule: str = "polynomial_2",
    noise_precision: float = 1e-5, loss_type: str = "l2",
    normalize_factors: Tuple[float, float, float] = (1.0, 4.0, 10.0),
    model: str = "egnn_dynamics",
) -> ModelConfig:
    """VAE + diffusion in its latent space (reference: qm9/models.py:103-166)."""
    if context_indicator:
        context_node_nf += 1
    vae_model = make_vae_config(
        dataset_info, include_charges=include_charges, context_node_nf=context_node_nf,
        nf=nf, n_layers=n_layers, latent_nf=latent_nf, kl_weight=kl_weight,
        attention=attention, tanh=tanh, norm_constant=norm_constant,
        inv_sublayers=inv_sublayers, sin_embedding=sin_embedding,
        normalization_factor=normalization_factor, aggregation_method=aggregation_method,
        remat=remat)
    dyn_in = latent_nf + int(condition_time)
    extra = 3 if model == "gnn_dynamics" else 0
    egnn = _egnn_cfg(
        dyn_in + context_node_nf + extra, dyn_in + context_node_nf + extra, nf, n_layers,
        attention=attention, tanh=tanh, norm_constant=norm_constant,
        inv_sublayers=inv_sublayers, sin_embedding=sin_embedding,
        normalization_factor=normalization_factor, aggregation_method=aggregation_method,
        remat=remat)
    dynamics = DynamicsConfig(in_node_nf=latent_nf, context_node_nf=context_node_nf, n_dims=3,
                              condition_time=condition_time, mode=model, egnn=egnn)
    diffusion = DiffusionConfig(
        in_node_nf=latent_nf, n_dims=3, timesteps=diffusion_steps,
        noise_schedule=noise_schedule, noise_precision=noise_precision, loss_type=loss_type,
        norm_values=tuple(normalize_factors), include_charges=include_charges)
    return ModelConfig(kind="latent_diffusion", diffusion=diffusion, dynamics=dynamics,
                       vae=vae_model.vae, trainable_ae=trainable_ae,
                       context_indicator=context_indicator)


def check_diffusion_config(d: DiffusionConfig) -> None:
    """JAX's ``vdm_init`` checks (geoldm_tpu/diffusion/vdm.py:41-53): the
    learned schedule requires the vlb loss; a predefined one must leave
    sigma_0 small against the normalisation."""
    if d.noise_schedule == "learned":
        if d.loss_type != "vlb":
            raise ValueError("learned schedule requires vlb loss")
    else:
        S.check_issues_norm_values(
            S.gamma_table(d.noise_schedule, d.timesteps, d.noise_precision), d.norm_values)


def build_model(cfg: ModelConfig, device="cuda",
                generator: Optional[torch.Generator] = None, sp_group=None):
    """The model on ``device`` (the card unless the caller asks for the
    CPU), in eval mode: an ``EnLatentDiffusion``, an ``EnHierarchicalVAE``
    for the 'vae' kind, or an ``EnVariationalDiffusion`` for the plain
    'diffusion' kind. With ``generator`` every weight is drawn from it
    (reference init); otherwise the caller loads a state dict. With
    ``sp_group`` (a ``parallel.sharding.RankGroup``) every EGNN of the model
    runs sequence-parallel over it (a GNN denoiser and the learned gamma
    network stay replicated); a deep copy of the model (the EMA model) keeps
    the group."""
    dev = resolve_device(device)
    if cfg.kind == "vae":
        model = vae_mod.EnHierarchicalVAE(cfg.vae)
    elif cfg.kind in ("diffusion", "latent_diffusion"):
        check_diffusion_config(cfg.diffusion)
        model = (EnLatentDiffusion(cfg) if cfg.kind == "latent_diffusion"
                 else vdm.EnVariationalDiffusion(cfg))
    else:
        raise ValueError(f"unknown model kind {cfg.kind!r}")
    if generator is not None:
        init_parameters(model, generator)
    if sp_group is not None:
        from geoldm_tpu_torch.parallel import sp

        sp.attach(model, sp_group)
    return model.to(dev).eval()


def model_nll_fn(model_cfg: ModelConfig, training: bool, compute_dtype=None):
    """nll(model, noise, x, h_cat, h_int, node_mask, context=None) -> [B] for
    the configured model kind (factory.py:278-320), in ``compute_dtype``
    (a name or spec of ``nn.core``), with grad too (``training``: the train
    step's)."""
    if model_cfg.kind == "vae":
        def nll(model, noise, x, h_cat, h_int, node_mask, context=None):
            return vae_mod.vae_nll(model, noise, x, h_cat, h_int, node_mask, context, training,
                                   compute_dtype)
        return nll
    if model_cfg.kind == "latent_diffusion":
        def nll(model, noise, x, h_cat, h_int, node_mask, context=None):
            return ldm.ldm_nll(model, noise, x, h_cat, h_int, node_mask, context, training,
                               compute_dtype)
        return nll
    if model_cfg.kind == "diffusion":
        def nll(model, noise, x, h_cat, h_int, node_mask, context=None):
            return vdm.vdm_nll(model, noise, x, h_cat, h_int, node_mask, context, training,
                               compute_dtype)
        return nll
    raise ValueError(f"unknown model kind {model_cfg.kind!r}")


def model_sample_fn(model_cfg: ModelConfig, compute_dtype=None, n_steps=None,
                    eta: float = 1.0, method: str = "ddim", guidance_scale: float = 1.0,
                    clip_z: float = 0.0):
    """sample(model, noise, node_mask, context=None, fix_noise=False) -> (x,
    h_cat one-hot, h_int charges) for a generative kind (factory.py:323-354),
    with the sampler settings of ``vdm.vdm_sample``; the latent model
    decodes with its VAE. A VAE is not a generative sampler."""
    settings = dict(n_steps=n_steps, eta=eta, method=method, clip_z=clip_z,
                    guidance_scale=guidance_scale)
    if model_cfg.kind == "latent_diffusion":
        def sample(model, noise, node_mask, context=None, fix_noise=False):
            return ldm.ldm_sample(model, noise, node_mask, fix_noise, compute_dtype,
                                  context=context, **settings)
        return sample
    if model_cfg.kind == "diffusion":
        @torch.no_grad()
        def sample(model, noise, node_mask, context=None, fix_noise=False):
            return vdm.vdm_sample(model.dynamics, model_cfg.diffusion, noise, node_mask,
                                  fix_noise, compute_dtype, context=context,
                                  latent_space=False, gamma=model.gamma, **settings)
        return sample
    raise ValueError(f"{model_cfg.kind} is not a generative sampler")
