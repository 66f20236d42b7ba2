"""The model a configuration file states: its weights, made from the seed
on the device, loaded with ``load_state_dict(strict=True)`` into the model
the program's factory builds."""

from __future__ import annotations

from typing import Dict

import torch

from reference import model as R


def weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in upstream's state-dict layout, drawn from the seed
    on the device in one call (torch's default Linear init and the
    coordinate MLPs' small last layer), float32, plus the buffers."""
    M = R.describe(cfg)
    specs = R.param_specs(M)
    bounds = R.init_bounds(specs)
    sizes = [int(torch.Size(s).numel()) for _, s, _ in specs]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    sd = {}
    for (name, shape, _), bound, part in zip(specs, bounds, flat.split(sizes)):
        sd[name] = (part * bound).view(shape)
    sd.update(R.buffers(M, device))
    return sd


def program_config(cfg: dict):
    """The program's ModelConfig for a configuration file (as its training
    CLIs build it from the same flags)."""
    from geoldm_tpu_torch.data.datasets_config import get_dataset_info
    from geoldm_tpu_torch.models import factory

    return factory.make_latent_diffusion_config(
        get_dataset_info(cfg["dataset"]), include_charges=cfg["include_charges"],
        nf=cfg["nf"], n_layers=cfg["n_layers"], latent_nf=cfg["latent_nf"],
        kl_weight=cfg["kl_weight"], trainable_ae=cfg["trainable_ae"],
        attention=cfg["attention"], tanh=cfg["tanh"], norm_constant=cfg["norm_constant"],
        inv_sublayers=cfg["inv_sublayers"], sin_embedding=cfg["sin_embedding"],
        normalization_factor=cfg["normalization_factor"],
        aggregation_method=cfg["aggregation_method"], diffusion_steps=cfg["diffusion_steps"],
        noise_schedule=cfg["diffusion_noise_schedule"],
        noise_precision=cfg["diffusion_noise_precision"], loss_type=cfg["diffusion_loss_type"],
        normalize_factors=tuple(float(v) for v in cfg["normalize_factors"]),
        model=cfg["model"], condition_time=cfg["condition_time"])


def program_model(cfg: dict, sd: Dict[str, torch.Tensor], device):
    """The program's model, built by its factory and loaded strictly with
    ``sd`` (copied)."""
    from geoldm_tpu_torch.models import factory

    model = factory.build_model(program_config(cfg), device)
    model.load_state_dict(sd, strict=True)
    return model
