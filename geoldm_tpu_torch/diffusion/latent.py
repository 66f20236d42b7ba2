"""E(n) latent diffusion, sampling part (port of
``geoldm_tpu/diffusion/latent.py:133-164``): diffuse in the VAE's latent
space, then decode with the VAE.
"""

from __future__ import annotations

import torch
from torch import nn

from geoldm_tpu_torch.config import ModelConfig
from geoldm_tpu_torch.diffusion import schedules as S
from geoldm_tpu_torch.diffusion import vae as vae_mod
from geoldm_tpu_torch.diffusion import vdm
from geoldm_tpu_torch.nn.dynamics import EGNNDynamics
from geoldm_tpu_torch.ops import com


class PredefinedNoiseSchedule(nn.Module):
    """Holds the fixed gamma table as the frozen parameter ``gamma``
    (reference en_diffusion.py:172-207), for strict checkpoint loading."""

    def __init__(self, noise_schedule: str, timesteps: int, precision: float):
        super().__init__()
        table = S.gamma_table(noise_schedule, timesteps, precision)
        self.gamma = nn.Parameter(torch.from_numpy(table).float(), requires_grad=False)


class EnLatentDiffusion(nn.Module):
    """Upstream module layout: ``buffer``, ``gamma``, ``dynamics``, ``vae``
    (reference en_diffusion.py:254-296, :1057-1080)."""

    def __init__(self, model_cfg: ModelConfig):
        super().__init__()
        if model_cfg.kind != "latent_diffusion":
            raise NotImplementedError(f"model kind {model_cfg.kind!r} is not ported yet")
        d = model_cfg.diffusion
        self.cfg = model_cfg
        self.register_buffer("buffer", torch.zeros(1))
        self.gamma = PredefinedNoiseSchedule(d.noise_schedule, d.timesteps, d.noise_precision)
        self.dynamics = EGNNDynamics(model_cfg.dynamics)
        self.vae = vae_mod.EnHierarchicalVAE(model_cfg.vae)


@torch.no_grad()
def ldm_sample(model: EnLatentDiffusion, noise: com.Noise, node_mask,
               fix_noise: bool = False):
    """Diffuse in latent space, then decode (en_diffusion.py:1194-1204).
    -> (x [B,N,3], h_cat one-hot [B,N,C], h_int charges [B,N,inc])."""
    z_x, z_cat, z_int = vdm.vdm_sample(model.dynamics, model.cfg.diffusion, noise, node_mask,
                                       fix_noise)
    z_xh = torch.cat([z_x, z_cat, z_int], dim=2)
    return vae_mod.decode(model.vae, z_xh, node_mask)
