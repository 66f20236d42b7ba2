"""E(n) latent diffusion (port of ``geoldm_tpu/diffusion/latent.py:45-164``):
the NLL estimator that trains it and the sampler.

- ``ldm_nll`` encodes (x, h) with the VAE, samples the latent with the
  diffusion's sigma_0 and detaches it: the encoder never receives a
  gradient (reference en_diffusion.py:1142-1155). With ``trainable_ae`` the
  decoder also learns through a reconstruction term on that latent.
- ``ldm_sample`` diffuses in latent space (with a conditional model's
  context, guided or not), then decodes with the VAE;
  ``ldm_sample_chain`` keeps and decodes the dense sampler's chain.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from geoldm_tpu_torch.config import ModelConfig
from geoldm_tpu_torch.diffusion import schedules as S
from geoldm_tpu_torch.diffusion import vae as vae_mod
from geoldm_tpu_torch.diffusion import vdm
from geoldm_tpu_torch.nn.core import resolve_compute
from geoldm_tpu_torch.ops import com


class EnLatentDiffusion(vdm.EnVariationalDiffusion):
    """Upstream module layout: ``buffer``, ``gamma``, ``dynamics``, ``vae``
    (reference en_diffusion.py:254-296, :1057-1080). ``gamma`` is either
    schedule's module and ``dynamics`` either mode's network."""

    def __init__(self, model_cfg: ModelConfig):
        if model_cfg.kind != "latent_diffusion":
            raise ValueError(f"EnLatentDiffusion takes a latent_diffusion config, "
                             f"not {model_cfg.kind!r}")
        super().__init__(model_cfg)
        self.vae = vae_mod.EnHierarchicalVAE(model_cfg.vae)


def log_constants_p_h_given_z0(cfg, gamma_fn, node_mask) -> torch.Tensor:
    """Constant part of log p(h | z0) in latent space, with n_nodes * n_dims
    degrees of freedom exactly as the reference (latent.py:45-56)."""
    b = node_mask.shape[0]
    degrees_of_freedom_h = com.num_nodes(node_mask) * cfg.n_dims
    gamma_0 = gamma_fn(torch.zeros((b, 1), dtype=torch.float32, device=node_mask.device))
    log_sigma_x = 0.5 * gamma_0.reshape(b)
    return degrees_of_freedom_h * (-log_sigma_x - 0.5 * math.log(2 * math.pi))


def ldm_nll(model: EnLatentDiffusion, noise: com.Noise, x, h_cat, h_int, node_mask,
            context: Optional[torch.Tensor] = None, training: bool = False,
            compute_dtype=None) -> torch.Tensor:
    """-log p(x, h) estimator [B] (latent.py:64-130). Draws from ``noise``,
    in order: the encoder's eps (x block, then h block), then those of
    ``vdm.compute_loss``. The encoder, decoder and denoiser run in
    ``compute_dtype`` (a name resolved here), under grad too: the train
    step's bf16 gradient runs the bf16 backward kernels."""
    cfg, vae_cfg = model.cfg.diffusion, model.cfg.vae
    compute_dtype = resolve_compute(compute_dtype).operand
    gamma_fn = model.gamma
    with torch.no_grad():  # the latent is detached: the encoder runs forward only
        z_x_mu, _, z_h_mu, _ = vae_mod.encode(model.vae, x, h_cat, h_int, node_mask, context,
                                              compute_dtype)
        b = x.shape[0]
        sigma_0 = S.sigma(gamma_fn(torch.zeros((b, 1), dtype=torch.float32, device=x.device)),
                          x.dim())
        eps = vae_mod.sample_combined_noise(noise, node_mask, cfg.n_dims, vae_cfg.latent_nf)
        z_xh = torch.cat([z_x_mu, z_h_mu], dim=2) + sigma_0 * eps

    if model.cfg.trainable_ae:
        xh = torch.cat([x, h_cat, h_int], dim=2)
        x_recon, h_recon = model.vae.decoder(z_xh, node_mask, context, compute_dtype)
        loss_recon = vae_mod.compute_reconstruction_error(
            vae_cfg, torch.cat([x_recon, h_recon], dim=2), xh, training)
    else:
        loss_recon = torch.zeros((b,), dtype=x.dtype, device=x.device)

    # The diffusion loss in latent space: z_h is the 'integer' block.
    z_x, z_h = z_xh[:, :, :cfg.n_dims], z_xh[:, :, cfg.n_dims:]
    loss_ld, _ = vdm.compute_loss(model.dynamics, cfg, noise, z_x, z_h[:, :, :0], z_h,
                                  node_mask, context, t0_always=not training,
                                  training=training, latent_space=True,
                                  compute_dtype=compute_dtype, gamma=model.gamma)
    neg_log_constants = -log_constants_p_h_given_z0(cfg, gamma_fn, node_mask)
    if training and cfg.loss_type == "l2":
        neg_log_constants = torch.zeros_like(neg_log_constants)
    return loss_ld + loss_recon + neg_log_constants


@torch.no_grad()
def ldm_sample(model: EnLatentDiffusion, noise: com.Noise, node_mask,
               fix_noise: bool = False, compute_dtype=None, n_steps: Optional[int] = None,
               eta: float = 1.0, method: str = "ddim", clip_z: float = 0.0,
               context: Optional[torch.Tensor] = None, guidance_scale: float = 1.0):
    """Diffuse in latent space, then decode (en_diffusion.py:1194-1204;
    latent.py:133-164). ``compute_dtype``, ``n_steps``, ``eta``, ``method``,
    ``clip_z``, ``context`` and ``guidance_scale`` as ``vdm.vdm_sample``;
    the decoder runs in ``compute_dtype`` as JAX's does, on the same
    (unguided) context. -> (x [B,N,3], h_cat one-hot [B,N,C], h_int charges
    [B,N,inc])."""
    z_x, z_cat, z_int = vdm.vdm_sample(model.dynamics, model.cfg.diffusion, noise, node_mask,
                                       fix_noise, compute_dtype, n_steps=n_steps, eta=eta,
                                       method=method, clip_z=clip_z, context=context,
                                       guidance_scale=guidance_scale, gamma=model.gamma)
    z_xh = torch.cat([z_x, z_cat, z_int], dim=2)
    return vae_mod.decode(model.vae, z_xh, node_mask, context,
                          resolve_compute(compute_dtype).operand)


@torch.no_grad()
def ldm_sample_chain(model: EnLatentDiffusion, noise: com.Noise, node_mask,
                     keep_frames: int = 100, compute_dtype=None,
                     context: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense sampler's latent chain, each frame decoded
    (en_diffusion.py:1207-1232; latent.py:167-196) -> [keep_frames, B, N,
    3 + C + inc], frame 0 the final sample. ``context``: a conditional
    model's, for the denoiser and the decoder."""
    _, chain = vdm.vdm_sample(model.dynamics, model.cfg.diffusion, noise, node_mask, False,
                              compute_dtype, keep_frames=keep_frames, context=context,
                              gamma=model.gamma)
    dtype = resolve_compute(compute_dtype).operand
    return torch.stack([torch.cat(vae_mod.decode(model.vae, z_xh, node_mask, context, dtype),
                                  dim=2) for z_xh in chain])
