"""E(n) VAE (port of ``geoldm_tpu/diffusion/vae.py``): the
``EnHierarchicalVAE`` module layout, encode, decode, the reconstruction
error and the ELBO. The encoder posterior std is the fixed constant
``VAEConfig.encoder_sigma`` (reference en_diffusion.py:1012-1013).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geoldm_tpu_torch.config import VAEConfig
from geoldm_tpu_torch.nn.core import resolve_compute
from geoldm_tpu_torch.nn.dynamics import EGNNDecoder, EGNNEncoder
from geoldm_tpu_torch.ops import com


class EnHierarchicalVAE(nn.Module):
    """Upstream module layout: ``buffer``, ``encoder``, ``decoder``
    (reference en_diffusion.py:858-890)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("buffer", torch.zeros(1))
        self.encoder = EGNNEncoder(cfg.encoder_egnn, cfg.latent_nf, cfg.n_dims)
        self.decoder = EGNNDecoder(cfg.decoder_egnn, cfg.n_dims)


def sample_combined_noise(noise: com.Noise, node_mask, n_dims: int, latent_nf: int):
    b, n, _ = node_mask.shape
    z_x = com.sample_center_gravity_zero_gaussian_with_mask(noise, (b, n, n_dims), node_mask)
    z_h = com.sample_gaussian_with_mask(noise, (b, n, latent_nf), node_mask)
    return torch.cat([z_x, z_h], dim=2)


def encode(vae: EnHierarchicalVAE, x, h_cat, h_int, node_mask,
           context: Optional[torch.Tensor] = None, compute_dtype=None):
    """q(z | x, h) -> (z_x_mu [B,N,3], sigma_0_x [B,1,1], z_h_mu [B,N,L],
    sigma_0_h [B,1,L]) with the fixed posterior std (vae.py:47-70); the
    encoder in ``compute_dtype``."""
    cfg = vae.cfg
    z_x_mu, _, z_h_mu, _ = vae.encoder(torch.cat([x, h_cat, h_int], dim=2), node_mask, context,
                                       compute_dtype)
    b = z_x_mu.shape[0]
    sigma_0_x = torch.full((b, 1, 1), cfg.encoder_sigma, dtype=z_x_mu.dtype,
                           device=z_x_mu.device)
    sigma_0_h = torch.full((b, 1, cfg.latent_nf), cfg.encoder_sigma, dtype=z_h_mu.dtype,
                           device=z_h_mu.device)
    return z_x_mu, sigma_0_x, z_h_mu, sigma_0_h


def decode(vae: EnHierarchicalVAE, z_xh, node_mask, context: Optional[torch.Tensor] = None,
           compute_dtype=None):
    """p(x, h | z): decoder EGNN (in ``compute_dtype``), then argmax one-hot
    atom types and rounded charges (vae.py:73-96)."""
    cfg = vae.cfg
    x_recon, h_recon = vae.decoder(z_xh, node_mask, context, compute_dtype)
    xh = torch.cat([x_recon, h_recon], dim=2)
    x = xh[:, :, :cfg.n_dims]
    inc = int(cfg.include_charges)
    h_int = xh[:, :, xh.shape[2] - inc:] if inc else xh[:, :, :0]
    h_cat_raw = xh[:, :, cfg.n_dims:xh.shape[2] - inc]
    h_cat = torch.nn.functional.one_hot(h_cat_raw.argmax(dim=2), cfg.num_classes)
    return x, h_cat.to(xh.dtype) * node_mask, torch.round(h_int) * node_mask


def compute_reconstruction_error(cfg: VAEConfig, xh_rec, xh, training: bool) -> torch.Tensor:
    """MSE on x + cross-entropy on atom types + MSE on charges -> [B]
    (vae.py:99-127)."""
    nd, nc = cfg.n_dims, cfg.num_classes
    error_x = com.sum_except_batch((xh_rec[:, :, :nd] - xh[:, :, :nd]) ** 2)
    logp = torch.log_softmax(xh_rec[:, :, nd:nd + nc], dim=-1)
    labels = xh[:, :, nd:nd + nc].argmax(dim=-1)
    error_h_cat = -logp.gather(-1, labels[..., None])[..., 0].sum(dim=1)
    error = error_x + error_h_cat
    if cfg.include_charges:
        error = error + com.sum_except_batch((xh_rec[:, :, -1:] - xh[:, :, -1:]) ** 2)
    if training:
        error = error / ((cfg.n_dims + cfg.in_node_nf) * xh.shape[1])
    return error


def compute_loss(vae: EnHierarchicalVAE, noise: com.Noise, x, h_cat, h_int, node_mask,
                 context: Optional[torch.Tensor], training: bool, compute_dtype=None):
    """ELBO estimator recon + kl_weight * KL -> (loss [B], (recon [B], kl [B]))
    (vae.py:135-187); the encoder and decoder in ``compute_dtype`` (None or
    torch.bfloat16)."""
    cfg = vae.cfg
    xh = torch.cat([x, h_cat, h_int], dim=2)
    z_x_mu, z_x_sigma, z_h_mu, z_h_sigma = encode(vae, x, h_cat, h_int, node_mask, context,
                                                  compute_dtype)
    # KL of the invariant block against N(0, 1) with unit posterior std (the
    # reference passes ones for q_sigma, en_diffusion.py:945-946).
    ones_h = torch.ones_like(z_h_mu)
    loss_kl_h = com.gaussian_kl(z_h_mu, ones_h, torch.zeros_like(z_h_mu), ones_h, node_mask)
    ones_b = torch.ones(z_x_mu.shape[0], dtype=z_x_mu.dtype, device=z_x_mu.device)
    loss_kl_x = com.gaussian_kl_for_dimension(
        z_x_mu, ones_b, torch.zeros_like(z_x_mu), ones_b,
        com.subspace_dimensionality(node_mask, cfg.n_dims))
    loss_kl = loss_kl_h + loss_kl_x

    z_xh_mean = torch.cat([z_x_mu, z_h_mu], dim=2)
    z_xh_sigma = torch.cat([z_x_sigma.expand_as(z_x_mu), z_h_sigma.expand_as(z_h_mu)], dim=2)
    z_xh = z_xh_mean + z_xh_sigma * sample_combined_noise(noise, node_mask, cfg.n_dims,
                                                          cfg.latent_nf)
    x_recon, h_recon = vae.decoder(z_xh, node_mask, context, compute_dtype)
    loss_recon = compute_reconstruction_error(cfg, torch.cat([x_recon, h_recon], dim=2), xh,
                                              training)
    return loss_recon + cfg.kl_weight * loss_kl, (loss_recon, loss_kl)


def vae_nll(vae: EnHierarchicalVAE, noise: com.Noise, x, h_cat, h_int, node_mask,
            context: Optional[torch.Tensor] = None, training: bool = False,
            compute_dtype=None) -> torch.Tensor:
    """ELBO-based NLL estimate [B] (vae.py:190-208); ``compute_dtype`` a
    compute-dtype name or spec, resolved here."""
    dtype = resolve_compute(compute_dtype).operand
    return compute_loss(vae, noise, x, h_cat, h_int, node_mask, context, training, dtype)[0]
