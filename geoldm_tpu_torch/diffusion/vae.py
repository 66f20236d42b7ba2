"""E(n) VAE, sampling part (port of ``geoldm_tpu/diffusion/vae.py``):
the ``EnHierarchicalVAE`` module layout, the decode step and the latent
noise. Encoding and the ELBO belong to the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from geoldm_tpu_torch.config import VAEConfig
from geoldm_tpu_torch.nn.dynamics import EGNNDecoder, EGNNEncoder
from geoldm_tpu_torch.ops import com


class EnHierarchicalVAE(nn.Module):
    """Upstream module layout: ``buffer``, ``encoder``, ``decoder``
    (reference en_diffusion.py:858-890)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.register_buffer("buffer", torch.zeros(1))
        self.encoder = EGNNEncoder(cfg.encoder_egnn, cfg.latent_nf)
        self.decoder = EGNNDecoder(cfg.decoder_egnn, cfg.n_dims)


def sample_combined_noise(noise: com.Noise, node_mask, n_dims: int, latent_nf: int):
    b, n, _ = node_mask.shape
    z_x = com.sample_center_gravity_zero_gaussian_with_mask(noise, (b, n, n_dims), node_mask)
    z_h = com.sample_gaussian_with_mask(noise, (b, n, latent_nf), node_mask)
    return torch.cat([z_x, z_h], dim=2)


def decode(vae: EnHierarchicalVAE, z_xh, node_mask, context: Optional[torch.Tensor] = None):
    """p(x, h | z): decoder EGNN, then argmax one-hot atom types and rounded
    charges (vae.py:73-96)."""
    cfg = vae.cfg
    x_recon, h_recon = vae.decoder(z_xh, node_mask, context)
    xh = torch.cat([x_recon, h_recon], dim=2)
    x = xh[:, :, :cfg.n_dims]
    inc = int(cfg.include_charges)
    h_int = xh[:, :, xh.shape[2] - inc:] if inc else xh[:, :, :0]
    h_cat_raw = xh[:, :, cfg.n_dims:xh.shape[2] - inc]
    h_cat = torch.nn.functional.one_hot(h_cat_raw.argmax(dim=2), cfg.num_classes)
    return x, h_cat.to(xh.dtype) * node_mask, torch.round(h_int) * node_mask
