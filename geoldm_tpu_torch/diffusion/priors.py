"""Standalone priors over (coordinates, features) (port of
``geoldm_tpu/diffusion/priors.py``; reference PositionFeaturePrior /
PositionPrior, equivariant_diffusion/distributions.py:11-57): a zero-CoM
Gaussian over the coordinates x and a standard Gaussian over the invariant
features h. Samples draw from an explicit noise source (``ops.com.Noise``: a
``torch.Generator`` or a callable), x's draw before h's, as JAX splits its
key.
"""

from __future__ import annotations

import torch

from geoldm_tpu_torch.ops import com


def position_feature_prior_log_prob(z_x: torch.Tensor, z_h: torch.Tensor,
                                    node_mask: torch.Tensor) -> torch.Tensor:
    """log p(z_x, z_h) on the masked zero-CoM x subspace plus the standard
    h. -> [B]"""
    return (com.center_gravity_zero_gaussian_log_likelihood_with_mask(z_x, node_mask)
            + com.standard_gaussian_log_likelihood_with_mask(z_h, node_mask))


def position_feature_prior_sample(noise: com.Noise, n_dim: int, in_node_nf: int,
                                  node_mask: torch.Tensor):
    """-> (z_x [B,N,n_dim] CoM-free and masked, z_h [B,N,in_node_nf] masked)."""
    b, n, _ = node_mask.shape
    z_x = com.sample_center_gravity_zero_gaussian_with_mask(noise, (b, n, n_dim), node_mask)
    z_h = com.sample_gaussian_with_mask(noise, (b, n, in_node_nf), node_mask)
    return z_x, z_h


def position_prior_log_prob(x: torch.Tensor) -> torch.Tensor:
    """The zero-CoM Gaussian's log-density with every node real. -> [B]"""
    b, n, _ = x.shape
    mask = torch.ones((b, n, 1), dtype=x.dtype, device=x.device)
    return com.center_gravity_zero_gaussian_log_likelihood_with_mask(x, mask)


def position_prior_sample(noise: com.Noise, shape, device="cuda") -> torch.Tensor:
    """A CoM-free [B, N, D] draw with every node real, on ``device`` (the
    card unless the caller asks for the CPU)."""
    from geoldm_tpu_torch.utils.device import resolve_device

    b, n, _ = shape
    mask = torch.ones((b, n, 1), dtype=torch.float32, device=resolve_device(device))
    return com.sample_center_gravity_zero_gaussian_with_mask(noise, tuple(shape), mask)
