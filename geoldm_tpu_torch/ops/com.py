"""Masked centre-of-mass (CoM) subspace utilities and masked Gaussians.

Port of ``geoldm_tpu/ops/com.py:31-136``. Shapes: ``x`` is ``[B, N, D]``,
``node_mask`` is ``[B, N, 1]`` with values in {0, 1}; padded entries of any
masked tensor are exactly zero.

Noise comes from a ``noise`` source: a ``torch.Generator`` (the default
everywhere in the port) or any callable ``noise(shape) -> Tensor`` of
standard normals, so tests can feed both frameworks the same numbers. A
callable source that also serves integer draws (the diffusion timestep of a
training loss) has a method ``randint(low, high, shape)``.
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch

Noise = Union[torch.Generator, Callable[[tuple], torch.Tensor]]


def randn(noise: Noise, shape, like: torch.Tensor) -> torch.Tensor:
    """Standard normals of ``shape`` on ``like``'s device and dtype."""
    if isinstance(noise, torch.Generator):
        return torch.randn(tuple(shape), generator=noise, device=like.device,
                           dtype=like.dtype)
    out = torch.as_tensor(noise(tuple(shape)), dtype=like.dtype, device=like.device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"noise source returned {tuple(out.shape)}, wanted {tuple(shape)}")
    return out


def randint(noise: Noise, low: int, high: int, shape, like: torch.Tensor) -> torch.Tensor:
    """Integers uniform in [low, high) of ``shape`` on ``like``'s device."""
    if isinstance(noise, torch.Generator):
        return torch.randint(low, high, tuple(shape), generator=noise, device=like.device)
    out = torch.as_tensor(noise.randint(low, high, tuple(shape)), device=like.device)
    if tuple(out.shape) != tuple(shape):
        raise ValueError(f"noise source returned {tuple(out.shape)}, wanted {tuple(shape)}")
    return out


def sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    """Sum over all axes except the leading batch axis. -> [B]"""
    return x.reshape(x.shape[0], -1).sum(dim=-1)


def num_nodes(node_mask: torch.Tensor) -> torch.Tensor:
    """Number of real nodes per molecule. node_mask [B, N, 1] -> [B]"""
    return node_mask[:, :, 0].sum(dim=1)


def subspace_dimensionality(node_mask: torch.Tensor, n_dims: int) -> torch.Tensor:
    """Dimension of the zero-CoM subspace, (N - 1) * n_dims. -> [B]
    reference: en_diffusion.py:339-342."""
    return (num_nodes(node_mask) - 1.0) * n_dims


def remove_mean_with_mask(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Project x onto the zero-CoM subspace, respecting the node mask.

    Assumes padded rows of ``x`` are already zero.
    reference: equivariant_diffusion/utils.py:31-38."""
    n = node_mask.sum(dim=1, keepdim=True)  # [B, 1, 1]
    mean = x.sum(dim=1, keepdim=True) / n
    return x - mean * node_mask


def sample_gaussian_with_mask(noise: Noise, shape, node_mask: torch.Tensor) -> torch.Tensor:
    """Standard normal noise, zeroed at padded nodes."""
    return randn(noise, shape, node_mask) * node_mask


def sample_center_gravity_zero_gaussian_with_mask(
    noise: Noise, shape, node_mask: torch.Tensor
) -> torch.Tensor:
    """Normal noise projected onto the masked zero-CoM subspace."""
    x = randn(noise, shape, node_mask) * node_mask
    return remove_mean_with_mask(x, node_mask)


def center_gravity_zero_gaussian_log_likelihood_with_mask(x: torch.Tensor,
                                                          node_mask: torch.Tensor) -> torch.Tensor:
    """log N(x; 0, I) on the (N-1)*D-dim zero-CoM subspace. -> [B]
    reference: equivariant_diffusion/utils.py:87-104."""
    r2 = sum_except_batch(x * x)
    degrees_of_freedom = subspace_dimensionality(node_mask, x.shape[2])
    return -0.5 * r2 - 0.5 * degrees_of_freedom * math.log(2 * math.pi)


def standard_gaussian_log_likelihood_with_mask(x: torch.Tensor,
                                               node_mask: torch.Tensor) -> torch.Tensor:
    """Masked elementwise standard-normal log density, summed per molecule.
    reference: equivariant_diffusion/utils.py:130-134."""
    log_px = -0.5 * x * x - 0.5 * math.log(2 * math.pi)
    return sum_except_batch(log_px * node_mask)


def gaussian_kl(q_mu, q_sigma, p_mu, p_sigma, node_mask) -> torch.Tensor:
    """KL(q || p) between diagonal Gaussians, masked and summed per molecule.
    reference: en_diffusion.py:83-100."""
    term = (torch.log(p_sigma / (q_sigma + 1e-8) + 1e-8)
            + 0.5 * (q_sigma * q_sigma + (q_mu - p_mu) ** 2) / (p_sigma * p_sigma) - 0.5)
    return sum_except_batch(term * node_mask)


def gaussian_kl_for_dimension(q_mu, q_sigma, p_mu, p_sigma, d) -> torch.Tensor:
    """KL between isotropic Gaussians on a d-dimensional subspace; the sigmas
    and ``d`` are per molecule [B]. reference: en_diffusion.py:103-120."""
    mu_norm2 = sum_except_batch((q_mu - p_mu) ** 2)
    if q_sigma.dim() != 1 or p_sigma.dim() != 1:
        raise ValueError("gaussian_kl_for_dimension takes per-molecule sigmas [B]")
    return (d * torch.log(p_sigma / (q_sigma + 1e-8) + 1e-8)
            + 0.5 * (d * q_sigma * q_sigma + mu_norm2) / (p_sigma * p_sigma) - 0.5 * d)


def cdf_standard_gaussian(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF. reference: en_diffusion.py:250-251."""
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))
